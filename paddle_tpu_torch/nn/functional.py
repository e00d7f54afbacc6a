"""Functional ops (counterpart of ``paddle_tpu/nn/functional.py`` and of
the op kernels behind it in ``paddle_tpu/fluid/ops/nn_ops.py``), as far
as the BERT pretrain step and the vision models (ResNet, VGG, MobileNet,
LeNet) reach.

Each function is the reference's op on ``torch.Tensor``s: it consults the
autocast lists under the op's own type (``amp.autocast_inputs``), keeps
the op's argument handling (``p = 0`` outside training, missing LN scale
or bias defaulting to ones or zeros, an unknown activation raising
``ValueError``), and routes to a kernel wrapper of ``ops/`` where the
reference routes to a Pallas kernel. The wrappers launch CUDA kernels on
CUDA tensors and take their plain versions on CPU tensors.

Convolution, pooling and batch norm have no Pallas kernel in the
reference (``lax.conv_general_dilated``, ``lax.reduce_window``, jnp with
a hand-written VJP), so the port runs PyTorch's own convolution and
pooling and the reference's batch-norm arithmetic in tensor code. Their
op bodies (``conv2d_op``, ``pool2d_op``, ``batch_norm_op``) are shared
with the static graph's ``conv2d``, ``pool2d`` and ``batch_norm`` ops.
With ``data_format="NHWC"`` a tensor is viewed as NCHW by a permute,
which leaves it channels-last in memory: PyTorch's convolution and
pooling then take their channels-last kernels and give channels-last
results, so the trunk stays NHWC in memory with no copy.

Dropout. The reference derives each stochastic op's seed from the
tracer's step key and a per-op counter; ``jax.random`` cannot be
replayed here, so the port keeps the structure with its own numbers:
``seed_scope(step_seed)`` opens a counter-based stream, and each
stochastic op that is given no ``seed`` takes ``next_seed()``, an int32
hashed from (step seed, op index). The int32 goes to the kernel (or its
plain version), which builds the mask with the reference's counter hash;
the same step seed therefore gives the same masks on the CPU, on the
card, through the kernels and through the composed chains. Under data
parallelism each rank opens its stream with its rank folded in
(``seed_scope(step_seed, rank)``), so no two ranks draw one mask, as the
reference draws distinct masks for every row of the global batch; rank
0's stream is the single-device one. ``seed_state()`` and
``seed_scope(*state)`` replay a stream from where it stood
(``distributed.recompute``).

``composed_ops()`` is the port's counterpart of the reference's
``PADDLE_TPU_DISABLE_PALLAS``: inside the block every op takes its
composed chain (the plain version of its kernel, differentiated by
autograd) instead of its kernel wrapper, on any device. It is how a run
on the card holds the kernel path against the plain versions.
"""
from __future__ import annotations

import contextlib
import math

import torch

from ..amp.auto_cast import autocast_inputs
from ..ops import flash_attention as _fa
from ..ops import fused_block as _fb
from ..ops import fused_residual as _fr
from ..ops import layer_norm as _ln

__all__ = ["linear", "conv2d", "conv2d_op", "max_pool2d", "avg_pool2d",
           "adaptive_avg_pool2d", "adaptive_max_pool2d", "pool2d_op",
           "batch_norm", "batch_norm_op", "relu6", "flatten",
           "embedding", "layer_norm", "layer_norm_op",
           "fused_dropout_add_ln", "fused_out_ln", "fused_ffn_block",
           "scaled_dot_product_attention", "dropout", "gelu", "relu", "tanh",
           "softmax_with_cross_entropy", "cross_entropy", "seed_scope",
           "next_seed", "op_seed", "seed_state", "composed_ops"]

_composed = False


@contextlib.contextmanager
def composed_ops(enable: bool = True):
    """Inside the block the ops below take their composed chains, not
    their kernel wrappers."""
    global _composed
    prev, _composed = _composed, bool(enable)
    try:
        yield
    finally:
        _composed = prev


# ---------------------------------------------------------------------------
# per-op dropout seeds
# ---------------------------------------------------------------------------

def op_seed(step_seed: int, index: int, rank: int = 0) -> int:
    """The int32 seed of stochastic op number `index` of a step on data-
    parallel rank `rank`: murmur3's finaliser over the three, so
    neighbouring steps, ops and ranks share no mask (rank 0 adds
    nothing)."""
    x = (int(step_seed) * 0x9E3779B9 + int(index) * 0x85EBCA6B
         + int(rank) * 0xC2B2AE35 + 0x165667B1) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    x ^= x >> 16
    return x - (1 << 32) if x >= (1 << 31) else x


class _SeedStream:
    def __init__(self, step_seed: int, rank: int = 0, index: int = 0):
        self.step_seed, self.rank, self.index = \
            int(step_seed), int(rank), int(index)

    def next(self) -> int:
        self.index += 1
        return op_seed(self.step_seed, self.index, self.rank)


_stream = _SeedStream(0)


@contextlib.contextmanager
def seed_scope(step_seed: int, rank: int = 0, drawn: int = 0):
    """Stochastic ops inside the block draw their seeds from a fresh
    stream keyed by `step_seed` and `rank`: op k of the block gets
    op_seed(step_seed, drawn + k, rank)."""
    global _stream
    prev, _stream = _stream, _SeedStream(step_seed, rank, drawn)
    try:
        yield _stream
    finally:
        _stream = prev


def seed_state() -> tuple[int, int, int]:
    """(step seed, rank, seeds drawn) of the current stream."""
    return _stream.step_seed, _stream.rank, _stream.index


def next_seed() -> int:
    """The next op's int32 seed from the current stream."""
    return _stream.next()


def _train_p(p, training):
    return float(p) if training else 0.0


def _seed_for(p, seed):
    """The seed an op with dropout probability p uses: the caller's, or
    the stream's next one; ops at p == 0 draw nothing."""
    if p <= 0.0:
        return 0
    return next_seed() if seed is None else int(seed)


# ---------------------------------------------------------------------------
# dense ops
# ---------------------------------------------------------------------------

def linear(x, weight, bias=None, name=None):
    """x @ weight (+ bias), weight (in, out): the reference's matmul_v2
    followed by elementwise_add."""
    x, weight = autocast_inputs("matmul_v2", x, weight)
    out = torch.matmul(x, weight)
    if bias is not None:
        out, bias = autocast_inputs("elementwise_add", out, bias)
        out = out + bias
    return out


def _pair(v):
    return [v, v] if isinstance(v, int) else list(v)


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------

def _same_pads(size, k, s, d):
    """XLA's SAME padding of one spatial axis: (low, high)."""
    o = -(-size // s)
    total = max((o - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def conv2d_op(x, weight, strides=(1, 1), paddings=(0, 0),
              dilations=(1, 1), groups=1, padding_algorithm="EXPLICIT",
              data_format="NCHW"):
    """The conv2d op's body: `weight` OIHW whatever the layout;
    `paddings` 2 (symmetric) or 4 (top, bottom, left, right) long, or
    the algorithm "SAME" / "VALID" (XLA's SAME split)."""
    strides, dilations = list(strides), list(dilations)
    nhwc = data_format == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    if padding_algorithm == "VALID":
        pad = [(0, 0), (0, 0)]
    elif padding_algorithm == "SAME":
        pad = [_same_pads(x.shape[2 + i], weight.shape[2 + i], strides[i],
                          dilations[i]) for i in (0, 1)]
    elif len(paddings) == 2:
        pad = [(paddings[0], paddings[0]), (paddings[1], paddings[1])]
    elif len(paddings) == 4:
        pad = [(paddings[0], paddings[1]), (paddings[2], paddings[3])]
    else:
        raise ValueError(f"bad paddings {paddings}")
    (ph0, ph1), (pw0, pw1) = pad
    sym = ph0 == ph1 and pw0 == pw1
    if not sym:
        x = torch.nn.functional.pad(x, (pw0, pw1, ph0, ph1))
    r = torch.nn.functional.conv2d(x, weight, None, strides,
                                   (ph0, pw0) if sym else 0, dilations,
                                   groups or 1)
    return r.permute(0, 2, 3, 1) if nhwc else r


def _channel_bias(out, bias, data_format):
    """The reference's elementwise_add of a bias on the channel axis
    that `data_format` names."""
    out, bias = autocast_inputs("elementwise_add", out, bias)
    if data_format == "NHWC":
        return out + bias
    return out + bias.reshape((1, -1) + (1,) * (out.dim() - 2))


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    algo, p = "EXPLICIT", padding
    if isinstance(padding, str):
        algo, p = padding.upper(), [0, 0]
    x, weight = autocast_inputs("conv2d", x, weight)
    out = conv2d_op(x, weight, _pair(stride), _pair(p), _pair(dilation),
                    groups, algo, data_format)
    return out if bias is None else _channel_bias(out, bias, data_format)


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

def pool2d_op(x, pooling_type="max", ksize=(2, 2), strides=(2, 2),
              paddings=(0, 0), global_pooling=False, exclusive=True,
              adaptive=False, data_format="NCHW"):
    """The pool2d op's body. As in the reference: global pooling where
    asked or where an adaptive pool's output is 1 x 1; adaptive bins
    [floor(i n / o), ceil((i + 1) n / o)) (torch's); average pooling
    divides by the window's elements inside the input when `exclusive`
    and padded, else by the window's size; ceil_mode is not read here
    (the reference's infer_shape reads it, its kernel does not)."""
    F = torch.nn.functional
    nhwc = data_format == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    if global_pooling or (adaptive and list(ksize) == [1, 1]):
        r = x.amax((2, 3), keepdim=True) if pooling_type == "max" \
            else x.mean((2, 3), keepdim=True)
    elif adaptive:
        fn = F.adaptive_max_pool2d if pooling_type == "max" \
            else F.adaptive_avg_pool2d
        r = fn(x, list(ksize))
    else:
        k, s, p = list(ksize), list(strides), list(paddings)
        if pooling_type == "max":
            r = F.max_pool2d(x, k, s, p)
        else:
            r = F.avg_pool2d(x, k, s, p, count_include_pad=not (
                exclusive and (p[0] or p[1])))
    return r.permute(0, 2, 3, 1) if nhwc else r


def _pool2d(x, pooling_type, kernel_size, stride, padding, exclusive=True,
            adaptive=False, data_format="NCHW"):
    k = _pair(kernel_size)
    s = k if stride is None else _pair(stride)
    (x,) = autocast_inputs("pool2d", x)
    return pool2d_op(x, pooling_type, k, s, _pair(padding), False,
                     exclusive, adaptive, data_format)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    return _pool2d(x, "max", kernel_size, stride, padding,
                   data_format=data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool2d(x, "avg", kernel_size, stride, padding, exclusive,
                   data_format=data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _pool2d(x, "avg", output_size, None, 0, adaptive=True,
                   data_format=data_format)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _pool2d(x, "max", output_size, None, 0, adaptive=True)


# ---------------------------------------------------------------------------
# batch norm
# ---------------------------------------------------------------------------

def _bn_shapes(x, caxis):
    axes = tuple(i for i in range(x.dim()) if i != caxis)
    bshape = [1] * x.dim()
    bshape[caxis] = x.shape[caxis]
    return axes, math.prod(x.shape[i] for i in axes), bshape


def _batch_group():
    """The data-parallel group batch statistics reduce over (None
    outside a data-parallel step or program, or over one rank)."""
    from ..distributed.collective import batch_group
    return batch_group()


def _sum_over(group, *sums):
    """The per-channel sums added over the ranks of `group` (one
    all-reduce), and the number of ranks; as given when group is None."""
    if group is None:
        return sums, 1
    import torch.distributed as dist
    both = torch.stack(sums)
    dist.all_reduce(both, group=group)
    return tuple(both.unbind(0)), dist.get_world_size(group)


def _bn_train_impl(x, scale, bias, shift, eps, caxis, group=None):
    """The reference's training statistics and output
    (``_bn_train_impl``): single-pass sums shifted by `shift` (the
    running mean), the biased variance max(ss / n - d^2, 0), and
    y = x * se + be computed in float32 and cast to x's type. Under a
    data-parallel `group` the two sums and n are the global batch's
    (every rank's slice, the same shift on each), so every rank gets
    the statistics the reference computes over the whole batch."""
    axes, n, bshape = _bn_shapes(x, caxis)
    sh = shift.float()
    vc = x.float() - sh.reshape(bshape)
    (s, ss), ranks = _sum_over(group, vc.sum(axes),
                               torch.square(vc).sum(axes))
    n = n * ranks
    d = s / n
    mean = d + sh
    var = torch.clamp(ss / n - torch.square(d), min=0.0)
    inv = torch.rsqrt(var + eps)
    se = inv * scale.float()
    be = bias.float() - mean * se
    y = (x.float() * se.reshape(bshape) + be.reshape(bshape)).to(x.dtype)
    return y, mean, var, inv


class _BatchNormTrain(torch.autograd.Function):
    """Training batch norm with the reference's hand-derived backward
    (``_bn_train_bwd``): activation-sized passes in float32, dx cast to
    x's type, dscale and dbias to the scale's; the statistics carry no
    gradient, nor does the shift. Under a data-parallel `group`, dx
    takes Σdy and Σdy·x̂ over the global batch (each rank's dy is the
    gradient of its own loss term), while dscale and dbias stay this
    rank's sums: the step's gradient all-reduce adds them up."""

    @staticmethod
    def forward(ctx, x, scale, bias, shift, eps, caxis, group=None):
        y, mean, var, inv = _bn_train_impl(x, scale, bias, shift, eps,
                                           caxis, group)
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.caxis, ctx.group = caxis, group
        ctx.mark_non_differentiable(mean, var, inv)
        return y, mean, var, inv

    @staticmethod
    def backward(ctx, dy, *_stat_grads):
        x, scale, mean, inv = ctx.saved_tensors
        axes, n, bshape = _bn_shapes(x, ctx.caxis)
        dyf = dy.float()
        xhat = (x.float() - mean.reshape(bshape)) * inv.reshape(bshape)
        dbias = dyf.sum(axes)
        dscale = (dyf * xhat).sum(axes)
        (gbias, gscale), ranks = _sum_over(ctx.group, dbias, dscale)
        n = n * ranks
        k = (inv * scale.float()).reshape(bshape)
        dx = (k * (dyf - (gbias / n).reshape(bshape)
                   - xhat * (gscale / n).reshape(bshape))).to(x.dtype)
        return (dx, dscale.to(scale.dtype), dbias.to(scale.dtype), None,
                None, None, None)


def batch_norm_op(x, scale, bias, mean, variance, momentum=0.9,
                  epsilon=1e-5, is_test=False, data_layout="NCHW"):
    """The batch_norm op's body: (Y, MeanOut, VarianceOut, SavedMean,
    SavedVariance). Training: batch statistics (``_bn_train_impl``),
    MeanOut = m * Mean + (1 - m) * batch mean (m = 0.9 keeps 90% of the
    old value: torch's momentum 0.1 written the other way round) and
    VarianceOut likewise from the BIASED batch variance; SavedVariance is
    1 / sqrt(var + eps). Nothing is written in place. Test: the running
    statistics, in x's type. In a data-parallel step or program the
    training statistics are the global batch's (``_BatchNormTrain``)."""
    caxis = 1 if data_layout == "NCHW" else x.dim() - 1
    _, _, bshape = _bn_shapes(x, caxis)
    if is_test:
        inv = torch.rsqrt(variance.float() + epsilon)
        y = (x - mean.reshape(bshape).to(x.dtype)) \
            * (inv.reshape(bshape) * scale.reshape(bshape)).to(x.dtype) \
            + bias.reshape(bshape).to(x.dtype)
        return y, mean, variance, mean, inv
    y, bm, bv, inv = _BatchNormTrain.apply(x, scale, bias, mean.detach(),
                                           epsilon, caxis, _batch_group())
    with torch.no_grad():
        mean_out = momentum * mean + (1 - momentum) * bm
        var_out = momentum * variance + (1 - momentum) * bv
    return y, mean_out, var_out, bm, inv


def batch_norm(x, running_mean, running_var, weight, bias, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW", name=None):
    """Batch norm over the channel axis of `data_format`; in training
    the new running statistics are copied INTO `running_mean` and
    `running_var` (float32), so a caller that handed in its own buffers
    (``TrainStep`` through ``functional_call``) sees them move."""
    x, weight, bias, running_mean, running_var = autocast_inputs(
        "batch_norm", x, weight, bias, running_mean, running_var,
        slots=("X", "Scale", "Bias", "Mean", "Variance"))
    y, mean_out, var_out, _, _ = batch_norm_op(
        x, weight, bias, running_mean, running_var, momentum, epsilon,
        not training, data_format)
    if training:
        with torch.no_grad():
            running_mean.copy_(mean_out)
            running_var.copy_(var_out)
    return y


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    out = weight[x.long()]
    if padding_idx is not None and padding_idx != -1:
        out = torch.where((x == padding_idx)[..., None],
                          torch.zeros_like(out), out)
    return out


def gelu(x, approximate=False, name=None):
    (x,) = autocast_inputs("gelu", x)
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def relu(x, name=None):
    (x,) = autocast_inputs("relu", x)
    return torch.relu(x)


def relu6(x, name=None):
    (x,) = autocast_inputs("relu6", x)
    return torch.clamp(x, 0.0, 6.0)


def tanh(x, name=None):
    (x,) = autocast_inputs("tanh", x)
    return torch.tanh(x)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """The reference's flatten_contiguous_range: axes start..stop merged
    into one."""
    (x,) = autocast_inputs("flatten_contiguous_range", x)
    return torch.flatten(x, start_axis, stop_axis)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None, seed=None):
    """The reference's dropout op. The mask is the counter hash of
    ``ops.fused_residual.keep_mask`` over x viewed as (rows, last dim),
    from `seed`, or from an int32 drawn from the explicit CPU
    `generator`, or from the current seed stream."""
    (x,) = autocast_inputs("dropout", x)
    if axis is not None:
        raise NotImplementedError(
            "dropout along an axis comes with slice 4 of the port (the op "
            "library)")
    if not training:
        return x * (1.0 - p) if mode == "downgrade_in_infer" else x
    if p >= 1.0:
        return torch.zeros_like(x)
    if p <= 0.0:
        return x
    if seed is None and generator is not None:
        seed = int(torch.randint(-2 ** 31, 2 ** 31, (1,),
                                 generator=generator))
    seed = _seed_for(p, seed)
    cols = x.shape[-1] if x.dim() else 1
    keep = _fr.keep_mask(seed, x.numel() // max(cols, 1), cols, p,
                         x.device).reshape(x.shape)
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# layer norm
# ---------------------------------------------------------------------------

def layer_norm_op(x, scale=None, bias=None, epsilon=1e-5, begin_norm_axis=1):
    """The reference's layer_norm op: (Y, Mean, Variance), the
    statistics (rows,) float32 and without gradient. With scale and bias
    present (and at most 16384 columns) it is the fused kernel pair of
    ``ops/layer_norm.py``; otherwise the composed chain."""
    x, scale, bias = autocast_inputs("layer_norm", x, scale, bias)
    ax = begin_norm_axis
    rows = math.prod(x.shape[:ax]) if x.dim() > ax else 1
    cols = math.prod(x.shape[ax:])
    if scale is not None and bias is not None and rows >= 1 \
            and 1 <= cols <= _ln.MAX_COLS and not _composed:
        y2, mean, rstd = _ln.fused_layer_norm(
            x.reshape(rows, cols), scale.reshape(cols), bias.reshape(cols),
            epsilon)
        var = 1.0 / torch.square(rstd) - epsilon
        return y2.reshape(x.shape), mean, var
    fp = x.float().reshape(rows, cols)
    mean = fp.mean(-1, keepdim=True)
    var = torch.square(fp - mean).mean(-1, keepdim=True)
    y = (fp - mean) * torch.rsqrt(var + epsilon)
    if scale is not None:
        y = y * scale.reshape(cols).float()
    if bias is not None:
        y = y + bias.reshape(cols).float()
    return (y.to(x.dtype).reshape(x.shape), mean.detach().reshape(rows),
            var.detach().reshape(rows))


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    ns = [normalized_shape] if isinstance(normalized_shape, int) \
        else list(normalized_shape)
    return layer_norm_op(x, weight, bias, epsilon, x.dim() - len(ns))[0]


# ---------------------------------------------------------------------------
# the block ops
# ---------------------------------------------------------------------------

def _ln_vectors(scale, bias, n, device):
    if scale is None:
        scale = torch.ones((n,), dtype=torch.float32, device=device)
    if bias is None:
        bias = torch.zeros((n,), dtype=torch.float32, device=device)
    return scale.float(), bias.float()


def _one_type(*tensors):
    """The tensors in their common (promoted) type: a kernel takes one
    input type per launch, and the reference's bodies promote mixed
    operands inside their products in the same way."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt).contiguous() for t in tensors)


def fused_dropout_add_ln(x, residual, scale, bias, dropout_p=0.0,
                         epsilon=1e-5, training=True, seed=None):
    """LN(residual + dropout(x)) * scale + bias over the last axis, one
    kernel each way (``ops/fused_residual.py``)."""
    x, residual, scale, bias = autocast_inputs(
        "fused_dropout_add_ln", x, residual, scale, bias)
    p = _train_p(dropout_p, training)
    c = x.shape[-1]
    x2, r2 = _one_type(x.reshape(-1, c), residual.reshape(-1, c))
    fn = _fr.fused_dropout_add_ln if not _composed else \
        (lambda *a: _fr.dropout_add_ln_reference(*a)[0])
    y = fn(x2, r2, scale, bias, _seed_for(p, seed), p, float(epsilon))
    return y.to(residual.dtype).reshape(residual.shape)


def fused_out_ln(x, w, b, residual, scale=None, bias=None, dropout_p=0.0,
                 epsilon=1e-5, training=True, seed=None):
    """LN(residual + dropout(x @ w + b)) * scale + bias: the
    attention-out projection with the whole post-LN sub-layer epilogue in
    one kernel (``ops/fused_block.fused_out_ln``)."""
    x, w, b, residual, scale, bias = autocast_inputs(
        "fused_out_ln", x, w, b, residual, scale, bias)
    p = _train_p(dropout_p, training)
    din, dout = x.shape[-1], w.shape[1]
    scale, bias = _ln_vectors(scale, bias, dout, x.device)
    x2, w_, b_, r2 = _one_type(x.reshape(-1, din), w, b,
                               residual.reshape(-1, dout))
    fn = _fb.out_ln_reference if _composed else _fb.fused_out_ln
    _z, h = fn(x2, w_, b_, r2, scale, bias, p, float(epsilon),
               _seed_for(p, seed))
    # the reference's h comes out in x's type and is cast to the
    # residual's
    return h.to(x.dtype).to(residual.dtype).reshape(residual.shape)


def fused_ffn_block(x, w1, b1, w2, b2, residual, scale=None, bias=None,
                    activation="gelu", norm="post", dropout_p=0.0,
                    epsilon=1e-5, training=True, seed=None):
    """[LN](residual + dropout(act([LN] x @ w1 + b1) @ w2 + b2)): the FFN
    sub-block in one kernel (``ops/fused_block.fused_ffn_ln``); norm is
    "pre", "post" or "none"."""
    x, w1, b1, w2, b2, residual, scale, bias = autocast_inputs(
        "fused_ffn_block", x, w1, b1, w2, b2, residual, scale, bias)
    if activation not in ("gelu", "gelu_tanh", "relu"):
        raise ValueError(
            f"fused_ffn_block supports gelu/gelu_tanh/relu, got "
            f"{activation!r} (use the composed linear/activation ops "
            f"instead)")
    p = _train_p(dropout_p, training)
    h = x.shape[-1]
    scale, bias = _ln_vectors(scale, bias, h, x.device)
    x2, w1_, b1_, w2_, b2_, r2 = _one_type(
        x.reshape(-1, h), w1, b1, w2, b2, residual.reshape(-1, h))
    fn = _fb.ffn_ln_reference if _composed else _fb.fused_ffn_ln
    y = fn(x2, w1_, b1_, w2_, b2_, r2, scale, bias, activation, norm, p,
           float(epsilon), _seed_for(p, seed))
    return y.to(residual.dtype).reshape(residual.shape)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, seed=None):
    """The reference's fused_attention op on (B, H, S, D)."""
    query, key, value = autocast_inputs("fused_attention", query, key, value)
    p = _train_p(dropout_p, training)
    seed = _seed_for(p, seed)
    if _composed:
        return _fa.sdpa_reference(query, key, value, attn_mask, None,
                                  is_causal, p, seed)
    return _fa.scaled_dot_product_attention(
        query, key, value, attn_mask, p, is_causal, True, seed)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Per-row loss, keepdim over `axis` ((N, 1) for (N, V) logits);
    rows whose label is `ignore_index` give 0."""
    (logits,) = autocast_inputs("softmax_with_cross_entropy", logits)
    logp = torch.log_softmax(logits, dim=axis)
    if soft_label:
        loss = -(label * logp).sum(axis, keepdim=True)
    else:
        lab = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 \
            else label
        lab = lab.long()
        ignored = (lab == ignore_index).unsqueeze(axis)
        idx = torch.where(ignored, torch.zeros_like(lab.unsqueeze(axis)),
                          lab.unsqueeze(axis))
        loss = -torch.gather(logp, axis, idx)
        loss = torch.where(ignored, torch.zeros_like(loss), loss)
    if return_softmax:
        return loss, torch.exp(logp).detach()
    return loss


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    if weight is not None or not use_softmax:
        raise NotImplementedError(
            "cross_entropy with class weights or use_softmax=False comes "
            "with slice 4 of the port (the op library)")
    loss = softmax_with_cross_entropy(input, label, soft_label, ignore_index,
                                      axis=axis)
    if reduction == "mean":
        (loss,) = autocast_inputs("mean", loss)
        return loss.mean()
    if reduction == "sum":
        (loss,) = autocast_inputs("reduce_sum", loss)
        return loss.sum()
    return loss
