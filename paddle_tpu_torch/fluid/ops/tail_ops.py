"""The long tail of the op library (counterpart of
``paddle_tpu/fluid/ops/tail_ops.py``): elementwise stragglers, scans
and distances, linear algebra, indexing, NN extras (prelu, maxout,
pad3d, gather_tree, fold, spectral_norm, deformable_conv), the
interpolation family, the sequence tail, the box ops, the
batch-size-like fills, frame / overlap_add, the complex views and
renorm, on torch tensors. Gradients come from the auto grad op unless
an op has none.

The decompositions (qr, svd, eigh, lu) are LAPACK's on the CPU and
cuSOLVER's on the card, as the reference's are XLA's LAPACK calls: where
their output is not unique (the signs of Q, U, V and eigenvectors, a
pivot order among equal candidates) the two can differ and still be
right. ``lu`` returns the reference's 0-based pivots.

The interpolations use the reference's coordinate maps (nearest:
round half up with align_corners, floor otherwise; linear: the
align_corners, half-pixel and asymmetric maps; cubic: Keys' kernel at
a = -0.75), one axis at a time. generate_proposals returns exactly
post_nms_topN rows (suppressed rows 0) and the count, as the
reference's static-shape contract does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import torch_dtype
from ..registry import register, same_shape_as
from .common import out, x


# ---------------------------------------------------------------------------
# elementwise math
# ---------------------------------------------------------------------------

def _angle(v):
    if v.is_complex():
        return torch.angle(v)
    return torch.where(v < 0, torch.full_like(v, np.pi), torch.zeros_like(v))


for _name, _fn in [("expm1", torch.expm1), ("lgamma", torch.lgamma),
                   ("digamma", torch.digamma), ("rad2deg", torch.rad2deg),
                   ("deg2rad", torch.deg2rad), ("angle", _angle)]:
    register(_name, (lambda f: lambda ctx, ins, attrs: out(f(x(ins))))(_fn),
             infer_shape=same_shape_as("X"))

register("atan2",
         lambda ctx, ins, attrs: out(torch.atan2(x(ins, "X1"),
                                                 x(ins, "X2"))),
         infer_shape=same_shape_as("X1"))


@register("nan_to_num", attrs={"nan": 0.0, "posinf": None, "neginf": None})
def _nan_to_num(ctx, ins, attrs):
    return out(torch.nan_to_num(x(ins), nan=attrs.get("nan", 0.0),
                                posinf=attrs.get("posinf"),
                                neginf=attrs.get("neginf")))


@register("logsumexp", attrs={"axis": [], "keepdim": False,
                              "reduce_all": False})
def _logsumexp(ctx, ins, attrs):
    v = x(ins)
    ax = attrs.get("axis") or []
    dims = tuple(range(v.dim())) if attrs.get("reduce_all") or not ax \
        else tuple(int(a) for a in ax)
    return out(torch.logsumexp(v, dim=dims,
                               keepdim=attrs.get("keepdim", False)))


@register("logcumsumexp", attrs={"axis": -1, "flatten": False,
                                 "exclusive": False, "reverse": False})
def _logcumsumexp(ctx, ins, attrs):
    v = x(ins)
    if attrs.get("flatten"):
        v = v.reshape(-1)
    ax = int(attrs.get("axis", -1))
    if attrs.get("reverse"):
        return out(torch.flip(torch.logcumsumexp(torch.flip(v, [ax]), ax),
                              [ax]))
    return out(torch.logcumsumexp(v, ax))


def _cum_minmax(scan):
    def impl(ctx, ins, attrs):
        v = x(ins)
        ax = int(attrs.get("axis", -1))
        if attrs.get("flatten"):
            v, ax = v.reshape(-1), 0
        ax %= v.dim()
        val = scan(v, ax).values
        # the index: the last position up to here whose element equals
        # the running extreme at its own position
        shape = [-1 if i == ax else 1 for i in range(v.dim())]
        idx = torch.arange(v.shape[ax], device=v.device).reshape(shape) \
            .expand(v.shape)
        run = torch.cummax(torch.where(val == v, idx, torch.full_like(
            idx, -1)), ax).values
        return {"Out": [val], "Indices": [run.long()]}
    return impl


register("cummax", _cum_minmax(torch.cummax),
         attrs={"axis": -1, "flatten": False},
         no_grad_out_slots=("Indices",))
register("cummin", _cum_minmax(torch.cummin),
         attrs={"axis": -1, "flatten": False},
         no_grad_out_slots=("Indices",))


@register("dist", attrs={"p": 2.0})
def _dist(ctx, ins, attrs):
    d = (x(ins, "X") - x(ins, "Y")).reshape(-1)
    p = float(attrs.get("p", 2.0))
    if p == float("inf"):
        return out(torch.abs(d).max())
    if p == float("-inf"):
        return out(torch.abs(d).min())
    if p == 0:
        return out((d != 0).sum().to(d.dtype))
    return out((torch.abs(d) ** p).sum() ** (1.0 / p))


@register("cosine_similarity", attrs={"axis": 1, "eps": 1e-8})
def _cosine_similarity(ctx, ins, attrs):
    a, b = x(ins, "X"), x(ins, "Y")
    ax = attrs.get("axis", 1)
    den = torch.linalg.vector_norm(a, dim=ax) \
        * torch.linalg.vector_norm(b, dim=ax)
    return out((a * b).sum(ax) / torch.clamp(den, min=attrs.get("eps",
                                                                1e-8)))


@register("pairwise_distance", attrs={"p": 2.0, "epsilon": 1e-6,
                                      "keepdim": False})
def _pairwise_distance(ctx, ins, attrs):
    d = x(ins, "X") - x(ins, "Y") + attrs.get("epsilon", 1e-6)
    p = float(attrs.get("p", 2.0))
    r = (torch.abs(d) ** p).sum(-1) ** (1.0 / p)
    return out(r[..., None] if attrs.get("keepdim") else r)


# ---------------------------------------------------------------------------
# linear algebra
# ---------------------------------------------------------------------------

register("inverse", lambda ctx, ins, attrs: {
    "Output": [torch.linalg.inv(x(ins, "Input"))]},
    infer_shape=same_shape_as("Input", out_slot="Output"))

register("trace",
         lambda ctx, ins, attrs: out(torch.diagonal(
             x(ins), attrs.get("offset", 0), attrs.get("axis1", 0),
             attrs.get("axis2", 1)).sum(-1)),
         attrs={"offset": 0, "axis1": 0, "axis2": 1})


def _cross(ctx, ins, attrs):
    a, b = x(ins, "X"), x(ins, "Y")
    dim = attrs.get("dim", 9)
    if dim == 9:  # unset: the first axis of length 3
        dim = next(i for i, d in enumerate(a.shape) if d == 3)
    return out(torch.linalg.cross(a, b, dim=dim))


register("cross", _cross, attrs={"dim": 9}, infer_shape=same_shape_as("X"))


@register("multi_dot")
def _multi_dot(ctx, ins, attrs):
    return out(torch.linalg.multi_dot(list(ins["X"])))


@register("qr", grad=None, attrs={"mode": "reduced"})
def _qr(ctx, ins, attrs):
    q, r = torch.linalg.qr(x(ins), mode=attrs.get("mode", "reduced"))
    return {"Q": [q], "R": [r]}


@register("svd", grad=None, attrs={"full_matrices": False})
def _svd(ctx, ins, attrs):
    u, s, vh = torch.linalg.svd(
        x(ins), full_matrices=attrs.get("full_matrices", False))
    return {"U": [u], "S": [s], "VH": [vh]}


@register("eigh", grad=None, attrs={"UPLO": "L"})
def _eigh(ctx, ins, attrs):
    """Only the named triangle is read: it is mirrored into a symmetric
    matrix first."""
    v = x(ins)
    diag = torch.triu(torch.tril(v))
    tri = torch.triu(v) if attrs.get("UPLO", "L") == "U" else torch.tril(v)
    w, vec = torch.linalg.eigh(tri + tri.transpose(-1, -2) - diag)
    return {"Eigenvalues": [w], "Eigenvectors": [vec]}


@register("lu", grad=None, attrs={"pivots": True})
def _lu(ctx, ins, attrs):
    lu, piv = torch.linalg.lu_factor(x(ins))
    return {"Out": [lu], "Pivots": [(piv - 1).int()]}


@register("matrix_rank", grad=None,
          attrs={"tol": 0.0, "use_default_tol": True, "hermitian": False})
def _matrix_rank(ctx, ins, attrs):
    v = x(ins)
    if attrs.get("use_default_tol", True):
        r = torch.linalg.matrix_rank(v)
    else:
        r = torch.linalg.matrix_rank(v, atol=attrs.get("tol", 0.0), rtol=0.0)
    return out(r.long())


# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------

def _take_along_axis_infer(op):
    v, idx = op.invar("Input"), op.invar("Index")
    if None in (v, idx) or v.shape is None or idx.shape is None:
        return
    for n in op.output("Result"):
        op.block.create_var(name=n, shape=tuple(idx.shape), dtype=v.dtype)


register("take_along_axis",
         lambda ctx, ins, attrs: {"Result": [torch.take_along_dim(
             x(ins, "Input"), x(ins, "Index").long(),
             dim=attrs.get("Axis", 0))]},
         attrs={"Axis": 0}, no_grad_slots=("Index",),
         infer_shape=_take_along_axis_infer)


@register("put_along_axis", no_grad_slots=("Index",),
          attrs={"Axis": 0, "Reduce": "assign"},
          infer_shape=same_shape_as("Input", "Result"))
def _put_along_axis(ctx, ins, attrs):
    v, idx, val = x(ins, "Input"), x(ins, "Index").long(), x(ins, "Value")
    ax = attrs.get("Axis", 0)
    val = torch.broadcast_to(val.to(v.dtype), idx.shape)
    mode = attrs.get("Reduce", "assign")
    if mode == "add":
        return {"Result": [v.scatter_add(ax, idx, val)]}
    if mode in ("multiply", "mul"):
        return {"Result": [v.scatter_reduce(ax, idx, val, "prod")]}
    return {"Result": [v.scatter(ax, idx, val)]}


register("broadcast_to",
         lambda ctx, ins, attrs: out(torch.broadcast_to(
             x(ins), tuple(attrs["shape"]))),
         attrs={"shape": []})


def _searchsorted(values_slot):
    def impl(ctx, ins, attrs):
        r = torch.searchsorted(x(ins, "SortedSequence"), x(ins, values_slot),
                               right=bool(attrs.get("right", False)))
        return out(r.int() if attrs.get("out_int32") else r.long())
    return impl


register("searchsorted", _searchsorted("Values"), grad=None,
         attrs={"out_int32": False, "right": False})
register("bucketize", _searchsorted("InputTensor"), grad=None,
         attrs={"out_int32": False, "right": False})


@register("bincount", grad=None, attrs={"minlength": 0})
def _bincount(ctx, ins, attrs):
    """Counts (or summed Weights) of each value: minlength bins when
    given (larger values not counted), else max + 1."""
    v = x(ins).reshape(-1).long()
    w = x(ins, "Weights")
    n = int(attrs.get("minlength") or 0)
    if n <= 0:
        n = int(v.max()) + 1 if v.numel() else 1
    keep = v < n
    if w is None:
        return out(torch.zeros(n, dtype=torch.int64, device=v.device)
                   .index_add_(0, v[keep], torch.ones_like(v[keep])))
    return out(torch.zeros(n, dtype=w.dtype, device=v.device)
               .index_add_(0, v[keep], w.reshape(-1)[keep]))


@register("unique_consecutive", grad=None,
          attrs={"dtype": "int64", "return_inverse": False,
                 "return_counts": False, "axis": []})
def _unique_consecutive(ctx, ins, attrs):
    """Static shapes, as the reference's: the output keeps x's length,
    the run heads compacted to the front and the tail 0; Index and
    Counts follow that layout."""
    v = x(ins).reshape(-1)
    keep = torch.cat([torch.ones(1, dtype=torch.bool, device=v.device),
                      v[1:] != v[:-1]])
    pos = torch.cumsum(keep.long(), 0) - 1
    res = torch.zeros_like(v)
    res[pos[keep]] = v[keep]
    counts = torch.zeros(v.numel(), dtype=torch.int64, device=v.device) \
        .index_add_(0, pos, torch.ones_like(pos))
    return {"Out": [res], "Index": [pos], "Counts": [counts]}


# ---------------------------------------------------------------------------
# NN tail
# ---------------------------------------------------------------------------

@register("prelu", attrs={"mode": "all", "data_format": "NCHW"})
def _prelu(ctx, ins, attrs):
    v, alpha = x(ins), x(ins, "Alpha")
    mode = attrs.get("mode", "all")
    if mode == "channel":
        shape = [1] * v.dim()
        shape[1 if attrs.get("data_format", "NCHW") == "NCHW"
              else v.dim() - 1] = -1
        alpha = alpha.reshape(shape)
    elif mode == "element":
        alpha = alpha.reshape((1,) + tuple(v.shape[1:]))
    else:
        alpha = alpha.reshape(())
    return out(torch.where(v > 0, v, alpha * v))


@register("maxout", attrs={"groups": 1, "axis": 1})
def _maxout(ctx, ins, attrs):
    v = x(ins)
    g = int(attrs["groups"])
    ax = int(attrs.get("axis", 1)) % v.dim()
    shp = tuple(v.shape[:ax]) + (v.shape[ax] // g, g) + tuple(
        v.shape[ax + 1:])
    return out(v.reshape(shp).amax(ax + 1))


@register("pad3d", attrs={"paddings": [0] * 6, "mode": "constant",
                          "value": 0.0, "data_format": "NCDHW"})
def _pad3d(ctx, ins, attrs):
    """paddings [left, right, top, bottom, front, back] of W, H and D;
    constant, reflect, replicate or circular."""
    v = x(ins)
    ncdhw = attrs.get("data_format", "NCDHW") == "NCDHW"
    if not ncdhw:
        v = v.permute(0, 4, 1, 2, 3)
    mode = attrs.get("mode", "constant")
    p = tuple(int(a) for a in attrs["paddings"])
    r = F.pad(v, p, value=attrs.get("value", 0.0)) if mode == "constant" \
        else F.pad(v, p, mode=mode)
    return out(r if ncdhw else r.permute(0, 2, 3, 4, 1))


@register("gather_tree", grad=None)
def _gather_tree(ctx, ins, attrs):
    """Beam-search backtrace: ids / parents [T, B, W] -> the full
    sequences re-threaded along the parent pointers."""
    ids, parents = x(ins, "Ids"), x(ins, "Parents")
    T, B, W = ids.shape
    beams = torch.arange(W, device=ids.device).expand(B, W)
    outs = []
    for t in range(T - 1, -1, -1):
        outs.append(torch.gather(ids[t], -1, beams))
        beams = torch.gather(parents[t], -1, beams).long()
    return out(torch.stack(outs[::-1]).to(ids.dtype))


@register("fold", attrs={"output_sizes": [0, 0], "kernel_sizes": [3, 3],
                         "strides": [1, 1], "paddings": [0, 0, 0, 0],
                         "dilations": [1, 1]})
def _fold(ctx, ins, attrs):
    """col2im: the unfold patches [N, C*kh*kw, L] added back into the
    image."""
    v = x(ins)
    oh, ow = attrs["output_sizes"]
    kh, kw = attrs["kernel_sizes"]
    sh, sw = attrs["strides"]
    p = attrs["paddings"]
    dh, dw = attrs["dilations"]
    n, ckk, L = v.shape
    c = ckk // (kh * kw)
    ph, pw = oh + p[0] + p[2], ow + p[1] + p[3]
    lh = (ph - (dh * (kh - 1) + 1)) // sh + 1
    lw = (pw - (dw * (kw - 1) + 1)) // sw + 1
    img = torch.zeros((n, c, ph, pw), dtype=v.dtype, device=v.device)
    cols = v.reshape(n, c, kh, kw, lh, lw)
    for i in range(kh):
        for j in range(kw):
            ys, xs = i * dh, j * dw
            img[:, :, ys:ys + lh * sh:sh, xs:xs + lw * sw:sw] += \
                cols[:, :, i, j]
    return {"Y": [img[:, :, p[0]:p[0] + oh, p[1]:p[1] + ow]]}


@register("affine_channel", attrs={"data_layout": "NCHW"})
def _affine_channel(ctx, ins, attrs):
    v, s, b = x(ins, "X"), x(ins, "Scale"), x(ins, "Bias")
    shape = [1] * v.dim()
    shape[1 if attrs.get("data_layout", "NCHW") == "NCHW"
          else v.dim() - 1] = -1
    return out(v * s.reshape(shape) + b.reshape(shape))


@register("space_to_depth", attrs={"blocksize": 1})
def _space_to_depth(ctx, ins, attrs):
    v = x(ins)
    bs = int(attrs["blocksize"])
    n, c, h, w = v.shape
    v = v.reshape(n, c, h // bs, bs, w // bs, bs).permute(0, 3, 5, 1, 2, 4)
    return out(v.reshape(n, c * bs * bs, h // bs, w // bs))


@register("spectral_norm", no_grad_slots=("U", "V"),
          attrs={"dim": 0, "power_iters": 1, "eps": 1e-12})
def _spectral_norm(ctx, ins, attrs):
    """W / sigma, sigma from `power_iters` power iterations on U, V (the
    gradient flows through the iterations, as the reference's)."""
    w, u, v = x(ins, "Weight"), x(ins, "U"), x(ins, "V")
    dim = int(attrs.get("dim", 0))
    eps = attrs.get("eps", 1e-12)
    mat = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
    for _ in range(max(int(attrs.get("power_iters", 1)), 0)):
        v = mat.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = mat @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    return out(w / (u @ mat @ v))


@register("deformable_conv", no_grad_slots=("Mask",),
          attrs={"strides": [1, 1], "paddings": [0, 0],
                 "dilations": [1, 1], "groups": 1,
                 "deformable_groups": 1, "im2col_step": 64})
def _deformable_conv(ctx, ins, attrs):
    """Deformable convolution v2: the input sampled bilinearly at the
    offset-shifted taps, modulated by Mask, contracted with Filter.
    One deformable group, as the reference."""
    if int(attrs.get("deformable_groups", 1) or 1) != 1:
        raise NotImplementedError(
            "deformable_conv: only deformable_groups=1 is implemented "
            "(the sampler reads one offset group)")
    v = x(ins, "Input")          # [N, C, H, W]
    offset = x(ins, "Offset")    # [N, 2*kh*kw, OH, OW]
    mask = x(ins, "Mask")        # [N, kh*kw, OH, OW] or None
    flt = x(ins, "Filter")       # [OC, C/g, kh, kw]
    sh, sw = attrs["strides"]
    ph, pw = attrs["paddings"]
    dh, dw = attrs["dilations"]
    g = attrs.get("groups", 1) or 1
    n, c, h, w = v.shape
    oc, cpg, kh, kw = flt.shape
    oh = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    ow = (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    dev = v.device
    base_y = (torch.arange(oh, device=dev) * sh - ph)[:, None, None]
    base_x = (torch.arange(ow, device=dev) * sw - pw)[None, :, None]
    ky = (torch.arange(kh, device=dev) * dh)[None, None, :, None]
    kx = (torch.arange(kw, device=dev) * dw)[None, None, None, :]
    off = offset.reshape(n, -1, 2, kh, kw, oh, ow)
    oy = off[:, 0, 0].permute(0, 3, 4, 1, 2)      # [N, OH, OW, kh, kw]
    ox = off[:, 0, 1].permute(0, 3, 4, 1, 2)
    ys = base_y[None, :, :, :, None] + ky[None] + oy
    xs = base_x[None, :, :, None, :] + kx[None] + ox
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = ys - y0, xs - x0
    bidx = torch.arange(n, device=dev).reshape(n, 1, 1, 1, 1)

    def at(yy, xx):
        yi = yy.long().clamp(0, h - 1)
        xi = xx.long().clamp(0, w - 1)
        val = v[bidx, :, yi, xi]                     # [N,OH,OW,kh,kw,C]
        ok = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        return torch.where(ok[..., None], val, torch.zeros_like(val))

    samp = (at(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
            + at(y0, x0 + 1) * ((1 - wy) * wx)[..., None]
            + at(y0 + 1, x0) * (wy * (1 - wx))[..., None]
            + at(y0 + 1, x0 + 1) * (wy * wx)[..., None])
    samp = samp.permute(0, 5, 1, 2, 3, 4)            # [N,C,OH,OW,kh,kw]
    if mask is not None:
        samp = samp * mask.reshape(n, 1, kh, kw, oh, ow).permute(
            0, 1, 4, 5, 2, 3)
    samp = samp.reshape(n, g, c // g, oh, ow, kh, kw)
    fg = flt.reshape(g, oc // g, cpg, kh, kw)
    r = torch.einsum("ngcyxhw,gochw->ngoyx", samp, fg)
    return {"Output": [r.reshape(n, oc, oh, ow)]}


# ---------------------------------------------------------------------------
# the interpolation family (v1 and v2)
# ---------------------------------------------------------------------------

def _take(v, axis, idx):
    return torch.index_select(v, axis, idx)


def _interp_axis_nearest(v, axis, out_n, align_corners):
    """With align_corners the source index is round-half-up of
    i (in-1)/(out-1); without, floor(i in/out)."""
    in_n = v.shape[axis]
    i = torch.arange(out_n, dtype=torch.float32, device=v.device)
    if align_corners:
        idx = torch.floor(i * ((in_n - 1) / max(out_n - 1, 1)) + 0.5)
    else:
        idx = torch.floor(i * (in_n / out_n))
    return _take(v, axis, idx.long().clamp(0, in_n - 1))


def _interp_axis_linear(v, axis, out_n, align_corners, align_mode):
    """1-D linear resample: align_corners (i (in-1)/(out-1)), half-pixel
    (align_mode 0) or asymmetric (align_mode 1, the op's default)."""
    in_n = v.shape[axis]
    i = torch.arange(out_n, dtype=torch.float32, device=v.device)
    if align_corners:
        c = i * ((in_n - 1) / max(out_n - 1, 1))
    elif align_mode == 0:
        c = torch.clamp((i + 0.5) * (in_n / out_n) - 0.5, 0.0, in_n - 1.0)
    else:
        c = torch.clamp(i * (in_n / out_n), 0.0, in_n - 1.0)
    lo = torch.floor(c).long()
    hi = torch.clamp(lo + 1, max=in_n - 1)
    shape = [1] * v.dim()
    shape[axis] = out_n
    w = (c - lo.float()).reshape(shape)
    return _take(v, axis, lo) * (1 - w) + _take(v, axis, hi) * w


def _interp_axis_cubic(v, axis, out_n, align_corners):
    """1-D Keys-cubic (a = -0.75) resample: 4 clamped taps a point."""
    in_n = v.shape[axis]
    i = torch.arange(out_n, dtype=torch.float32, device=v.device)
    if align_corners:
        c = i * ((in_n - 1) / max(out_n - 1, 1))
    else:
        c = (i + 0.5) * (in_n / out_n) - 0.5
    lo = torch.floor(c)
    t = c - lo
    a = -0.75

    def kern(d):
        ad = torch.abs(d)
        return torch.where(
            ad <= 1, (a + 2) * ad ** 3 - (a + 3) * ad ** 2 + 1,
            torch.where(ad < 2, a * ad ** 3 - 5 * a * ad ** 2 + 8 * a * ad
                        - 4 * a, torch.zeros_like(ad)))

    shape = [1] * v.dim()
    shape[axis] = out_n
    acc = 0
    for k in range(-1, 3):
        idx = torch.clamp(lo.long() + k, 0, in_n - 1)
        acc = acc + _take(v, axis, idx) * kern(t - k).reshape(shape)
    return acc


def _interp(method):
    def impl(ctx, ins, attrs):
        v = x(ins)
        size_t = x(ins, "OutSize")
        oh, ow, od = attrs.get("out_h", 0), attrs.get("out_w", 0), \
            attrs.get("out_d", 0)
        scale = attrs.get("scale") or attrs.get("scale_factor") or []
        if isinstance(scale, (int, float)):
            scale = [scale]
        is3d = v.dim() == 5
        if size_t is not None:
            tgt = tuple(int(s) for s in size_t.reshape(-1).tolist())
        elif (od or 0) > 0 or (oh or 0) > 0 or (ow or 0) > 0:
            tgt = (od, oh, ow) if is3d else (oh, ow)
        else:
            sp = v.shape[2:]
            if len(scale) == 1:
                scale = list(scale) * len(sp)
            tgt = tuple(int(round(s * f)) for s, f in zip(sp, scale))
        axes = list(range(2, v.dim()))
        if len(tgt) != len(axes):
            raise ValueError(
                f"{method}_interp: target size {tgt} has {len(tgt)} dims "
                f"for input with {len(axes)} spatial dims")
        ac = bool(attrs.get("align_corners", True))
        am = int(attrs.get("align_mode", 1))
        if method == "nearest":
            r = v
            for ax, n in zip(axes, tgt):
                r = _interp_axis_nearest(r, ax, int(n), ac)
            return out(r)
        r = v.float()
        for ax, n in zip(axes, tgt):
            r = _interp_axis_linear(r, ax, int(n), ac, am) \
                if method in ("bilinear", "trilinear") \
                else _interp_axis_cubic(r, ax, int(n), ac)
        return out(r.to(v.dtype))
    return impl


for _m in ("nearest", "bilinear", "trilinear", "bicubic"):
    for _suffix in ("_interp", "_interp_v2"):
        register(_m + _suffix, _interp(_m), no_grad_slots=("OutSize", "Scale"),
                 attrs={"out_h": 0, "out_w": 0, "out_d": 0, "scale": [],
                        "align_corners": True, "align_mode": 1,
                        "data_layout": "NCHW"})


# ---------------------------------------------------------------------------
# the sequence tail (dense + lengths)
# ---------------------------------------------------------------------------

def _steps_mask(lengths, T):
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


@register("sequence_conv", no_grad_slots=("SeqLen",),
          attrs={"contextLength": 3, "contextStart": -1,
                 "contextStride": 1})
def _sequence_conv(ctx, ins, attrs):
    """A context-window convolution along T of [B, T, D]: the
    contextLength shifted copies concatenated (zero outside the
    sequence), then the filter; rows past SeqLen 0."""
    v, flt = x(ins, "X"), x(ins, "Filter")
    lens = x(ins, "SeqLen")
    L = int(attrs.get("contextLength", 3))
    start = int(attrs.get("contextStart", -L // 2))
    B, T, D = v.shape
    pos = torch.arange(T, device=v.device)
    cols = [torch.roll(v, -(start + i), 1)
            * ((pos + start + i >= 0) & (pos + start + i < T))[None, :, None]
            for i in range(L)]
    r = torch.cat(cols, -1) @ flt
    if lens is not None:
        r = r * _steps_mask(lens.reshape(-1), T)[..., None]
    return out(r)


@register("sequence_slice", grad=None, no_grad_slots=("Offset", "Length"))
def _sequence_slice(ctx, ins, attrs):
    """Each row's slice [Offset, Offset + Length), left aligned in a
    zero-padded buffer of the input's length."""
    v = x(ins, "X")
    off = x(ins, "Offset").reshape(-1).long()
    ln = x(ins, "Length").reshape(-1).long()
    T = v.shape[1]
    pos = torch.arange(T, device=v.device)[None, :]
    idx = torch.clamp(pos + off[:, None], 0, T - 1)
    tail = (1,) * (v.dim() - 2)
    g = torch.gather(v, 1, idx.reshape(idx.shape + tail).expand(v.shape))
    keep = (pos < ln[:, None]).reshape(idx.shape + tail)
    return out(torch.where(keep, g, torch.zeros_like(g)))


@register("sequence_erase", grad=None, attrs={"tokens": []})
def _sequence_erase(ctx, ins, attrs):
    """The listed tokens removed, the rest compacted left, zero padded;
    with the new lengths."""
    v = x(ins).long()
    toks = torch.tensor(list(attrs.get("tokens", [])), dtype=torch.int64,
                        device=v.device)
    B, T = v.shape
    keep = ~torch.isin(v, toks)
    pos = torch.clamp(torch.cumsum(keep.long(), 1) - 1, 0, T - 1)
    rows = torch.arange(B, device=v.device)[:, None].expand(B, T)
    res = torch.zeros_like(v).index_put_(
        (rows, pos), torch.where(keep, v, torch.zeros_like(v)),
        accumulate=True)
    return {"Out": [res], "Length": [keep.sum(1).long()]}


@register("sequence_enumerate", grad=None,
          attrs={"win_size": 2, "pad_value": 0})
def _sequence_enumerate(ctx, ins, attrs):
    v = x(ins)
    W = int(attrs.get("win_size", 2))
    B, T = v.shape
    pos = torch.arange(T, device=v.device)[None, :]
    pad = torch.full_like(v, attrs.get("pad_value", 0))
    return out(torch.stack([torch.where(pos + i < T, torch.roll(v, -i, 1),
                                        pad) for i in range(W)], -1))


@register("sequence_scatter", no_grad_slots=("Ids",))
def _sequence_scatter(ctx, ins, attrs):
    v, ids, upd = x(ins, "X"), x(ins, "Ids").long(), x(ins, "Updates")
    rows = torch.arange(v.shape[0], device=v.device)[:, None].expand(
        ids.shape)
    return out(v.index_put((rows, ids), upd, accumulate=True))


# ---------------------------------------------------------------------------
# the detection tail
# ---------------------------------------------------------------------------

@register("box_clip", grad=None)
def _box_clip(ctx, ins, attrs):
    boxes, im = x(ins, "Input"), x(ins, "ImInfo")
    h, w = im[..., 0:1] - 1, im[..., 1:2] - 1
    while h.dim() < boxes.dim():
        h, w = h[:, None], w[:, None]
    xs, ys = boxes[..., 0::2], boxes[..., 1::2]
    x1 = torch.clamp(xs, min=0) - torch.clamp(xs - w, min=0)
    y1 = torch.clamp(ys, min=0) - torch.clamp(ys - h, min=0)
    return {"Output": [torch.stack([x1[..., 0], y1[..., 0], x1[..., 1],
                                    y1[..., 1]], -1)]}


@register("polygon_box_transform", grad=None)
def _polygon_box_transform(ctx, ins, attrs):
    v = x(ins, "Input")  # [N, 8, H, W] offsets (EAST-style)
    n, c, h, w = v.shape
    gy = torch.arange(h, device=v.device).reshape(1, 1, h, 1)
    gx = torch.arange(w, device=v.device).reshape(1, 1, 1, w)
    r = torch.stack([4 * gx - v[:, 0::2], 4 * gy - v[:, 1::2]], 2)
    return {"Output": [r.reshape(n, c, h, w)]}


def _roi_masks(v, y1, x1, rh, rw, ph, pw):
    """The [ph, h] and [pw, w] masks of the pixels of each output bin."""
    h, w = v.shape[2], v.shape[3]
    dev = v.device
    ys = y1 + torch.arange(ph + 1, device=dev) * rh / ph
    xs = x1 + torch.arange(pw + 1, device=dev) * rw / pw
    gy = torch.arange(h, device=dev)[None, :]
    gx = torch.arange(w, device=dev)[None, :]
    my = (gy >= torch.floor(ys[:-1, None])) & (gy < torch.ceil(ys[1:, None]))
    mx = (gx >= torch.floor(xs[:-1, None])) & (gx < torch.ceil(xs[1:, None]))
    return my, mx


@register("roi_pool", grad=None, no_grad_slots=("ROIs", "RoisNum"),
          attrs={"pooled_height": 1, "pooled_width": 1,
                 "spatial_scale": 1.0})
def _roi_pool(ctx, ins, attrs):
    """The max of each bin of each ROI (the batch's first image)."""
    v, rois = x(ins, "X"), x(ins, "ROIs")
    ph, pw = int(attrs["pooled_height"]), int(attrs["pooled_width"])
    scale = attrs.get("spatial_scale", 1.0)
    img = v[0]
    big = torch.finfo(v.dtype).min
    res = []
    for roi in rois:
        x1, y1, x2, y2 = [torch.round(roi[i] * scale) for i in range(4)]
        my, mx = _roi_masks(v, y1, x1, torch.clamp(y2 - y1 + 1, min=1.0),
                            torch.clamp(x2 - x1 + 1, min=1.0), ph, pw)
        m = my[None, :, None, :, None] & mx[None, None, :, None, :]
        r = torch.where(m, img[:, None, None, :, :], torch.full_like(
            img[:, None, None, :, :], big))
        res.append(r.amax((3, 4)))
    return out(torch.stack(res))


@register("psroi_pool", grad=None, no_grad_slots=("ROIs", "RoisNum"),
          attrs={"output_channels": 1, "pooled_height": 1,
                 "pooled_width": 1, "spatial_scale": 1.0})
def _psroi_pool(ctx, ins, attrs):
    """Position-sensitive ROI average pooling: channel block (i, j)
    serves output bin (i, j)."""
    v, rois = x(ins, "X"), x(ins, "ROIs")
    oc = int(attrs["output_channels"])
    ph, pw = int(attrs["pooled_height"]), int(attrs["pooled_width"])
    scale = attrs.get("spatial_scale", 1.0)
    h, w = v.shape[2], v.shape[3]
    img = v[0].reshape(oc, ph, pw, h, w)
    res = []
    for roi in rois:
        x1, y1, x2, y2 = [roi[i] * scale for i in range(4)]
        my, mx = _roi_masks(v, y1, x1, torch.clamp(y2 - y1, min=0.1),
                            torch.clamp(x2 - x1, min=0.1), ph, pw)
        m = (my[:, None, :, None] & mx[None, :, None, :])
        cnt = torch.clamp(m.sum((2, 3)), min=1)
        res.append(torch.einsum("opqhw,pqhw->opq", img, m.to(v.dtype)) / cnt)
    return out(torch.stack(res))


def _proposals(sc, dl, im_i, anchors, var, pre_n, post_n, thresh, min_size,
               off):
    """One image's proposals: decode, clip, drop small boxes, top
    pre_n, then greedy NMS for post_n picks."""
    aw = anchors[:, 2] - anchors[:, 0] + off
    ah = anchors[:, 3] - anchors[:, 1] + off
    acx, acy = anchors[:, 0] + aw * 0.5, anchors[:, 1] + ah * 0.5
    cx = dl[:, 0] * var[:, 0] * aw + acx
    cy = dl[:, 1] * var[:, 1] * ah + acy
    bw = torch.exp(torch.clamp(dl[:, 2] * var[:, 2], -10, 10)) * aw
    bh = torch.exp(torch.clamp(dl[:, 3] * var[:, 3], -10, 10)) * ah
    boxes = torch.stack([
        torch.clamp(cx - bw * 0.5, min=0).clamp(max=im_i[1] - 1),
        torch.clamp(cy - bh * 0.5, min=0).clamp(max=im_i[0] - 1),
        torch.clamp(cx + bw * 0.5 - off, min=0).clamp(max=im_i[1] - 1),
        torch.clamp(cy + bh * 0.5 - off, min=0).clamp(max=im_i[0] - 1)], -1)
    ws = boxes[:, 2] - boxes[:, 0] + off
    hs = boxes[:, 3] - boxes[:, 1] + off
    valid = (ws >= min_size) & (hs >= min_size)
    ninf = torch.full_like(sc, -float("inf"))
    top_sc, top_ix = torch.topk(torch.where(valid, sc, ninf), pre_n)
    bx = boxes[top_ix]
    area = (bx[:, 2] - bx[:, 0] + off) * (bx[:, 3] - bx[:, 1] + off)
    alive = top_sc > -float("inf")
    picks, scores = [], []
    for _ in range(post_n):
        cand = torch.where(alive, top_sc, torch.full_like(top_sc,
                                                          -float("inf")))
        i = torch.argmax(cand)
        ok = cand[i] > -float("inf")
        bi = bx[i]
        inter = torch.clamp(torch.minimum(bx[:, 2], bi[2])
                            - torch.maximum(bx[:, 0], bi[0]) + off, min=0) \
            * torch.clamp(torch.minimum(bx[:, 3], bi[3])
                          - torch.maximum(bx[:, 1], bi[1]) + off, min=0)
        ai = (bi[2] - bi[0] + off) * (bi[3] - bi[1] + off)
        iou = inter / torch.clamp(area + ai - inter, min=1e-10)
        alive = alive & (iou <= thresh)
        picks.append(torch.where(ok, i, torch.full_like(i, -1)))
        scores.append(torch.where(ok, top_sc[i], torch.zeros_like(top_sc[i])))
    picks, scores = torch.stack(picks), torch.stack(scores)
    ok = picks >= 0
    rois = torch.where(ok[:, None], bx[torch.clamp(picks, min=0)],
                       torch.zeros(1, 4, dtype=bx.dtype, device=bx.device))
    return rois, torch.where(ok, scores, torch.zeros_like(scores)), \
        ok.sum().int()


def _generate_proposals(ctx, ins, attrs):
    """RPN proposals: exactly post_nms_topN rows an image (suppressed
    rows 0), their scores and the valid count."""
    scores = x(ins, "Scores")       # [N, A, H, W]
    deltas = x(ins, "BboxDeltas")   # [N, 4A, H, W]
    im = x(ins, "ImShape")
    if im is None:
        im = x(ins, "ImInfo")
    anchors = x(ins, "Anchors").reshape(-1, 4)
    var = x(ins, "Variances")
    n = scores.shape[0]
    sc = scores.reshape(n, -1)
    dl = deltas.reshape(n, -1, 4)
    pre_n = min(int(attrs.get("pre_nms_topN", 6000)), sc.shape[1])
    post_n = min(int(attrs.get("post_nms_topN", 1000)), pre_n)
    var = var.reshape(-1, 4) if var is not None else torch.ones(
        (1, 4), device=sc.device)
    off = 1.0 if attrs.get("pixel_offset", True) else 0.0
    res = [_proposals(sc[i], dl[i], im[i], anchors, var, pre_n, post_n,
                      attrs.get("nms_thresh", 0.5),
                      attrs.get("min_size", 0.1), off) for i in range(n)]
    return {"RpnRois": [torch.stack([r[0] for r in res])],
            "RpnRoiProbs": [torch.stack([r[1] for r in res])],
            "RpnRoisNum": [torch.stack([r[2] for r in res])]}


_PROPOSAL_ATTRS = {"pre_nms_topN": 6000, "post_nms_topN": 1000,
                   "nms_thresh": 0.5, "min_size": 0.1, "eta": 1.0,
                   "pixel_offset": True}
register("generate_proposals_v2", _generate_proposals, grad=None,
         no_grad_slots=("Scores", "BboxDeltas", "ImShape", "Anchors",
                        "Variances"), attrs=dict(_PROPOSAL_ATTRS))
register("generate_proposals", _generate_proposals, grad=None,
         no_grad_slots=("Scores", "BboxDeltas", "ImInfo", "Anchors",
                        "Variances"), attrs=dict(_PROPOSAL_ATTRS))


@register("density_prior_box", grad=None,
          attrs={"densities": [], "fixed_sizes": [], "fixed_ratios": [],
                 "variances": [0.1, 0.1, 0.2, 0.2], "clip": False,
                 "step_w": 0.0, "step_h": 0.0, "offset": 0.5})
def _density_prior_box(ctx, ins, attrs):
    feat, img = x(ins, "Input"), x(ins, "Image")
    fh, fw = feat.shape[2], feat.shape[3]
    ih, iw = img.shape[2], img.shape[3]
    sw = attrs.get("step_w") or iw / fw
    sh = attrs.get("step_h") or ih / fh
    offset = attrs.get("offset", 0.5)
    dev = feat.device
    boxes = []
    for dens, fs in zip(attrs["densities"], attrs["fixed_sizes"]):
        for ratio in (attrs["fixed_ratios"] or [1.0]):
            bw, bh = fs * np.sqrt(ratio), fs / np.sqrt(ratio)
            step = fs / dens
            for di in range(dens):
                for dj in range(dens):
                    cx = (torch.arange(fw, device=dev) + offset) * sw \
                        + ((dj + 0.5) * step - fs / 2.0)
                    cy = (torch.arange(fh, device=dev) + offset) * sh \
                        + ((di + 0.5) * step - fs / 2.0)
                    cxg, cyg = torch.meshgrid(cx, cy, indexing="xy")
                    boxes.append(torch.stack([
                        (cxg - bw / 2) / iw, (cyg - bh / 2) / ih,
                        (cxg + bw / 2) / iw, (cyg + bh / 2) / ih], -1))
    bx = torch.stack(boxes, 2)  # [fh, fw, nprior, 4]
    if attrs.get("clip"):
        bx = bx.clamp(0.0, 1.0)
    var = torch.tensor(attrs["variances"], dtype=torch.float32, device=dev) \
        .expand(bx.shape)
    return {"Boxes": [bx], "Variances": [var]}


# ---------------------------------------------------------------------------
# batch-size-like fills, frame / overlap_add, complex views, renorm
# ---------------------------------------------------------------------------

def _bsl_shape(ins, attrs):
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = \
        x(ins, "Input").shape[attrs.get("input_dim_idx", 0)]
    return tuple(shape)


@register("fill_constant_batch_size_like", grad=None,
          attrs={"shape": [], "value": 0.0, "dtype": "float32",
                 "input_dim_idx": 0, "output_dim_idx": 0})
def _fill_constant_bsl(ctx, ins, attrs):
    return out(torch.full(_bsl_shape(ins, attrs), attrs.get("value", 0.0),
                          dtype=torch_dtype(attrs.get("dtype", "float32")),
                          device=x(ins, "Input").device))


@register("gaussian_random_batch_size_like", grad=None, stochastic=True,
          attrs={"shape": [], "mean": 0.0, "std": 1.0,
                 "input_dim_idx": 0, "output_dim_idx": 0, "seed": 0,
                 "dtype": "float32"})
def _gaussian_random_bsl(ctx, ins, attrs):
    dev = x(ins, "Input").device
    r = torch.randn(_bsl_shape(ins, attrs), generator=ctx.generator(attrs),
                    device=dev)
    return out((attrs.get("mean", 0.0) + attrs.get("std", 1.0) * r).to(
        torch_dtype(attrs.get("dtype", "float32"))))


def _frame_index(fl, nf, hop, device):
    return torch.arange(fl, device=device)[:, None] \
        + hop * torch.arange(nf, device=device)[None, :]


@register("frame", attrs={"frame_length": 1, "hop_length": 1, "axis": -1})
def _frame(ctx, ins, attrs):
    """[..., n] -> [..., frame_length, n_frames]."""
    v = x(ins)
    fl, hop = int(attrs["frame_length"]), int(attrs["hop_length"])
    nf = (v.shape[-1] - fl) // hop + 1
    return out(v[..., _frame_index(fl, nf, hop, v.device)])


@register("overlap_add", attrs={"hop_length": 1, "axis": -1})
def _overlap_add(ctx, ins, attrs):
    """frame's inverse with the overlaps summed: [..., frame_length,
    n_frames] -> [..., (n_frames - 1) * hop + frame_length]."""
    v = x(ins)
    hop = int(attrs["hop_length"])
    fl, nf = v.shape[-2], v.shape[-1]
    res = torch.zeros(tuple(v.shape[:-2]) + ((nf - 1) * hop + fl,),
                      dtype=v.dtype, device=v.device)
    return out(res.index_add(-1, _frame_index(fl, nf, hop, v.device)
                             .reshape(-1),
                             v.reshape(tuple(v.shape[:-2]) + (fl * nf,))))


register("complex", lambda ctx, ins, attrs: out(torch.complex(
    x(ins, "X").float(), x(ins, "Y").float())), grad=None)
register("as_complex", lambda ctx, ins, attrs: out(torch.complex(
    x(ins)[..., 0], x(ins)[..., 1])), grad=None)
register("as_real", lambda ctx, ins, attrs: out(torch.stack(
    [x(ins).real, x(ins).imag], -1)), grad=None)


@register("renorm", attrs={"p": 2.0, "axis": 0, "max_norm": 1.0})
def _renorm(ctx, ins, attrs):
    """Each slice along `axis` whose p-norm exceeds max_norm scaled down
    to it."""
    v = x(ins)
    p = float(attrs.get("p", 2.0))
    ax = int(attrs.get("axis", 0)) % v.dim()
    mx = attrs.get("max_norm", 1.0)
    red = tuple(i for i in range(v.dim()) if i != ax)
    norms = (torch.abs(v) ** p).sum(red, keepdim=True) ** (1 / p)
    scale = torch.where(norms > mx, mx / torch.clamp(norms, min=1e-12),
                        torch.ones_like(norms))
    return out(v * scale)

