"""The op cases of the port's parity tests and of chip_smoke.py's card
op sweep, without JAX: the inputs and attrs of every case of
tests/test_op_sweep.py (copied below, under the same keys;
tests/test_torch_math_ops.py holds the copy equal to the sweep), and
the cases the port's parity suites add for ops the sweep lacks. A case
is (op, numpy inputs, attrs); its `ref` (the sweep's numpy reference)
is kept but unused by the parity suites, which compare the two
packages."""
import numpy as np


class OpCase:
    """tests/op_test.py's OpCase, without its JAX harness."""

    def __init__(self, op, inputs, attrs=None, ref=None, skip_grad=False,
                 static=False, grad_slots=None, atol=1e-5, grad_atol=5e-3,
                 grad_rtol=5e-3, eps=1e-3, reason=None):
        self.op = op
        self.inputs = inputs
        self.attrs = attrs or {}
        self.ref = ref
        self.skip_grad = skip_grad
        self.static = static
        self.grad_slots = grad_slots
        self.atol = atol
        self.grad_atol = grad_atol
        self.grad_rtol = grad_rtol
        self.eps = eps
        self.reason = reason


# -- tests/test_op_sweep.py's cases -------------------------------------------

R = np.random.RandomState


def _pos(shape, lo=0.3, hi=1.5, seed=0):
    return (R(seed).uniform(lo, hi, shape)).astype("float32")


def _sym(shape, seed=0, margin=0.25):
    """Random values bounded away from 0 (kink-free for abs/relu/...)."""
    r = R(seed)
    return ((r.uniform(margin, 1.0, shape))
            * np.where(r.rand(*shape) < 0.5, -1, 1)).astype("float32")


def _rnd(shape, seed=0, scale=1.0):
    return (R(seed).randn(*shape) * scale).astype("float32")


SWEEP: dict[str, OpCase] = {}


def case(op, **kw):
    SWEEP[op] = OpCase(op, **kw)


# ---------------------------------------------------------------------------
# unary elementwise (one generic spec per op; domain chosen kink/domain-safe)
# ---------------------------------------------------------------------------
X34 = _sym((3, 4))
UNARY = {
    "abs": (np.abs, X34),
    "exp": (np.exp, _rnd((3, 4))),
    "log": (np.log, _pos((3, 4))),
    "log2": (np.log2, _pos((3, 4))),
    "log10": (np.log10, _pos((3, 4))),
    "log1p": (np.log1p, _pos((3, 4))),
    "sqrt": (np.sqrt, _pos((3, 4))),
    "rsqrt": (lambda x: 1 / np.sqrt(x), _pos((3, 4))),
    "square": (np.square, _rnd((3, 4))),
    "reciprocal": (lambda x: 1 / x, _pos((3, 4))),
    "sin": (np.sin, _rnd((3, 4))),
    "cos": (np.cos, _rnd((3, 4))),
    "tan": (np.tan, _rnd((3, 4), scale=0.5)),
    "sinh": (np.sinh, _rnd((3, 4))),
    "cosh": (np.cosh, _rnd((3, 4))),
    "asin": (np.arcsin, _rnd((3, 4), scale=0.4)),
    "acos": (np.arccos, _rnd((3, 4), scale=0.4)),
    "atan": (np.arctan, _rnd((3, 4))),
    "tanh": (np.tanh, _rnd((3, 4))),
    "sigmoid": (lambda x: 1 / (1 + np.exp(-x)), _rnd((3, 4))),
    "logsigmoid": (lambda x: -np.log1p(np.exp(-x)), _rnd((3, 4))),
    "relu": (lambda x: np.maximum(x, 0), _sym((3, 4))),
    "relu6": (lambda x: np.clip(x, 0, 6), _sym((3, 4))),
    "erf": (None, _rnd((3, 4))),
    "gelu": (None, _rnd((3, 4))),
    "silu": (lambda x: x / (1 + np.exp(-x)), _rnd((3, 4))),
    "softplus": (None, _rnd((3, 4))),
    "softsign": (lambda x: x / (1 + np.abs(x)), _sym((3, 4))),
    "mish": (None, _rnd((3, 4))),
    "swish": (None, _rnd((3, 4))),
    "elu": (None, _sym((3, 4))),
    "selu": (None, _sym((3, 4))),
    "leaky_relu": (None, _sym((3, 4))),
    "hard_sigmoid": (None, _rnd((3, 4), scale=0.3)),
    "hard_swish": (None, _sym((3, 4))),
    "hard_tanh": (None, _rnd((3, 4), scale=0.5)),
    "hard_shrink": (None, _sym((3, 4), margin=0.6)),
    "softshrink": (None, _sym((3, 4), margin=0.6)),
    "tanh_shrink": (lambda x: x - np.tanh(x), _rnd((3, 4))),
    "thresholded_relu": (None, _sym((3, 4), margin=1.1)),
    "stanh": (None, _rnd((3, 4))),
    "sign": (np.sign, _sym((3, 4))),
    "floor": (np.floor, _sym((3, 4))),
    "ceil": (np.ceil, _sym((3, 4))),
    "round": (np.round, _sym((3, 4))),
}
for name, (ref, x) in UNARY.items():
    skip = name in ("sign", "floor", "ceil", "round")  # zero-grad ops
    case(name, inputs={"X": x},
         ref=(lambda r: (lambda ins, attrs: {"Out": r(ins["X"])}))(ref)
         if ref else None,
         skip_grad=skip, reason="derivative is 0 a.e." if skip else None)

# ---------------------------------------------------------------------------
# binary elementwise
# ---------------------------------------------------------------------------
A = _rnd((3, 4), 1)
B_ = _sym((3, 4), 2, margin=0.4)
AB_APART = (A, np.where(np.abs(A - B_) < 0.2, B_ + 0.5, B_))
BIN = {
    "elementwise_add": (lambda a, b: a + b, A, B_),
    "elementwise_sub": (lambda a, b: a - b, A, B_),
    "elementwise_mul": (lambda a, b: a * b, A, B_),
    "elementwise_div": (lambda a, b: a / b, A, B_),
    "elementwise_max": (np.maximum, *AB_APART),
    "elementwise_min": (np.minimum, *AB_APART),
    "maximum": (np.maximum, *AB_APART),
    "minimum": (np.minimum, *AB_APART),
    "elementwise_pow": (np.power, _pos((3, 4), seed=3), _pos((3, 4), 4)),
    "pow": (None, _pos((3, 4)), None),
    "elementwise_mod": (np.mod, _pos((3, 4), 1.0, 5.0, 5),
                        _pos((3, 4), 1.0, 2.0, 6)),
    "elementwise_floordiv": (None, _pos((3, 4), 1.0, 5.0, 5),
                             _pos((3, 4), 1.0, 2.0, 6)),
}
for name, (ref, a, b) in BIN.items():
    ins = {"X": a} if b is None else {"X": a, "Y": b}
    skip = name in ("elementwise_mod", "elementwise_floordiv")
    case(name, inputs=ins,
         attrs={"factor": 2.0} if name == "pow" else {},
         ref=(lambda r: (lambda ins, attrs: {
             "Out": r(ins["X"], ins["Y"])}))(ref) if ref else None,
         skip_grad=skip,
         reason="integer-like semantics" if skip else None)

# ---------------------------------------------------------------------------
# reductions / stats
# ---------------------------------------------------------------------------
for name, ref in [("reduce_sum", np.sum), ("reduce_mean", np.mean),
                  ("reduce_prod", np.prod)]:
    case(name, inputs={"X": _pos((3, 4), seed=8)}, attrs={"dim": [1]},
         ref=(lambda r: (lambda ins, attrs: {
             "Out": r(ins["X"], axis=1)}))(ref), static=True)
uniq = (np.arange(12, dtype=np.float32).reshape(3, 4)
        + _rnd((3, 4), 9, 0.1))
case("reduce_max", inputs={"X": uniq}, attrs={"dim": [1]},
     ref=lambda ins, attrs: {"Out": ins["X"].max(1)})
case("reduce_min", inputs={"X": uniq}, attrs={"dim": [1]},
     ref=lambda ins, attrs: {"Out": ins["X"].min(1)})
case("reduce_all", inputs={"X": np.array([[True, False], [True, True]])},
     attrs={"dim": [1]},
     ref=lambda ins, attrs: {"Out": ins["X"].all(1)}, skip_grad=True,
     reason="bool op")
case("reduce_any", inputs={"X": np.array([[True, False], [False, False]])},
     attrs={"dim": [1]},
     ref=lambda ins, attrs: {"Out": ins["X"].any(1)}, skip_grad=True,
     reason="bool op")
case("mean", inputs={"X": _rnd((3, 4), 10)},
     ref=lambda ins, attrs: {"Out": ins["X"].mean()}, static=True)
case("cumsum", inputs={"X": _rnd((3, 4), 11)}, attrs={"axis": 1},
     ref=lambda ins, attrs: {"Out": np.cumsum(ins["X"], 1)})
case("frobenius_norm", inputs={"X": _pos((3, 4), seed=12)},
     attrs={"dim": [0, 1], "keep_dim": False, "reduce_all": True},
     ref=lambda ins, attrs: {"Out": np.sqrt((ins["X"] ** 2).sum())})
case("p_norm", inputs={"X": _sym((3, 4), 13)},
     attrs={"porder": 2.0, "axis": 1},
     ref=lambda ins, attrs: {
         "Out": np.sqrt((ins["X"] ** 2).sum(1))})
case("squared_l2_norm", inputs={"X": _rnd((3, 4), 14)},
     ref=lambda ins, attrs: {"Out": (ins["X"] ** 2).sum()})
case("clip_by_norm", inputs={"X": _rnd((3, 4), 15)},
     attrs={"max_norm": 1.0})
case("clip", inputs={"X": _sym((3, 4), 16)},
     attrs={"min": -0.8, "max": 0.8},
     ref=lambda ins, attrs: {"Out": np.clip(ins["X"], -0.8, 0.8)})

# ---------------------------------------------------------------------------
# matmul family
# ---------------------------------------------------------------------------
case("mul", inputs={"X": _rnd((3, 4), 17), "Y": _rnd((4, 5), 18)},
     ref=lambda ins, attrs: {"Out": ins["X"] @ ins["Y"]}, static=True)
case("matmul", inputs={"X": _rnd((2, 3, 4), 19), "Y": _rnd((2, 4, 5), 20)},
     ref=lambda ins, attrs: {"Out": ins["X"] @ ins["Y"]})
case("matmul_v2",
     inputs={"X": _rnd((2, 3, 4), 21), "Y": _rnd((2, 5, 4), 22)},
     attrs={"trans_y": True},
     ref=lambda ins, attrs: {
         "Out": ins["X"] @ ins["Y"].transpose(0, 2, 1)})
case("bmm", inputs={"X": _rnd((2, 3, 4), 23), "Y": _rnd((2, 4, 5), 24)},
     ref=lambda ins, attrs: {"Out": ins["X"] @ ins["Y"]})
case("dot", inputs={"X": _rnd((3, 4), 25), "Y": _rnd((3, 4), 26)},
     # reference keeps the reduced dim: test_dot_op.py DotOpBatch
     # expects [B, 1]
     ref=lambda ins, attrs: {
         "Out": (ins["X"] * ins["Y"]).sum(-1, keepdims=True)})
case("addmm", inputs={"Input": _rnd((3, 5), 27), "X": _rnd((3, 4), 28),
                      "Y": _rnd((4, 5), 29)},
     ref=lambda ins, attrs: {"Out": ins["Input"] + ins["X"] @ ins["Y"]})
case("kron", inputs={"X": _rnd((2, 3), 30), "Y": _rnd((3, 2), 31)},
     ref=lambda ins, attrs: {"Out": np.kron(ins["X"], ins["Y"])})

# ---------------------------------------------------------------------------
# shape / indexing manipulation
# ---------------------------------------------------------------------------
case("reshape2", inputs={"X": _rnd((3, 4), 32)}, attrs={"shape": [2, 6]},
     ref=lambda ins, attrs: {"Out": ins["X"].reshape(2, 6)})
case("reshape", inputs={"X": _rnd((3, 4), 32)}, attrs={"shape": [12]},
     ref=lambda ins, attrs: {"Out": ins["X"].reshape(12)})
case("transpose2", inputs={"X": _rnd((2, 3, 4), 33)},
     attrs={"axis": [2, 0, 1]},
     ref=lambda ins, attrs: {"Out": ins["X"].transpose(2, 0, 1)})
case("transpose", inputs={"X": _rnd((3, 4), 33)}, attrs={"axis": [1, 0]},
     ref=lambda ins, attrs: {"Out": ins["X"].T})
case("squeeze2", inputs={"X": _rnd((3, 1, 4), 34)}, attrs={"axes": [1]},
     ref=lambda ins, attrs: {"Out": ins["X"][:, 0]})
case("squeeze", inputs={"X": _rnd((3, 1, 4), 34)}, attrs={"axes": [1]})
case("unsqueeze2", inputs={"X": _rnd((3, 4), 35)}, attrs={"axes": [1]},
     ref=lambda ins, attrs: {"Out": ins["X"][:, None]})
case("unsqueeze", inputs={"X": _rnd((3, 4), 35)}, attrs={"axes": [0]})
case("flatten_contiguous_range", inputs={"X": _rnd((2, 3, 4), 36)},
     attrs={"start_axis": 1, "stop_axis": 2},
     ref=lambda ins, attrs: {"Out": ins["X"].reshape(2, 12)})
case("flatten", inputs={"X": _rnd((2, 3, 4), 36)}, attrs={"axis": 1})
case("flatten2", inputs={"X": _rnd((2, 3, 4), 36)}, attrs={"axis": 1})
case("concat", inputs={"X": [_rnd((2, 3), 37), _rnd((2, 2), 38)]},
     attrs={"axis": 1},
     ref=lambda ins, attrs: {
         "Out": np.concatenate(ins["X"], axis=1)}, static=True)
case("split", inputs={"X": _rnd((2, 6), 39)}, attrs={"num": 3, "axis": 1},
     ref=lambda ins, attrs: {"Out": np.split(ins["X"], 3, 1)})
case("stack", inputs={"X": [_rnd((2, 3), 40), _rnd((2, 3), 41)]},
     attrs={"axis": 0},
     ref=lambda ins, attrs: {"Y": np.stack(ins["X"], 0)})
case("unstack", inputs={"X": _rnd((3, 4), 42)}, attrs={"axis": 0},
     ref=lambda ins, attrs: {"Y": list(ins["X"])})
case("unbind", inputs={"X": _rnd((3, 4), 43)}, attrs={"axis": 0})
case("tile", inputs={"X": _rnd((2, 3), 44)},
     attrs={"repeat_times": [2, 2]},
     ref=lambda ins, attrs: {"Out": np.tile(ins["X"], (2, 2))})
case("expand", inputs={"X": _rnd((1, 3), 45)},
     attrs={"expand_times": [4, 1]},
     ref=lambda ins, attrs: {"Out": np.tile(ins["X"], (4, 1))})
case("expand_v2", inputs={"X": _rnd((1, 3), 45)},
     attrs={"shape": [4, 3]},
     ref=lambda ins, attrs: {
         "Out": np.broadcast_to(ins["X"], (4, 3))})
case("expand_as_v2",
     inputs={"X": _rnd((1, 3), 45), "Y": _rnd((4, 3), 46)},
     grad_slots=["X"])
case("flip", inputs={"X": _rnd((3, 4), 47)}, attrs={"axis": [1]},
     ref=lambda ins, attrs: {"Out": ins["X"][:, ::-1]})
case("roll", inputs={"X": _rnd((3, 4), 48)},
     attrs={"shifts": [1], "axis": [1]},
     ref=lambda ins, attrs: {"Out": np.roll(ins["X"], 1, 1)})
case("pad", inputs={"X": _rnd((2, 3), 49)},
     attrs={"paddings": [1, 1, 0, 2], "pad_value": 0.5},
     ref=lambda ins, attrs: {"Out": np.pad(
         ins["X"], [(1, 1), (0, 2)], constant_values=0.5)})
case("pad2d", inputs={"X": _rnd((1, 2, 3, 3), 50)},
     attrs={"paddings": [1, 1, 1, 1], "mode": "constant"})
case("slice", inputs={"Input": _rnd((3, 6), 51)},
     attrs={"axes": [1], "starts": [1], "ends": [4]},
     ref=lambda ins, attrs: {"Out": ins["Input"][:, 1:4]})
case("strided_slice", inputs={"Input": _rnd((3, 8), 52)},
     attrs={"axes": [1], "starts": [0], "ends": [8], "strides": [2]},
     ref=lambda ins, attrs: {"Out": ins["Input"][:, ::2]})
case("gather", inputs={"X": _rnd((5, 3), 53),
                       "Index": np.array([0, 2, 2, 4])},
     ref=lambda ins, attrs: {"Out": ins["X"][ins["Index"]]})
case("gather_nd", inputs={"X": _rnd((3, 4), 54),
                          "Index": np.array([[0, 1], [2, 3]])},
     ref=lambda ins, attrs: {"Out": ins["X"][[0, 2], [1, 3]]})
case("index_select", inputs={"X": _rnd((5, 3), 55),
                             "Index": np.array([1, 1, 3])},
     attrs={"dim": 0},
     ref=lambda ins, attrs: {"Out": ins["X"][[1, 1, 3]]})
case("index_sample", inputs={"X": _rnd((3, 5), 56),
                             "Index": np.array([[0, 2], [1, 1], [4, 0]])},
     ref=lambda ins, attrs: {"Out": np.take_along_axis(
         ins["X"], ins["Index"], 1)})
case("scatter", inputs={"X": _rnd((5, 3), 57),
                        "Ids": np.array([1, 3]),
                        "Updates": _rnd((2, 3), 58)},
     attrs={"overwrite": True})
case("scatter_nd_add", inputs={"X": _rnd((5, 3), 59),
                               "Index": np.array([[1], [3]]),
                               "Updates": _rnd((2, 3), 60)})
case("where", inputs={"Condition": np.array([[True, False],
                                             [False, True]]),
                      "X": _rnd((2, 2), 61), "Y": _rnd((2, 2), 62)},
     ref=lambda ins, attrs: {"Out": np.where(
         ins["Condition"], ins["X"], ins["Y"])})
case("masked_fill", inputs={"X": _rnd((2, 3), 63),
                            "Mask": np.array([[True, False, True],
                                              [False, True, False]])},
     attrs={"value": 9.0})
case("tril_triu", inputs={"X": _rnd((4, 4), 64)},
     attrs={"diagonal": 0, "lower": True},
     ref=lambda ins, attrs: {"Out": np.tril(ins["X"])})
case("diag_v2", inputs={"X": _rnd((4,), 65)},
     attrs={"offset": 0, "padding_value": 0.0},
     ref=lambda ins, attrs: {"Out": np.diag(ins["X"])})
case("meshgrid", inputs={"X": [_rnd((3,), 66), _rnd((4,), 67)]})
case("top_k_v2", inputs={"X": uniq}, attrs={"k": 2, "axis": 1},
     ref=lambda ins, attrs: {
         "Out": np.sort(ins["X"], 1)[:, ::-1][:, :2]})
case("top_k", inputs={"X": uniq}, attrs={"k": 2})
case("cast", inputs={"X": _rnd((3, 4), 68)},
     attrs={"in_dtype": "float32", "out_dtype": "float32"})
case("scale", inputs={"X": _rnd((3, 4), 69)},
     attrs={"scale": 2.0, "bias": 1.0},
     ref=lambda ins, attrs: {"Out": 2 * ins["X"] + 1}, static=True)
case("lerp", inputs={"X": _rnd((3, 4), 70), "Y": _rnd((3, 4), 71),
                     "Weight": _pos((3, 4), 0.1, 0.9, 72)},
     ref=lambda ins, attrs: {"Out": ins["X"] + ins["Weight"]
                             * (ins["Y"] - ins["X"])})
case("increment", inputs={"X": np.array([2.0], "float32")},
     attrs={"step": 1.0},
     ref=lambda ins, attrs: {"Out": ins["X"] + 1})
case("assign", inputs={"X": _rnd((3, 4), 73)},
     ref=lambda ins, attrs: {"Out": ins["X"]})
case("label_smooth",
     inputs={"X": np.eye(3, dtype=np.float32)},
     attrs={"epsilon": 0.1},
     ref=lambda ins, attrs: {"Out": 0.9 * ins["X"] + 0.1 / 3})

# ---------------------------------------------------------------------------
# losses / nn
# ---------------------------------------------------------------------------
LOGITS = _rnd((4, 5), 80)
LABELS = np.array([[1], [0], [4], [2]], "int64")
case("softmax", inputs={"X": LOGITS}, attrs={"axis": -1},
     ref=lambda ins, attrs: {"Out": np.exp(ins["X"]) / np.exp(
         ins["X"]).sum(-1, keepdims=True)}, static=True)
case("log_softmax", inputs={"X": LOGITS}, attrs={"axis": -1})
case("softmax_with_cross_entropy",
     inputs={"Logits": LOGITS, "Label": LABELS}, static=True)
case("cross_entropy",
     inputs={"X": _pos((4, 5), 0.05, 0.9, 81)
             / _pos((4, 5), 0.05, 0.9, 81).sum(-1, keepdims=True),
             "Label": LABELS})
case("bce_loss", inputs={"X": _pos((3, 4), 0.1, 0.9, 82),
                         "Label": (R(83).rand(3, 4) < 0.5)
                         .astype("float32")},
     grad_slots=["X"])
case("sigmoid_cross_entropy_with_logits",
     inputs={"X": _rnd((3, 4), 84),
             "Label": (R(85).rand(3, 4) < 0.5).astype("float32")},
     grad_slots=["X"])
case("nll_loss", inputs={"X": np.log(_pos((4, 5), 0.1, 0.9, 86)),
                         "Label": LABELS.ravel()},
     grad_slots=["X"])
case("kldiv_loss", inputs={"X": np.log(_pos((3, 4), 0.1, 0.9, 87)),
                           "Target": _pos((3, 4), 0.1, 0.9, 88)},
     attrs={"reduction": "mean"}, grad_slots=["X"])
case("huber_loss", inputs={"X": _rnd((3, 1), 89), "Y": _rnd((3, 1), 90)},
     attrs={"delta": 1.0})
case("smooth_l1_loss", inputs={"X": _rnd((3, 4), 91),
                               "Y": _rnd((3, 4), 92)},
     grad_slots=["X"])
case("mse_loss", inputs={"X": _rnd((3, 4), 93), "Y": _rnd((3, 4), 94)})
case("squared_error_cost", inputs={"X": _rnd((3, 1), 95),
                                   "Y": _rnd((3, 1), 96)})
case("lookup_table_v2", inputs={"W": _rnd((10, 4), 97),
                                "Ids": np.array([[1, 2], [3, 1]])},
     ref=lambda ins, attrs: {"Out": ins["W"][ins["Ids"]]})
case("lookup_table", inputs={"W": _rnd((10, 4), 97),
                             "Ids": np.array([[1], [3]], "int64")})
case("conv2d", inputs={"Input": _rnd((2, 3, 6, 6), 98),
                       "Filter": _rnd((4, 3, 3, 3), 99, 0.3)},
     attrs={"strides": [1, 1], "paddings": [1, 1]}, static=True,
     grad_atol=1e-2, grad_rtol=1e-2)
case("depthwise_conv2d", inputs={"Input": _rnd((1, 4, 5, 5), 100),
                                 "Filter": _rnd((4, 1, 3, 3), 101, 0.3)},
     attrs={"strides": [1, 1], "paddings": [1, 1], "groups": 4},
     grad_atol=1e-2, grad_rtol=1e-2)
def _conv_transpose_ref(ins, attrs):
    import torch
    import torch.nn.functional as TF
    r = TF.conv_transpose2d(
        torch.from_numpy(ins["Input"].copy()),
        torch.from_numpy(ins["Filter"].copy()),
        stride=attrs["strides"], padding=attrs["paddings"][0],
        output_padding=(attrs.get("output_padding") or [0])[0],
        groups=attrs.get("groups", 1),
        dilation=attrs.get("dilations", [1, 1]))
    return {"Output": r.numpy()}


case("conv2d_transpose", inputs={"Input": _rnd((1, 3, 4, 4), 102),
                                 "Filter": _rnd((3, 2, 3, 3), 103, 0.3)},
     attrs={"strides": [2, 2], "paddings": [0, 0]},
     ref=_conv_transpose_ref, grad_atol=1e-2, grad_rtol=1e-2)
# grouped + padded + output_padding variant (review regression: groups and
# output_padding were silently ignored)
SWEEP["conv2d_transpose_grouped"] = OpCase(
    "conv2d_transpose",
    inputs={"Input": _rnd((2, 4, 5, 5), 124),
            "Filter": _rnd((4, 3, 3, 3), 125, 0.3)},
    attrs={"strides": [2, 2], "paddings": [1, 1], "groups": 2,
           "output_padding": [1, 1], "dilations": [1, 1]},
    ref=_conv_transpose_ref, grad_atol=1e-2, grad_rtol=1e-2)
def _conv3d_ref(ins, attrs):
    import torch
    import torch.nn.functional as TF
    r = TF.conv3d(torch.from_numpy(ins["Input"].copy()),
                  torch.from_numpy(ins["Filter"].copy()),
                  stride=attrs["strides"], padding=attrs["paddings"][0],
                  dilation=attrs.get("dilations", [1, 1, 1]),
                  groups=attrs.get("groups", 1))
    return {"Output": r.numpy()}


case("conv3d", inputs={"Input": _rnd((1, 2, 4, 5, 5), 130),
                       "Filter": _rnd((3, 2, 2, 3, 3), 131, 0.3)},
     attrs={"strides": [1, 1, 1], "paddings": [1, 1, 1]},
     ref=_conv3d_ref, grad_atol=1e-2, grad_rtol=1e-2)


def _conv3d_transpose_ref(ins, attrs):
    import torch
    import torch.nn.functional as TF
    r = TF.conv_transpose3d(
        torch.from_numpy(ins["Input"].copy()),
        torch.from_numpy(ins["Filter"].copy()),
        stride=attrs["strides"], padding=attrs["paddings"][0],
        output_padding=(attrs.get("output_padding") or [0])[0],
        groups=attrs.get("groups", 1),
        dilation=attrs.get("dilations", [1, 1, 1]))
    return {"Output": r.numpy()}


case("conv3d_transpose", inputs={"Input": _rnd((1, 2, 3, 4, 4), 132),
                                 "Filter": _rnd((2, 2, 2, 3, 3), 133, 0.3)},
     attrs={"strides": [2, 2, 2], "paddings": [1, 1, 1],
            "output_padding": [1, 1, 1]},
     ref=_conv3d_transpose_ref, grad_atol=1e-2, grad_rtol=1e-2)


def _pool3d_ref(ins, attrs):
    import torch
    import torch.nn.functional as TF
    t = torch.from_numpy(ins["X"].copy())
    if attrs["pooling_type"] == "max":
        r = TF.max_pool3d(t, attrs["ksize"], attrs["strides"],
                          attrs["paddings"][0])
    else:
        r = TF.avg_pool3d(t, attrs["ksize"], attrs["strides"],
                          attrs["paddings"][0])
    return {"Out": r.numpy()}


case("pool3d", inputs={"X": _rnd((1, 2, 4, 4, 4), 134)},
     attrs={"pooling_type": "max", "ksize": [2, 2, 2],
            "strides": [2, 2, 2], "paddings": [0, 0, 0]},
     ref=_pool3d_ref)
SWEEP["pool3d_avg"] = OpCase(
    "pool3d", inputs={"X": _rnd((1, 2, 4, 4, 4), 135)},
    attrs={"pooling_type": "avg", "ksize": [2, 2, 2],
           "strides": [2, 2, 2], "paddings": [0, 0, 0],
           "global_pooling": False, "ceil_mode": False,
           "exclusive": True, "adaptive": False},
    ref=_pool3d_ref)
case("pool2d", inputs={"X": _rnd((1, 2, 4, 4), 104)},
     attrs={"pooling_type": "avg", "ksize": [2, 2], "strides": [2, 2]})
case("layer_norm", inputs={"X": _rnd((3, 8), 105),
                           "Scale": _pos((8,), seed=106),
                           "Bias": _rnd((8,), 107)},
     attrs={"begin_norm_axis": 1})
case("group_norm", inputs={"X": _rnd((2, 4, 3, 3), 108),
                           "Scale": _pos((4,), seed=109),
                           "Bias": _rnd((4,), 110)},
     attrs={"groups": 2})
case("instance_norm", inputs={"X": _rnd((2, 3, 4, 4), 111),
                              "Scale": _pos((3,), seed=112),
                              "Bias": _rnd((3,), 113)})
case("batch_norm", inputs={"X": _rnd((4, 3, 2, 2), 114),
                           "Scale": _pos((3,), seed=115),
                           "Bias": _rnd((3,), 116),
                           "Mean": np.zeros(3, "float32"),
                           "Variance": np.ones(3, "float32")},
     attrs={"is_test": True, "use_global_stats": True},
     grad_slots=["X", "Scale", "Bias"])
case("interp_nearest", inputs={"X": _rnd((1, 2, 3, 3), 117)},
     attrs={"out_h": 6, "out_w": 6, "data_layout": "NCHW"})
case("dropout", inputs={"X": _pos((4, 4), seed=118)},
     attrs={"dropout_prob": 0.0},
     ref=lambda ins, attrs: {"Out": ins["X"]},
     skip_grad=True, reason="stochastic (p=0 output identity checked)")
case("segment_pool", inputs={"X": _rnd((4, 3), 119),
                             "SegmentIds": np.array([0, 0, 1, 1])},
     attrs={"pooltype": "SUM", "num_segments": 2})
case("sequence_pool", inputs={"X": _rnd((2, 3, 2), 120),
                              "Length": np.array([2, 3])},
     attrs={"pooltype": "AVERAGE"})
case("sequence_softmax", inputs={"X": _rnd((2, 4), 121),
                                 "Length": np.array([2, 4])})
case("sequence_reverse", inputs={"X": _rnd((2, 4, 2), 122),
                                 "Length": np.array([3, 4])})
case("sequence_pad", inputs={"X": _rnd((5, 2), 123),
                             "Length": np.array([2, 3])},
     attrs={"padded_length": 4})

# -- the math parity suite's own cases ----------------------------------------



def _math_rnd(shape, seed):
    return R(seed).randn(*shape).astype(np.float32)


MATH_A, MATH_B = _math_rnd((3, 4), 1), _math_rnd((3, 4), 2)
MATH_B[np.abs(MATH_A - MATH_B) < 0.05] += 0.3   # no ties for the comparisons
MATH_BOOL = (R(3).rand(3, 4) < 0.5, R(4).rand(3, 4) < 0.5)
MATH_SPECIAL = np.array([[1.0, np.inf, -2.0, np.nan]], np.float32)

MATH_OWN = {
    **{op: OpCase(op, {"X": MATH_A, "Y": MATH_B}) for op in (
        "equal", "not_equal", "less_than", "less_equal", "greater_than",
        "greater_equal")},
    **{op: OpCase(op, {"X": MATH_BOOL[0], "Y": MATH_BOOL[1]}) for op in (
        "logical_and", "logical_or", "logical_xor")},
    "logical_not": OpCase("logical_not", {"X": MATH_BOOL[0]}),
    "isfinite": OpCase("isfinite", {"X": MATH_SPECIAL}),
    "isfinite_v2": OpCase("isfinite_v2", {"X": MATH_SPECIAL}),
    "isnan_v2": OpCase("isnan_v2", {"X": MATH_SPECIAL}),
    "isinf_v2": OpCase("isinf_v2", {"X": MATH_SPECIAL}),
    "sum": OpCase("sum", {"X": [MATH_A, MATH_B, _math_rnd((3, 4), 5)]}),
    # dense tensors pass through (SelectedRows: test_torch_selected_rows)
    "merge_selected_rows": OpCase("merge_selected_rows", {"X": MATH_A}),
    "get_tensor_from_selected_rows": OpCase(
        "get_tensor_from_selected_rows", {"X": MATH_A}),
    # broadcast along Paddle's axis, and a reduction over every axis
    "elementwise_add_axis": OpCase(
        "elementwise_add",
        {"X": _math_rnd((2, 3, 4), 6), "Y": _math_rnd((3,), 7)},
        {"axis": 1}),
    "reduce_sum_all": OpCase("reduce_sum", {"X": _math_rnd((2, 3), 8)},
                             {"dim": [0], "reduce_all": True,
                              "keep_dim": True}),
    "matmul_alpha": OpCase("matmul", {"X": _math_rnd((3, 4), 9),
                                      "Y": _math_rnd((5, 4), 10)},
                           {"transpose_Y": True, "alpha": 0.5}),
    "cumsum_rev": OpCase("cumsum", {"X": _math_rnd((3, 4), 11)},
                         {"axis": 1, "exclusive": True, "reverse": True}),
    "gelu_tanh": OpCase("gelu", {"X": _math_rnd((3, 4), 12)},
                        {"approximate": True}),
}


# -- the tensor parity suite's own cases --------------------------------------



def _tensor_rnd(shape, seed):
    return R(seed).randn(*shape).astype(np.float32)


TENSOR_UNIQ = np.arange(12, dtype=np.float32).reshape(3, 4)[:, ::-1] * 0.5 \
    + _tensor_rnd((3, 4), 1) * 0.01
TENSOR_OWN = {
    "arg_max": OpCase("arg_max", {"X": TENSOR_UNIQ}, {"axis": 1}),
    "arg_min": OpCase("arg_min", {"X": TENSOR_UNIQ}, {"axis": 0,
                                               "keepdims": True}),
    "argsort": OpCase("argsort", {"X": TENSOR_UNIQ}, {"axis": 1,
                                               "descending": True}),
    "assign_value": OpCase("assign_value", {},
                           {"shape": [2, 2], "dtype": "float32",
                            "fp32_values": [1.0, 2.0, 3.0, 4.0]}),
    "eye": OpCase("eye", {}, {"num_rows": 3, "num_columns": 4}),
    "fill_any_like": OpCase("fill_any_like", {"X": TENSOR_UNIQ},
                            {"value": 2.5}),
    "fill_constant": OpCase("fill_constant", {},
                            {"shape": [2, 3], "value": 1.5}),
    "fill_zeros_like": OpCase("fill_zeros_like", {"X": TENSOR_UNIQ}),
    "linspace": OpCase("linspace", {"Start": np.array([0.0], np.float32),
                                    "Stop": np.array([1.0], np.float32),
                                    "Num": np.array([5], np.int32)}),
    "range": OpCase("range", {"Start": np.array([1], np.int32),
                              "End": np.array([9], np.int32),
                              "Step": np.array([2], np.int32)}),
    "shape": OpCase("shape", {"Input": TENSOR_UNIQ}),
    "shard_index": OpCase("shard_index",
                          {"X": np.array([[1], [6], [12], [19]], np.int32)},
                          {"index_num": 20, "nshards": 2, "shard_id": 1}),
    "unique": OpCase("unique", {"X": np.array([3, 1, 3, 2, 1], np.int32)}),
    # the BERT program's uses: a gather of rows, a [CLS] slice with the
    # axis dropped, a 0 in reshape's shape, a negative start
    "gather_rows": OpCase("gather", {"X": _tensor_rnd((6, 4), 2),
                                     "Index": np.array([5, 0, 3])}),
    "slice_decrease": OpCase("slice", {"Input": _tensor_rnd((2, 5, 3), 3)},
                             {"axes": [1], "starts": [0], "ends": [1],
                              "decrease_axis": [1]}),
    "slice_negative": OpCase("slice", {"Input": _tensor_rnd((2, 5, 3), 4)},
                             {"axes": [1, 2], "starts": [-3, 1],
                              "ends": [10, 3]}),
    "reshape2_zero": OpCase("reshape2", {"X": _tensor_rnd((2, 3, 4), 5)},
                            {"shape": [0, -1]}),
    "split_sections": OpCase("split", {"X": _tensor_rnd((2, 6), 6)},
                             {"axis": 1, "sections": [1, 2, 3]}),
    "strided_slice_neg": OpCase("strided_slice",
                                {"Input": _tensor_rnd((3, 8), 7)},
                                {"axes": [1], "starts": [7], "ends": [0],
                                 "strides": [-2]}),
}


# -- the nn parity suite's own cases ------------------------------------------



def _nn_rnd(shape, seed, scale=1.0):
    return (R(seed).randn(*shape) * scale).astype(np.float32)


def _nn_pos(shape, seed, lo=0.5, hi=1.5):
    return R(seed).uniform(lo, hi, shape).astype(np.float32)


NN_M, NN_H, NN_I = 6, 16, 32
NN_LN = {"Scale": _nn_pos((NN_H,), 3), "Bias": _nn_rnd((NN_H,), 4, 0.1)}
NN_PAD = np.zeros((2, 1, 1, 16), np.float32)
NN_PAD[1, ..., 12:] = -1e4
NN_PAD64 = np.zeros((1, 1, 1, 64), np.float32)
NN_PAD64[0, ..., 48:] = -1e4
NN_PAGES = dict(Q=_nn_rnd((3, 2, 8), 20), KCache=_nn_rnd((6, 4, 2, 8), 21),
             VCache=_nn_rnd((6, 4, 2, 8), 22),
             PageTable=np.array([[0, 1], [2, 3], [4, 5]], np.int32),
             CtxLens=np.array([5, 8, 1], np.int32))
NN_OWN = {
    "fake_quantize_dequantize_abs_max": OpCase(
        "fake_quantize_dequantize_abs_max", {"X": _nn_rnd((3, 4), 1)}),
    "fake_quantize_dequantize_moving_average_abs_max": OpCase(
        "fake_quantize_dequantize_moving_average_abs_max",
        {"X": _nn_rnd((3, 4), 2), "InScale": np.array([1.5], np.float32)}),
    "one_hot": OpCase("one_hot", {"X": np.array([[1], [3], [0]])},
                      {"depth": 4}),
    "one_hot_v2": OpCase("one_hot_v2", {"X": np.array([1, 3, 5])},
                         {"depth": 4}),
    "fused_dropout_add_ln": OpCase(
        "fused_dropout_add_ln", {"X": _nn_rnd((NN_M, NN_H), 5),
                                 "Residual": _nn_rnd((NN_M, NN_H), 6),
                                 **NN_LN},
        {"dropout_p": 0.0, "epsilon": 1e-12}),
    "fused_ffn": OpCase("fused_ffn", {
        "X": _nn_rnd((NN_M, NN_H), 7), "W1": _nn_rnd((NN_H, NN_I), 8, 0.2),
        "B1": _nn_rnd((NN_I,), 9, 0.1), "W2": _nn_rnd((NN_I, NN_H), 10, 0.2),
        "B2": _nn_rnd((NN_H,), 11, 0.1)}),
    "fused_ffn_block": OpCase("fused_ffn_block", {
        "X": _nn_rnd((2, 3, NN_H), 12), "W1": _nn_rnd((NN_H, NN_I), 13, 0.2),
        "B1": _nn_rnd((NN_I,), 14, 0.1), "W2": _nn_rnd((NN_I, NN_H), 15, 0.2),
        "B2": _nn_rnd((NN_H,), 16, 0.1),
        "Residual": _nn_rnd((2, 3, NN_H), 17), **NN_LN},
        {"activation": "gelu", "norm": "post", "epsilon": 1e-12}),
    "fused_ffn_block_pre": OpCase("fused_ffn_block", {
        "X": _nn_rnd((NN_M, NN_H), 12), "W1": _nn_rnd((NN_H, NN_I), 13, 0.2),
        "B1": _nn_rnd((NN_I,), 14, 0.1), "W2": _nn_rnd((NN_I, NN_H), 15, 0.2),
        "B2": _nn_rnd((NN_H,), 16, 0.1),
        "Residual": _nn_rnd((NN_M, NN_H), 17), **NN_LN},
        {"activation": "relu", "norm": "pre"}),
    "fused_out_ln": OpCase("fused_out_ln", {
        "X": _nn_rnd((2, 3, NN_H), 18), "W": _nn_rnd((NN_H, NN_H), 19, 0.2),
        "B": _nn_rnd((NN_H,), 23, 0.1),
        "Residual": _nn_rnd((2, 3, NN_H), 24), **NN_LN},
        {"epsilon": 1e-12}),
    # the padding mask of the BERT program: sdpa_reference at S = 16,
    # the flash path's plain version at S = 64
    "fused_attention": OpCase("fused_attention", {
        "Q": _nn_rnd((2, 2, 16, 8), 25), "K": _nn_rnd((2, 2, 16, 8), 26),
        "V": _nn_rnd((2, 2, 16, 8), 27), "Mask": NN_PAD}),
    "fused_attention_flash": OpCase("fused_attention", {
        "Q": _nn_rnd((1, 2, 64, 8), 28), "K": _nn_rnd((1, 2, 64, 8), 29),
        "V": _nn_rnd((1, 2, 64, 8), 30), "Mask": NN_PAD64}),
    "fused_attention_causal": OpCase("fused_attention", {
        "Q": _nn_rnd((1, 2, 16, 8), 31), "K": _nn_rnd((1, 2, 16, 8), 32),
        "V": _nn_rnd((1, 2, 16, 8), 33)}, {"causal": True, "scale": 0.5}),
    "paged_attention": OpCase("paged_attention", NN_PAGES),
    "moe_ffn": OpCase("moe_ffn", {
        "X": _nn_rnd((2, 4, 8), 34), "Gate": _nn_rnd((8, 4), 35),
        "WUp": _nn_rnd((4, 8, 16), 36, 0.3), "BUp": _nn_rnd((4, 16), 37, 0.1),
        "WDown": _nn_rnd((4, 16, 8), 38, 0.3),
        "BDown": _nn_rnd((4, 8), 39, 0.1)},
        {"top_k": 2, "capacity_factor": 2.0}),
    "layer_norm_3d": OpCase("layer_norm",
                            {"X": _nn_rnd((2, 3, NN_H), 40), **NN_LN},
                            {"begin_norm_axis": 2, "epsilon": 1e-12}),
    "layer_norm_no_affine": OpCase("layer_norm",
                                   {"X": _nn_rnd((4, NN_H), 41)}),
    "lookup_table_v2_pad": OpCase(
        "lookup_table_v2", {"W": _nn_rnd((10, 4), 42),
                            "Ids": np.array([[1, 2], [0, 1]])},
        {"padding_idx": 1}),
    "dropout_test": OpCase("dropout", {"X": _nn_rnd((4, 4), 43)},
                           {"dropout_prob": 0.3, "is_test": True}),
    "softmax_axis": OpCase("softmax", {"X": _nn_rnd((2, 3, 4), 44)},
                           {"axis": 1}),
}


# -- the opt parity suite's own cases -----------------------------------------



def _opt_rnd(shape, seed, scale=1.0):
    return (R(seed).randn(*shape) * scale).astype(np.float32)


def _opt_pos(shape, seed, lo=0.1, hi=1.0):
    return R(seed).uniform(lo, hi, shape).astype(np.float32)


OPT_SHAPE = (4, 3)
OPT_PG = {"Param": _opt_rnd(OPT_SHAPE, 1), "Grad": _opt_rnd(OPT_SHAPE, 2, 0.5),
      "LearningRate": np.array([0.01], np.float32)}
OPT_POW = {"Beta1Pow": np.array([0.9 ** 3], np.float32),
       "Beta2Pow": np.array([0.999 ** 3], np.float32)}
OPT_ADAM = {**OPT_PG, "Moment1": _opt_rnd(OPT_SHAPE, 3, 0.1),
            "Moment2": _opt_pos(OPT_SHAPE, 4), **OPT_POW}


def _opt_case(op, extra, attrs=None):
    return OpCase(op, {**OPT_PG, **extra}, attrs or {})


OPT_CASES = {
    "sgd": _opt_case("sgd", {}),
    "momentum": _opt_case("momentum", {"Velocity": _opt_rnd(OPT_SHAPE, 5)}),
    "momentum_nesterov_l2": _opt_case(
        "momentum", {"Velocity": _opt_rnd(OPT_SHAPE, 5)},
        {"use_nesterov": True, "regularization_method": "l2_decay",
         "regularization_coeff": 0.1}),
    "adam": OpCase("adam", OPT_ADAM),
    "adamw": OpCase("adamw", OPT_ADAM, {"coeff": 0.1}),
    "lamb": OpCase("lamb", OPT_ADAM, {"weight_decay": 0.05}),
    "lamb_first_step": OpCase(
        "lamb", {**OPT_ADAM, "Moment1": np.zeros(OPT_SHAPE, np.float32),
                 "Moment2": np.zeros(OPT_SHAPE, np.float32),
                 "Beta1Pow": np.ones(1, np.float32),
                 "Beta2Pow": np.ones(1, np.float32)}),
    "adamax": _opt_case("adamax", {"Moment": _opt_rnd(OPT_SHAPE, 6, 0.1),
                               "InfNorm": _opt_pos(OPT_SHAPE, 7),
                               "Beta1Pow": np.array([0.81], np.float32)}),
    "adagrad": _opt_case("adagrad", {"Moment": _opt_pos(OPT_SHAPE, 8)}),
    "adadelta": OpCase("adadelta", {
        "Param": OPT_PG["Param"], "Grad": OPT_PG["Grad"],
        "AvgSquaredGrad": _opt_pos(OPT_SHAPE, 9),
        "AvgSquaredUpdate": _opt_pos(OPT_SHAPE, 10)}),
    "rmsprop": _opt_case("rmsprop", {"MeanSquare": _opt_pos(OPT_SHAPE, 11),
                                 "Moment": _opt_rnd(OPT_SHAPE, 12, 0.1),
                                 "MeanGrad": _opt_rnd(OPT_SHAPE, 13, 0.1)},
                     {"momentum": 0.9}),
    "rmsprop_centered": _opt_case(
        "rmsprop", {"MeanSquare": _opt_pos(OPT_SHAPE, 11, 0.5, 1.0),
                    "Moment": _opt_rnd(OPT_SHAPE, 12, 0.1),
                    "MeanGrad": _opt_rnd(OPT_SHAPE, 13, 0.1)},
        {"centered": True}),
    "ftrl": _opt_case("ftrl", {"SquaredAccumulator": _opt_pos(OPT_SHAPE, 14),
                           "LinearAccumulator": _opt_rnd(OPT_SHAPE, 15)},
                  {"l1": 0.1, "l2": 0.01}),
    "decayed_adagrad": _opt_case("decayed_adagrad",
                                 {"Moment": _opt_pos(OPT_SHAPE, 16)}),
    "lars_momentum": _opt_case("lars_momentum",
                               {"Velocity": _opt_rnd(OPT_SHAPE, 17)},
                           {"lars_coeff": 0.05}),
    "dgc_momentum": _opt_case("dgc_momentum", {
        "U": _opt_rnd(OPT_SHAPE, 18), "V": _opt_rnd(OPT_SHAPE, 19),
        "CurrentStep": np.array([5.0], np.float32)}, {"ratio": 0.25}),
    "dgc_momentum_rampup": _opt_case("dgc_momentum", {
        "U": _opt_rnd(OPT_SHAPE, 18), "V": _opt_rnd(OPT_SHAPE, 19),
        "CurrentStep": np.array([1.0], np.float32)},
        {"rampup_begin_step": 3.0}),
    # one process: the average is the identity in both
    "localsgd_sync": OpCase("localsgd_sync", {
        "Param": OPT_PG["Param"], "Step": np.array([4.0], np.float32)},
        {"k_steps": 2}),
    # sigma 0: no noise, the clipped step alone
    "dpsgd": _opt_case("dpsgd", {}, {"clip": 0.5, "sigma": 0.0}),
    "check_finite_and_unscale": OpCase("check_finite_and_unscale", {
        "X": [_opt_rnd(OPT_SHAPE, 20), np.array([1.0, np.inf], np.float32)],
        "Scale": np.array([4.0], np.float32)}),
    "update_loss_scaling": OpCase("update_loss_scaling", {
        "X": [_opt_rnd(OPT_SHAPE, 21)],
        "FoundInfinite": np.array([True]),
        "PrevLossScaling": np.array([1024.0], np.float32),
        "InGoodSteps": np.array([5], np.int32),
        "InBadSteps": np.array([1], np.int32)}),
    "update_loss_scaling_up": OpCase("update_loss_scaling", {
        "X": [_opt_rnd(OPT_SHAPE, 21)],
        "FoundInfinite": np.array([False]),
        "PrevLossScaling": np.array([1024.0], np.float32),
        "InGoodSteps": np.array([2], np.int32),
        "InBadSteps": np.array([0], np.int32)},
        {"incr_every_n_steps": 3}),
    "coalesce_tensor": OpCase("coalesce_tensor", {
        "Input": [_opt_rnd(OPT_SHAPE, 22), _opt_rnd((5,), 23)]}),
    "average_accumulates": OpCase("average_accumulates", {
        "param": _opt_rnd(OPT_SHAPE, 24), "in_sum_1": _opt_rnd(OPT_SHAPE, 25),
        "in_sum_2": _opt_rnd(OPT_SHAPE, 26),
        "in_sum_3": _opt_rnd(OPT_SHAPE, 27),
        "in_num_accumulates": np.array([3], np.int32),
        "in_old_num_accumulates": np.array([1], np.int32),
        "in_num_updates": np.array([7], np.int32)}),
    "clip_by_norm": SWEEP["clip_by_norm"],
    "lerp": SWEEP["lerp"],
    # metric ops
    "accuracy": OpCase("accuracy", {
        "Out": _opt_rnd((5, 2), 28),
        "Indices": np.array([[1, 0], [2, 3], [0, 1], [4, 4], [3, 2]]),
        "Label": np.array([[0], [1], [0], [4], [1]])}),
    "auc": OpCase("auc", {
        "Predict": np.stack([1 - _opt_pos((16,), 29, 0, 1),
                             _opt_pos((16,), 29, 0, 1)], 1),
        "Label": (R(30).rand(16, 1) < 0.5).astype(np.int32),
        "StatPos": np.arange(21, dtype=np.int32) % 3,
        "StatNeg": np.arange(21, dtype=np.int32) % 2},
        {"num_thresholds": 20}),
}
RANDOM = {
    "gaussian_random": ({"shape": [4000], "mean": 1.0, "std": 2.0}, {}),
    "uniform_random": ({"shape": [4000], "min": -2.0, "max": 3.0}, {}),
    "uniform_random_batch_size_like": (
        {"shape": [-1, 500], "min": 0.0, "max": 1.0},
        {"Input": np.zeros((8, 2), np.float32)}),
    "truncated_gaussian_random": ({"shape": [4000], "std": 0.02}, {}),
    "randint": ({"shape": [4000], "low": 3, "high": 9}, {}),
    "randperm": ({"n": 50}, {}),
    "bernoulli": ({}, {"X": np.full((4000,), 0.3, np.float32)}),
    "multinomial": ({"num_samples": 3},
                    {"X": np.array([[0.1, 0.2, 0.3, 0.4]] * 800,
                                   np.float32)}),
    "sampling_id": ({}, {"X": np.array([[0.1, 0.2, 0.7]] * 2000,
                                       np.float32)}),
    "seed": ({"seed": 17}, {}),
    "gaussian_random_batch_size_like": (
        {"shape": [-1, 500], "mean": 1.0, "std": 2.0},
        {"Input": np.zeros((8, 2), np.float32)}),
}


# -- the sequence parity suite's own cases ------------------------------------


def _seq_rnd(shape, seed, scale=1.0):
    return (R(seed).randn(*shape) * scale).astype(np.float32)


def _rnn_weights(mode, d, h, layers, ndir, seed):
    """The rnn op's WeightList (sequence_ops.rnn_weight_shapes' order:
    w_ih, w_hh, b_ih, b_hh a layer and direction), uniform in
    +-1/sqrt(h) as layers.dynamic_rnn initialises it."""
    g = {"LSTM": 4, "GRU": 3}.get(mode, 1)
    r, std, out = R(seed), 1.0 / np.sqrt(h), []
    for layer in range(layers):
        fan_in = d if layer == 0 else h * ndir
        for _ in range(ndir):
            for shape in ((g * h, fan_in), (g * h, h), (g * h,), (g * h,)):
                out.append(r.uniform(-std, std, shape).astype(np.float32))
    return out


SEQ_LENS = np.array([5, 2, 4], np.int64)
SEQ_X = _seq_rnd((3, 5, 4), 1)
SEQ_OWN = {
    "sequence_mask": OpCase("sequence_mask", {"X": SEQ_LENS},
                            {"maxlen": 6}),
    "sequence_mask_dynamic": OpCase("sequence_mask", {"X": SEQ_LENS},
                                    {"out_dtype": "float32"}),
    "sequence_unpad": OpCase("sequence_unpad",
                             {"X": SEQ_X, "Length": SEQ_LENS}),
    "sequence_expand": OpCase("sequence_expand",
                              {"X": _seq_rnd((3, 2), 2),
                               "RefLength": np.array([2, 0, 3])}),
    **{f"sequence_pool_{p.lower()}": OpCase(
        "sequence_pool", {"X": SEQ_X, "Length": np.array([5, 0, 3])},
        {"pooltype": p, "pad_value": 0.5})
       for p in ("SUM", "AVERAGE", "SQRT", "MAX", "MIN", "LAST", "FIRST")},
    "sequence_softmax_len": OpCase("sequence_softmax",
                                   {"X": _seq_rnd((3, 5), 3),
                                    "Length": SEQ_LENS}),
    "sequence_reverse_nolen": OpCase("sequence_reverse",
                                     {"X": _seq_rnd((2, 3, 2), 4)}),
    "sequence_pad_fixed": OpCase("sequence_pad",
                                 {"X": _seq_rnd((6, 3), 5),
                                  "Length": np.array([1, 3, 2])},
                                 {"padded_length": 4, "pad_value": -1.0}),
    **{f"segment_pool_{p.lower()}": OpCase(
        "segment_pool", {"X": _seq_rnd((6, 3), 6),
                         "SegmentIds": np.array([0, 0, 2, 2, 2, 3])},
        {"pooltype": p, "num_segments": 4})
       for p in ("MEAN", "MAX", "MIN")},
    # num_segments from the ids' values: the reference's jitted static
    # graph needs it as an attr, so the gradient is held on the cases
    # above
    "segment_pool_dynamic": OpCase(
        "segment_pool", {"X": _seq_rnd((5, 2), 7),
                         "SegmentIds": np.array([0, 1, 1, 2, 2])},
        skip_grad=True),
    # the recurrent net: LAC's bidirectional GRU over two layers with
    # uneven lengths, a bidirectional LSTM from given states, one tanh
    # layer
    "rnn_gru_bi2": OpCase("rnn", {
        "Input": _seq_rnd((3, 5, 4), 8), "SequenceLength": SEQ_LENS,
        "WeightList": _rnn_weights("GRU", 4, 3, 2, 2, 9)},
        {"mode": "GRU", "hidden_size": 3, "num_layers": 2,
         "is_bidirec": True}),
    "rnn_lstm_bi": OpCase("rnn", {
        "Input": _seq_rnd((3, 5, 4), 10), "SequenceLength": SEQ_LENS,
        "WeightList": _rnn_weights("LSTM", 4, 3, 1, 2, 11),
        "PreState": [_seq_rnd((2, 3, 3), 12, 0.5),
                     _seq_rnd((2, 3, 3), 13, 0.5)]},
        {"mode": "LSTM", "hidden_size": 3, "num_layers": 1,
         "is_bidirec": True}),
    "rnn_tanh": OpCase("rnn", {
        "Input": _seq_rnd((2, 4, 3), 14),
        "WeightList": _rnn_weights("RNN_TANH", 3, 5, 1, 1, 15)},
        {"mode": "RNN_TANH", "hidden_size": 5}),
}


# -- the structured-loss parity suite's own cases -----------------------------

LOSS_TAGS = 4
LOSS_EM = _seq_rnd((3, 5, LOSS_TAGS), 20)
LOSS_TRANS = _seq_rnd((LOSS_TAGS + 2, LOSS_TAGS), 21, 0.5)
LOSS_LAB = R(22).randint(0, LOSS_TAGS, (3, 5)).astype(np.int64)
LOSS_CTC = {"Logits": _seq_rnd((3, 12, 6), 23),
            "Label": R(24).randint(1, 6, (3, 4)).astype(np.int32),
            "LogitsLength": np.array([12, 9, 7], np.int64),
            "LabelLength": np.array([4, 3, 2], np.int64)}
LOSS_OWN = {
    "warpctc": OpCase("warpctc", LOSS_CTC),
    "warpctc_norm_by_times": OpCase("warpctc", LOSS_CTC,
                                    {"norm_by_times": True}),
    "warpctc_repeats": OpCase("warpctc", {
        **LOSS_CTC, "Label": np.array([[2, 2, 3, 3], [1, 1, 1, 0],
                                       [5, 4, 0, 0]], np.int32),
        "LabelLength": np.array([4, 3, 0], np.int64)}),
    "linear_chain_crf": OpCase("linear_chain_crf", {
        "Emission": LOSS_EM, "Transition": LOSS_TRANS, "Label": LOSS_LAB,
        "Length": SEQ_LENS}),
    "linear_chain_crf_full": OpCase("linear_chain_crf", {
        "Emission": LOSS_EM, "Transition": LOSS_TRANS,
        "Label": LOSS_LAB[..., None]}),
    "crf_decoding": OpCase("crf_decoding", {
        "Emission": LOSS_EM, "Transition": LOSS_TRANS,
        "Length": SEQ_LENS}),
    "hierarchical_sigmoid": OpCase("hierarchical_sigmoid", {
        "X": _seq_rnd((4, 3), 25), "Label": np.array([0, 4, 5, 2]),
        "W": _seq_rnd((5, 3), 26), "Bias": _seq_rnd((5,), 27)},
        {"num_classes": 6}),
    "hierarchical_sigmoid_nobias": OpCase("hierarchical_sigmoid", {
        "X": _seq_rnd((3, 3), 28), "Label": np.array([0, 1, 2]),
        "W": _seq_rnd((2, 3), 29)}, {"num_classes": 3}),
}
# nce draws its negatives with jax.random in the reference, which the
# port cannot replay: its cost is held on the reference's own samples
# (tests/test_torch_structured_loss_ops.py); these are its inputs
LOSS_NCE = {"Input": _seq_rnd((4, 3), 30),
            "Label": np.array([[1], [7], [0], [3]], np.int64),
            "Weight": _seq_rnd((9, 3), 31), "Bias": _seq_rnd((9,), 32)}


# -- the misc parity suite's own cases ----------------------------------------

def _misc_rnd(shape, seed, scale=1.0):
    return (R(seed).randn(*shape) * scale).astype(np.float32)


def _misc_pos(shape, seed, lo=0.5, hi=1.5):
    return R(seed).uniform(lo, hi, shape).astype(np.float32)


MISC_IMG = _misc_rnd((2, 4, 5, 6), 1)
MISC_ED = {"Hyps": R(2).randint(1, 5, (3, 6)).astype(np.int64),
           "Refs": R(3).randint(1, 5, (3, 7)).astype(np.int64),
           "HypsLength": np.array([6, 4, 2], np.int64),
           "RefsLength": np.array([7, 3, 5], np.int64)}
MISC_IDS = np.array([0, 3, 4, 7, 1], np.int64)
MISC_OWN = {
    "conv_shift": OpCase("conv_shift", {"X": _misc_rnd((2, 5), 4),
                                        "Y": _misc_rnd((2, 3), 5)}),
    "lrn": OpCase("lrn", {"X": _misc_pos((1, 6, 3, 3), 6)},
                  {"n": 3, "k": 1.0, "alpha": 0.1, "beta": 0.75}),
    "data_norm": OpCase("data_norm", {
        "X": _misc_rnd((4, 3), 7), "BatchSize": _misc_pos((3,), 8, 5, 9),
        "BatchSum": _misc_rnd((3,), 9), "BatchSquareSum":
        _misc_pos((3,), 10, 2, 6)}),
    "pixel_shuffle": OpCase("pixel_shuffle", {"X": _misc_rnd((1, 8, 2, 3),
                                                             11)},
                            {"upscale_factor": 2}),
    "shuffle_channel": OpCase("shuffle_channel", {"X": MISC_IMG},
                              {"group": 2}),
    "temporal_shift": OpCase("temporal_shift",
                             {"X": _misc_rnd((4, 8, 2, 2), 12)},
                             {"seg_num": 2, "shift_ratio": 0.25}),
    # sample points kept off the pixel grid (the bilinear weights' kinks)
    "grid_sampler": OpCase("grid_sampler", {
        "X": _misc_rnd((2, 3, 4, 5), 13),
        "Grid": (R(14).uniform(-1.1, 1.1, (2, 3, 4, 2)) * 0.93 + 0.011)
        .astype(np.float32)}),
    "grid_sampler_half_pixel": OpCase("grid_sampler", {
        "X": _misc_rnd((1, 2, 4, 4), 15),
        "Grid": (R(16).uniform(-0.9, 0.9, (1, 3, 3, 2)) + 0.013)
        .astype(np.float32)}, {"align_corners": False}),
    "affine_grid": OpCase("affine_grid", {"Theta": _misc_rnd((2, 2, 3), 17)},
                          {"output_shape": [2, 1, 3, 4]}),
    # the shape as a tensor: the reference's jitted static graph cannot
    # read it, so the gradient is held on the attr case above
    "affine_grid_tensor_shape": OpCase(
        "affine_grid", {"Theta": _misc_rnd((1, 2, 3), 18),
                        "OutputShape": np.array([1, 1, 4, 2], np.int32)},
        {"align_corners": False}, skip_grad=True),
    "unfold": OpCase("unfold", {"X": MISC_IMG},
                     {"kernel_sizes": [2, 3], "strides": [1, 2],
                      "paddings": [1, 0, 1, 1], "dilations": [1, 1]}),
    "spp": OpCase("spp", {"X": _misc_rnd((2, 3, 4, 4), 19)},
                  {"pyramid_height": 2, "pooling_type": "max"}),
    "spp_avg": OpCase("spp", {"X": _misc_rnd((1, 2, 4, 4), 20)},
                      {"pyramid_height": 3, "pooling_type": "avg"}),
    "norm": OpCase("norm", {"X": _misc_rnd((3, 4, 2), 21)}, {"axis": 1}),
    "edit_distance": OpCase("edit_distance", MISC_ED),
    "edit_distance_normalized": OpCase("edit_distance", MISC_ED,
                                       {"normalized": True}),
    "ctc_align": OpCase("ctc_align", {"Input": np.array(
        [[1, 1, 0, 2, 2, 0, 3], [0, 0, 1, 2, 0, 0, 0]], np.int32)}),
    "ctc_align_keep_repeats": OpCase(
        "ctc_align", {"Input": np.array([[1, 1, 0, 2, 2, 0, 3]], np.int32)},
        {"merge_repeated": False, "padding_value": -1}),
    "im2sequence": OpCase("im2sequence", {"X": _misc_rnd((2, 2, 4, 4), 22)},
                          {"kernels": [2, 2], "strides": [2, 1]}),
    "row_conv": OpCase("row_conv", {"X": _misc_rnd((2, 5, 3), 23),
                                    "Filter": _misc_rnd((3, 3), 24)}),
    "gru_unit": OpCase("gru_unit", {
        "Input": _misc_rnd((3, 12), 25), "HiddenPrev": _misc_rnd((3, 4), 26),
        "Weight": _misc_rnd((4, 12), 27, 0.5),
        "Bias": _misc_rnd((1, 12), 28)}),
    "gru_unit_origin": OpCase("gru_unit", {
        "Input": _misc_rnd((3, 12), 25), "HiddenPrev": _misc_rnd((3, 4), 26),
        "Weight": _misc_rnd((4, 12), 27, 0.5)}, {"origin_mode": True}),
    "lstm_unit": OpCase("lstm_unit", {"X": _misc_rnd((3, 16), 29),
                                      "C_prev": _misc_rnd((3, 4), 30)},
                        {"forget_bias": 1.0}),
    "add_position_encoding": OpCase("add_position_encoding",
                                     {"X": _misc_rnd((2, 4, 5), 31)},
                                     {"alpha": 0.5, "beta": 2.0}),
    "margin_rank_loss": OpCase("margin_rank_loss", {
        "X1": _misc_rnd((5, 1), 32), "X2": _misc_rnd((5, 1), 33),
        "Label": np.array([[1], [-1], [1], [1], [-1]], np.float32)},
        {"margin": 0.1}),
    "rank_loss": OpCase("rank_loss", {
        "Left": _misc_rnd((4, 1), 34), "Right": _misc_rnd((4, 1), 35),
        "Label": np.array([[1], [0], [1], [0]], np.float32)}),
    "teacher_student_sigmoid_loss": OpCase(
        "teacher_student_sigmoid_loss", {
            "X": _misc_rnd((4, 1), 36),
            "Label": np.array([[1], [0], [-0.3], [-0.8]], np.float32)}),
    "proximal_gd": OpCase("proximal_gd", {
        "Param": _misc_rnd((3, 4), 37), "Grad": _misc_rnd((3, 4), 38),
        "LearningRate": np.array([0.1], np.float32)},
        {"l1": 0.5, "l2": 0.1}),
    "proximal_adagrad": OpCase("proximal_adagrad", {
        "Param": _misc_rnd((3, 4), 39), "Grad": _misc_rnd((3, 4), 40),
        "Moment": _misc_pos((3, 4), 41),
        "LearningRate": np.array([0.1], np.float32)},
        {"l1": 0.2, "l2": 0.1}),
    "dgc_clip_by_norm": OpCase("dgc_clip_by_norm", {
        "X": _misc_rnd((3, 4), 42), "current_step": np.array([5.0],
                                                             np.float32)},
        {"max_norm": 1.0, "rampup_begin_step": 2.0}),
    "dgc_clip_by_norm_rampup": OpCase("dgc_clip_by_norm", {
        "X": _misc_rnd((3, 4), 42), "current_step": np.array([1.0],
                                                             np.float32)},
        {"max_norm": 1.0, "rampup_begin_step": 2.0}),
    "precision_recall": OpCase("precision_recall", {
        "Indices": np.array([0, 1, 2, 2, 1, 0, 3]),
        "Labels": np.array([0, 2, 2, 1, 1, 0, 3])}, {"class_number": 4}),
    "positive_negative_pair": OpCase("positive_negative_pair", {
        "Score": np.array([0.9, 0.2, 0.5, 0.5, 0.1, 0.7], np.float32),
        "Label": np.array([2, 0, 1, 0, 1, 2], np.float32),
        "QueryID": np.array([0, 0, 0, 1, 1, 1])}),
    "anchor_generator": OpCase("anchor_generator", {
        "Input": np.zeros((1, 8, 2, 3), np.float32)},
        {"anchor_sizes": [32.0, 64.0], "aspect_ratios": [0.5, 1.0, 2.0],
         "stride": [16.0, 16.0]}),
    "histogram": OpCase("histogram", {"X": _misc_rnd((40,), 43)},
                        {"bins": 7, "min": -1, "max": 2}),
    "histogram_data_range": OpCase("histogram", {"X": _misc_rnd((30,), 44)},
                                   {"bins": 5}),
    "masked_select": OpCase("masked_select", {
        "X": _misc_rnd((3, 4), 45), "Mask": R(46).rand(3, 4) < 0.5}),
    "split_ids": OpCase("split_ids", {"Ids": MISC_IDS}, {"num_shards": 2}),
    "merge_ids": OpCase("merge_ids", {
        "Ids": MISC_IDS, "X": [np.array([0, 4]), np.array([3, 7, 1])],
        "Rows": [_misc_rnd((2, 2), 47), _misc_rnd((3, 2), 48)]}),
}


# -- the tail parity suite's own cases ----------------------------------------

def _tail_rnd(*shape, seed=0, scale=1.0):
    return (R(seed).randn(*shape) * scale).astype(np.float32)


def _tail_pos(*shape, seed=0, lo=0.5, hi=1.5):
    return R(seed).uniform(lo, hi, shape).astype(np.float32)


TAIL_SPD = (lambda a: (a @ a.T + 4 * np.eye(4)).astype(np.float32))(
    _tail_rnd(4, 4, seed=1))
TAIL_IMG = _tail_rnd(2, 3, 4, 5, seed=2)
TAIL_IDS = np.array([[[2, 2], [6, 1]], [[3, 9], [5, 1]], [[0, 1], [9, 0]]],
                    np.int64)
TAIL_PARENTS = np.array([[[0, 0], [1, 1]], [[1, 0], [0, 0]],
                         [[0, 0], [0, 1]]], np.int64)
# offsets off the integer grid: bilinear sampling has kinks there
TAIL_DCN = {"Input": _tail_rnd(1, 2, 5, 5, seed=3),
            "Offset": (R(4).uniform(-0.9, 0.9, (1, 18, 3, 3)) + 0.013)
            .astype(np.float32),
            "Mask": _tail_pos(1, 9, 3, 3, seed=5, lo=0.2, hi=1.0),
            "Filter": _tail_rnd(4, 2, 3, 3, seed=6, scale=0.5)}
TAIL_ROIS = np.array([[0.5, 0.5, 3.2, 2.7], [1.0, 0.0, 4.0, 3.5]],
                     np.float32)
TAIL_PROPOSALS = {
    "Scores": _tail_pos(1, 2, 3, 3, seed=7, lo=0.0, hi=1.0),
    "BboxDeltas": _tail_rnd(1, 8, 3, 3, seed=8, scale=0.3),
    "ImShape": np.array([[40.0, 48.0]], np.float32),
    "Anchors": np.concatenate([
        np.stack(np.meshgrid(np.arange(3) * 16.0, np.arange(3) * 16.0),
                 -1).reshape(9, 1, 2).repeat(2, 1).reshape(18, 2),
        np.stack(np.meshgrid(np.arange(3) * 16.0, np.arange(3) * 16.0),
                 -1).reshape(9, 1, 2).repeat(2, 1).reshape(18, 2)
        + np.tile([[15.0, 15.0], [23.0, 11.0]], (9, 1))],
        -1).astype(np.float32).reshape(3, 3, 2, 4),
    "Variances": np.ones((3, 3, 2, 4), np.float32)}
TAIL_INTERP = _tail_rnd(1, 2, 4, 5, seed=9)
TAIL_OWN = {
    **{op: OpCase(op, {"X": _tail_rnd(3, 4, seed=10)}) for op in (
        "expm1", "rad2deg", "deg2rad", "angle")},
    "lgamma": OpCase("lgamma", {"X": _tail_pos(3, 4, seed=11, lo=0.5,
                                               hi=4.0)}),
    "digamma": OpCase("digamma", {"X": _tail_pos(3, 4, seed=12, lo=0.5,
                                                 hi=4.0)}),
    "atan2": OpCase("atan2", {"X1": _tail_rnd(3, 4, seed=13),
                              "X2": _tail_rnd(3, 4, seed=14) + 2.0}),
    "nan_to_num": OpCase("nan_to_num", {"X": np.array(
        [[1.0, np.nan, np.inf, -np.inf]], np.float32)},
        {"nan": 0.5, "posinf": 9.0, "neginf": -9.0}),
    "logsumexp": OpCase("logsumexp", {"X": _tail_rnd(4, 6, seed=15)},
                        {"axis": [1], "keepdim": True}),
    "logsumexp_all": OpCase("logsumexp", {"X": _tail_rnd(2, 3, seed=16)},
                            {"reduce_all": True}),
    "logcumsumexp": OpCase("logcumsumexp", {"X": _tail_rnd(3, 5, seed=17)},
                           {"axis": 1}),
    "logcumsumexp_reverse": OpCase("logcumsumexp",
                                   {"X": _tail_rnd(3, 5, seed=18)},
                                   {"axis": 0, "reverse": True}),
    "cummax": OpCase("cummax", {"X": _tail_rnd(3, 6, seed=19)}, {"axis": 1}),
    "cummin": OpCase("cummin", {"X": _tail_rnd(4, 3, seed=20)}, {"axis": 0}),
    "cummax_ties": OpCase("cummax", {"X": np.array(
        [[1.0, 3.0, 3.0, 2.0, 3.0]], np.float32)}, {"axis": 1},
        skip_grad=True),
    "dist": OpCase("dist", {"X": _tail_rnd(3, 4, seed=21),
                            "Y": _tail_rnd(3, 4, seed=22)}, {"p": 3.0}),
    "dist_inf": OpCase("dist", {"X": _tail_rnd(3, 4, seed=21),
                                "Y": _tail_rnd(3, 4, seed=22)},
                       {"p": float("inf")}),
    "cosine_similarity": OpCase("cosine_similarity",
                                {"X": _tail_rnd(3, 5, seed=23),
                                 "Y": _tail_rnd(3, 5, seed=24)}),
    "pairwise_distance": OpCase("pairwise_distance",
                                {"X": _tail_rnd(3, 5, seed=25),
                                 "Y": _tail_rnd(3, 5, seed=26)},
                                {"keepdim": True}),
    "inverse": OpCase("inverse", {"Input": TAIL_SPD}),
    "trace": OpCase("trace", {"X": _tail_rnd(4, 5, seed=27)},
                    {"offset": 1}),
    "cross": OpCase("cross", {"X": _tail_rnd(4, 3, seed=28),
                              "Y": _tail_rnd(4, 3, seed=29)}),
    "multi_dot": OpCase("multi_dot", {"X": [
        _tail_rnd(2, 3, seed=30), _tail_rnd(3, 4, seed=31),
        _tail_rnd(4, 2, seed=32)]}),
    # not unique (signs, pivots): the tail suite holds these cases on
    # what is unique
    "qr": OpCase("qr", {"X": _tail_rnd(5, 3, seed=33)}),
    "svd": OpCase("svd", {"X": _tail_rnd(4, 3, seed=34)}),
    "eigh": OpCase("eigh", {"X": _tail_rnd(4, 4, seed=35)}),
    "eigh_upper": OpCase("eigh", {"X": _tail_rnd(4, 4, seed=36)},
                         {"UPLO": "U"}),
    "lu": OpCase("lu", {"X": _tail_rnd(4, 4, seed=37)}),
    "matrix_rank": OpCase("matrix_rank", {"X": (
        _tail_rnd(5, 2, seed=38) @ _tail_rnd(2, 4, seed=39))}),
    "matrix_rank_tol": OpCase("matrix_rank", {"X": np.diag(
        [3.0, 1.0, 0.05]).astype(np.float32)},
        {"use_default_tol": False, "tol": 0.1}),
    "take_along_axis": OpCase("take_along_axis", {
        "Input": _tail_rnd(3, 5, seed=40),
        "Index": np.array([[0, 2], [1, 1], [4, 0]], np.int64)},
        {"Axis": 1}),
    "put_along_axis": OpCase("put_along_axis", {
        "Input": _tail_rnd(3, 5, seed=41),
        "Index": np.array([[0, 2], [1, 3], [4, 0]], np.int64),
        "Value": _tail_rnd(3, 2, seed=42)}, {"Axis": 1}),
    "put_along_axis_add": OpCase("put_along_axis", {
        "Input": _tail_rnd(3, 5, seed=41),
        "Index": np.array([[0, 0], [1, 3], [4, 4]], np.int64),
        "Value": _tail_rnd(3, 2, seed=43)}, {"Axis": 1, "Reduce": "add"}),
    # the reference's scatter-multiply has no gradient (jax implements it
    # only for indices it is told are unique): outputs alone
    "put_along_axis_mul": OpCase("put_along_axis", {
        "Input": _tail_rnd(4, 3, seed=44),
        "Index": np.array([[0, 2, 1]], np.int64),
        "Value": _tail_rnd(1, 3, seed=45)}, {"Axis": 0,
                                            "Reduce": "multiply"},
        skip_grad=True),
    "broadcast_to": OpCase("broadcast_to", {"X": _tail_rnd(1, 4, seed=46)},
                           {"shape": [3, 4]}),
    "searchsorted": OpCase("searchsorted", {
        "SortedSequence": np.sort(_tail_rnd(8, seed=47)),
        "Values": _tail_rnd(5, seed=48)}, {"right": True}),
    "bucketize": OpCase("bucketize", {
        "SortedSequence": np.array([0.0, 1.0, 2.0], np.float32),
        "InputTensor": np.array([[-1.0, 0.5, 1.0], [2.0, 3.0, 1.5]],
                                np.float32)}, {"out_int32": True}),
    "bincount": OpCase("bincount", {"X": np.array([0, 1, 1, 3, 7])},
                       {"minlength": 5}),
    "bincount_weights": OpCase("bincount", {
        "X": np.array([0, 1, 1, 3]), "Weights": _tail_rnd(4, seed=49)}),
    "unique_consecutive": OpCase("unique_consecutive", {
        "X": np.array([1, 1, 2, 2, 2, 3, 1, 1], np.int64)}),
    "prelu": OpCase("prelu", {"X": _tail_rnd(2, 3, 2, 2, seed=50),
                              "Alpha": np.array([0.25], np.float32)}),
    "prelu_channel": OpCase("prelu", {
        "X": _tail_rnd(2, 3, 2, 2, seed=51),
        "Alpha": _tail_pos(3, seed=52, lo=0.1, hi=0.4)},
        {"mode": "channel"}),
    "prelu_element": OpCase("prelu", {
        "X": _tail_rnd(2, 3, 2, seed=53),
        "Alpha": _tail_pos(3, 2, seed=54, lo=0.1, hi=0.4)},
        {"mode": "element"}),
    "maxout": OpCase("maxout", {"X": _tail_rnd(2, 6, 2, 2, seed=55)},
                     {"groups": 2}),
    "pad3d": OpCase("pad3d", {"X": _tail_rnd(1, 2, 3, 4, 5, seed=56)},
                    {"paddings": [1, 1, 0, 2, 1, 0], "value": 0.5}),
    "pad3d_reflect": OpCase("pad3d", {"X": _tail_rnd(1, 2, 3, 4, 5,
                                                     seed=57)},
                            {"paddings": [1, 2, 1, 0, 2, 1],
                             "mode": "reflect"}),
    "pad3d_replicate_ndhwc": OpCase(
        "pad3d", {"X": _tail_rnd(1, 3, 4, 2, 2, seed=58)},
        {"paddings": [1, 0, 2, 1, 0, 1], "mode": "replicate",
         "data_format": "NDHWC"}),
    "pad3d_circular": OpCase("pad3d", {"X": _tail_rnd(1, 1, 3, 3, 4,
                                                      seed=59)},
                             {"paddings": [1, 1, 1, 1, 1, 1],
                              "mode": "circular"}),
    "gather_tree": OpCase("gather_tree", {"Ids": TAIL_IDS,
                                          "Parents": TAIL_PARENTS}),
    "fold": OpCase("fold", {"X": _tail_rnd(1, 18, 9, seed=60)},
                   {"output_sizes": [4, 4], "kernel_sizes": [3, 3],
                    "strides": [1, 1], "paddings": [1, 0, 0, 1]}),
    "affine_channel": OpCase("affine_channel", {
        "X": _tail_rnd(2, 3, 2, 2, seed=61), "Scale": _tail_rnd(3, seed=62),
        "Bias": _tail_rnd(3, seed=63)}),
    "space_to_depth": OpCase("space_to_depth",
                             {"X": _tail_rnd(2, 3, 4, 6, seed=64)},
                             {"blocksize": 2}),
    "spectral_norm": OpCase("spectral_norm", {
        "Weight": _tail_rnd(4, 3, 2, seed=65), "U": _tail_rnd(3, seed=66),
        "V": _tail_rnd(8, seed=67)}, {"dim": 1, "power_iters": 2}),
    "deformable_conv": OpCase("deformable_conv", TAIL_DCN,
                              {"paddings": [1, 1], "strides": [2, 2]}),
    "deformable_conv_nomask": OpCase(
        "deformable_conv", {k: v for k, v in TAIL_DCN.items()
                            if k != "Mask"},
        {"paddings": [1, 1], "strides": [2, 2]}),
    **{f"{m}_interp{v}": OpCase(f"{m}_interp{v}", {"X": TAIL_INTERP}, {
        "out_h": 7, "out_w": 3, "align_corners": ac, "align_mode": am})
       for m, v, ac, am in (("nearest", "", True, 1),
                            ("nearest", "_v2", False, 1),
                            ("bilinear", "", True, 1),
                            ("bilinear", "_v2", False, 0),
                            ("bicubic", "", True, 1),
                            ("bicubic", "_v2", False, 1))},
    "bilinear_interp_v2_asym": OpCase("bilinear_interp_v2",
                                      {"X": TAIL_INTERP},
                                      {"out_h": 6, "out_w": 9,
                                       "align_corners": False}),
    "nearest_interp_v2_scale": OpCase("nearest_interp_v2",
                                      {"X": TAIL_INTERP},
                                      {"scale": [2.0], "align_corners":
                                       False}),
    **{f"trilinear_interp{v}": OpCase(
        f"trilinear_interp{v}", {"X": _tail_rnd(1, 2, 3, 4, 3, seed=68)},
        {"out_d": 4, "out_h": 3, "out_w": 5, "align_corners": ac})
       for v, ac in (("", True), ("_v2", False))},
    "bilinear_interp_v2_outsize": OpCase(
        "bilinear_interp_v2", {"X": TAIL_INTERP,
                               "OutSize": np.array([5, 8], np.int32)},
        {"align_corners": False}, skip_grad=True),
    "sequence_conv": OpCase("sequence_conv", {
        "X": _tail_rnd(2, 5, 3, seed=69), "Filter": _tail_rnd(9, 4, seed=70),
        "SeqLen": np.array([5, 3])}, {"contextLength": 3,
                                      "contextStart": -1}),
    "sequence_slice": OpCase("sequence_slice", {
        "X": _tail_rnd(3, 5, 2, seed=71), "Offset": np.array([0, 2, 1]),
        "Length": np.array([3, 2, 4])}),
    "sequence_erase": OpCase("sequence_erase", {"X": np.array(
        [[1, 2, 3, 2, 5], [2, 2, 4, 0, 1]], np.int64)}, {"tokens": [2, 5]}),
    "sequence_enumerate": OpCase("sequence_enumerate", {"X": np.array(
        [[1, 2, 3, 4], [5, 6, 7, 8]], np.int64)},
        {"win_size": 3, "pad_value": -1}),
    "sequence_scatter": OpCase("sequence_scatter", {
        "X": _tail_rnd(2, 5, seed=72),
        "Ids": np.array([[0, 3], [4, 4]]),
        "Updates": _tail_rnd(2, 2, seed=73)}),
    "box_clip": OpCase("box_clip", {
        "Input": np.array([[[-2.0, 3.0, 50.0, 20.0], [5.0, -1.0, 9.0,
                                                       40.0]]],
                          np.float32),
        "ImInfo": np.array([[30.0, 45.0, 1.0]], np.float32)}),
    "polygon_box_transform": OpCase("polygon_box_transform", {
        "Input": _tail_rnd(1, 8, 2, 3, seed=74)}),
    "roi_pool": OpCase("roi_pool", {"X": _tail_rnd(1, 2, 5, 6, seed=75),
                                    "ROIs": TAIL_ROIS},
                       {"pooled_height": 2, "pooled_width": 3}),
    "psroi_pool": OpCase("psroi_pool", {"X": _tail_rnd(1, 8, 5, 6, seed=76),
                                        "ROIs": TAIL_ROIS},
                         {"output_channels": 2, "pooled_height": 2,
                          "pooled_width": 2}),
    "generate_proposals_v2": OpCase("generate_proposals_v2",
                                    TAIL_PROPOSALS,
                                    {"pre_nms_topN": 12,
                                     "post_nms_topN": 6, "nms_thresh": 0.5,
                                     "min_size": 2.0}),
    "generate_proposals": OpCase("generate_proposals", {
        **{k: v for k, v in TAIL_PROPOSALS.items() if k != "ImShape"},
        "ImInfo": np.array([[40.0, 48.0, 1.0]], np.float32)},
        {"pre_nms_topN": 10, "post_nms_topN": 8, "nms_thresh": 0.3,
         "pixel_offset": False}),
    "density_prior_box": OpCase("density_prior_box", {
        "Input": np.zeros((1, 4, 2, 3), np.float32),
        "Image": np.zeros((1, 3, 16, 24), np.float32)},
        {"densities": [2, 1], "fixed_sizes": [4.0, 8.0],
         "fixed_ratios": [1.0, 2.0], "clip": True}),
    "fill_constant_batch_size_like": OpCase(
        "fill_constant_batch_size_like",
        {"Input": np.zeros((3, 2), np.float32)},
        {"shape": [-1, 4], "value": 2.5}),
    "frame": OpCase("frame", {"X": _tail_rnd(2, 10, seed=77)},
                    {"frame_length": 4, "hop_length": 3}),
    "overlap_add": OpCase("overlap_add", {"X": _tail_rnd(2, 4, 3, seed=78)},
                          {"hop_length": 2}),
    "complex": OpCase("complex", {"X": _tail_rnd(2, 3, seed=79),
                                  "Y": _tail_rnd(2, 3, seed=80)}),
    "as_complex": OpCase("as_complex", {"X": _tail_rnd(3, 2, seed=81)}),
    "as_real": OpCase("as_real", {"X": (
        _tail_rnd(2, 3, seed=82) + 1j * _tail_rnd(2, 3, seed=83)).astype(
        np.complex64)}),
    "renorm": OpCase("renorm", {"X": _tail_rnd(4, 5, seed=84)},
                     {"p": 2.0, "axis": 0, "max_norm": 1.5}),
}


# -- what is unique of the decompositions' outputs ------------------------------
#
# QR's Q and R are unique up to the sign of each column of Q (and row of
# R); an SVD's singular values are unique and its vectors up to sign;
# eigh's eigenvalues are unique and its eigenvectors up to sign; LU with
# partial pivoting can pick another of equal candidates. So the parity
# tests and the card sweep compare these parts, each a numpy array.

def lu_product(lu, piv):
    """P L U of a packed LU factor and its 0-based row swaps: the input
    matrix, whatever pivots were picked."""
    n = lu.shape[0]
    low = np.tril(lu, -1) + np.eye(n, dtype=lu.dtype)
    perm = np.arange(n)
    for i, p in enumerate(piv):
        perm[[i, p]] = perm[[p, i]]
    a = np.empty_like(lu)
    a[perm] = low @ np.triu(lu)
    return a


def _qr_unique(o):
    q, r = o["Q"][0], o["R"][0]
    return {"QR": q @ r, "|Q|": np.abs(q), "|R|": np.abs(r)}


def _svd_unique(o):
    u, s, vh = o["U"][0], o["S"][0], o["VH"][0]
    return {"S": s, "|U|": np.abs(u), "|VH|": np.abs(vh), "USVH": u * s @ vh}


def _eigh_unique(o):
    w, v = o["Eigenvalues"][0], o["Eigenvectors"][0]
    return {"Eigenvalues": w, "|V|": np.abs(v), "VWVT": v * w @ v.T}


def _lu_unique(o):
    lu = o["Out"][0]
    return {"PLU": lu_product(lu, o["Pivots"][0]),
            "|det|": np.abs(np.prod(np.diag(lu)))}


# op type -> outputs ({slot: [numpy array]}) -> {part name: numpy array}
UNIQUE_PARTS = {"qr": _qr_unique, "svd": _svd_unique, "eigh": _eigh_unique,
                "lu": _lu_unique}
