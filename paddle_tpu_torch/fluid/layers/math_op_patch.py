"""Static-graph Variable operator sugar (counterpart of
``paddle_tpu/fluid/layers/math_op_patch.py``): arithmetic and comparison
dunders append the corresponding elementwise/compare ops to the current
program, so `h * 2 + b`, `x / y`, `x ** 2`, `-x` and `mean(x) > 0`
build graphs (elementwise_div / _pow / _mod / _floordiv, scale and the
comparison ops).
"""
from __future__ import annotations

__all__ = ["monkey_patch_variable"]


def _scalar_var(value, ref_dtype):
    from .tensor import fill_constant
    dt = ref_dtype or "float32"
    if str(dt).startswith(("int", "uint")) and \
            float(value) != int(value):
        dt = "float32"
    return fill_constant([1], dt, float(value))


def _binary(op_type, reverse=False, out_dtype=None):
    def impl(self, other):
        from ..framework import Variable
        from ..layer_helper import LayerHelper
        if not isinstance(other, Variable):
            if not isinstance(other, (int, float, bool)):
                return NotImplemented
            other = _scalar_var(other, self.dtype)
        a, b = (other, self) if reverse else (self, other)
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference(
            out_dtype or a.dtype or b.dtype or "float32")
        helper.append_op(type=op_type, inputs={"X": [a], "Y": [b]},
                         outputs={"Out": [out]}, attrs={"axis": -1})
        return out
    return impl


def _unary_scale(scale, bias):
    def impl(self):
        from ..layer_helper import LayerHelper
        helper = LayerHelper("scale")
        out = helper.create_variable_for_type_inference(self.dtype)
        helper.append_op(type="scale", inputs={"X": [self]},
                         outputs={"Out": [out]},
                         attrs={"scale": float(scale),
                                "bias": float(bias),
                                "bias_after_scale": True})
        return out
    return impl


def monkey_patch_variable():
    from ..framework import Variable
    patches = {
        "__add__": _binary("elementwise_add"),
        "__radd__": _binary("elementwise_add", reverse=True),
        "__sub__": _binary("elementwise_sub"),
        "__rsub__": _binary("elementwise_sub", reverse=True),
        "__mul__": _binary("elementwise_mul"),
        "__rmul__": _binary("elementwise_mul", reverse=True),
        "__truediv__": _binary("elementwise_div"),
        "__rtruediv__": _binary("elementwise_div", reverse=True),
        "__pow__": _binary("elementwise_pow"),
        "__mod__": _binary("elementwise_mod"),
        "__floordiv__": _binary("elementwise_floordiv"),
        "__neg__": _unary_scale(-1.0, 0.0),
        "__gt__": _binary("greater_than", out_dtype="bool"),
        "__ge__": _binary("greater_equal", out_dtype="bool"),
        "__lt__": _binary("less_than", out_dtype="bool"),
        "__le__": _binary("less_equal", out_dtype="bool"),
        # NOTE: __eq__/__ne__ stay identity-based — Variables are hashed
        # as graph nodes all over the framework (the reference makes the
        # same call; layers.equal is the elementwise form)
    }
    for name, fn in patches.items():
        setattr(Variable, name, fn)
