"""Random ops (counterpart of ``paddle_tpu/fluid/ops/random_ops.py``):
gaussian_random and uniform_random, the startup program's initialisers.

The reference folds (step key, the op's ``_rng_id``) into a jax.random
key; the port draws from a ``torch.Generator`` on the executor's device
seeded with the int32 ``ExecContext.rng`` hashes from (run seed,
``_rng_id``). Same structure, same distribution, other numbers: the
two packages' startup values agree in distribution only.
"""
from __future__ import annotations

import torch

from ..core import torch_dtype
from ..registry import register
from .common import out, x


def _shape_from(ins, attrs):
    st = x(ins, "ShapeTensor")
    if st is not None:
        return [int(s) for s in st.tolist()]
    return list(attrs.get("shape", []))


def _rand_infer(op):
    shape = tuple(op.attr("shape", []))
    for name in op.output("Out"):
        op.block.create_var(name=name, shape=shape,
                            dtype=op.attr("dtype", "float32"))


@register("gaussian_random", grad=None, stochastic=True,
          infer_shape=_rand_infer,
          attrs={"shape": [], "mean": 0.0, "std": 1.0, "seed": 0,
                 "dtype": "float32"})
def _gaussian(ctx, ins, attrs):
    r = torch.randn(_shape_from(ins, attrs), generator=ctx.generator(attrs),
                    device=ctx.device, dtype=torch_dtype(attrs["dtype"]))
    return out(r * attrs["std"] + attrs["mean"])


@register("uniform_random", grad=None, stochastic=True,
          infer_shape=_rand_infer,
          attrs={"shape": [], "min": -1.0, "max": 1.0, "seed": 0,
                 "dtype": "float32"})
def _uniform(ctx, ins, attrs):
    u = torch.rand(_shape_from(ins, attrs), generator=ctx.generator(attrs),
                   device=ctx.device, dtype=torch_dtype(attrs["dtype"]))
    return out(attrs["min"] + (attrs["max"] - attrs["min"]) * u)
