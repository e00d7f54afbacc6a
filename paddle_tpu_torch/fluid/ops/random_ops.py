"""Random ops (counterpart of ``paddle_tpu/fluid/ops/random_ops.py``):
the startup program's initialisers (gaussian, uniform, truncated
gaussian) and randint, randperm, bernoulli, multinomial, sampling_id
and seed.

The reference folds (step key, the op's ``_rng_id``) into a jax.random
key; the port draws from a ``torch.Generator`` on the executor's device
seeded with the int32 ``ExecContext.rng`` hashes from (run seed,
``_rng_id``). Same structure, same distribution, other numbers: the
two packages' random values agree in distribution only.
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


def _uniform_01(ctx, attrs, shape, dtype):
    return torch.rand(shape, generator=ctx.generator(attrs),
                      device=ctx.device, dtype=dtype)


@register("gaussian_random", grad=None, stochastic=True,
          infer_shape=_rand_infer,
          attrs={"shape": [], "mean": 0.0, "std": 1.0, "seed": 0,
                 "dtype": "float32"})
def _gaussian(ctx, ins, attrs):
    r = torch.randn(_shape_from(ins, attrs), generator=ctx.generator(attrs),
                    device=ctx.device, dtype=torch_dtype(attrs["dtype"]))
    return out(r * attrs["std"] + attrs["mean"])


def _uniform(ctx, attrs, shape):
    u = _uniform_01(ctx, attrs, shape, torch_dtype(attrs["dtype"]))
    return out(attrs["min"] + (attrs["max"] - attrs["min"]) * u)


_UNIFORM_ATTRS = {"shape": [], "min": -1.0, "max": 1.0, "seed": 0,
                  "dtype": "float32"}
register("uniform_random", lambda ctx, ins, attrs: _uniform(
    ctx, attrs, _shape_from(ins, attrs)), grad=None, stochastic=True,
    infer_shape=_rand_infer, attrs=dict(_UNIFORM_ATTRS))


@register("uniform_random_batch_size_like", grad=None, stochastic=True,
          attrs=dict(_UNIFORM_ATTRS, input_dim_idx=0, output_dim_idx=0))
def _uniform_bsl(ctx, ins, attrs):
    shape = list(attrs["shape"])
    shape[attrs["output_dim_idx"]] = \
        x(ins, "Input").shape[attrs["input_dim_idx"]]
    return _uniform(ctx, attrs, shape)


@register("truncated_gaussian_random", grad=None, stochastic=True,
          infer_shape=_rand_infer,
          attrs={"shape": [], "mean": 0.0, "std": 1.0, "seed": 0,
                 "dtype": "float32"})
def _trunc_gaussian(ctx, ins, attrs):
    """A standard normal truncated to [-2, 2] (the reference's bounds),
    by the inverse CDF of a uniform draw, then scaled and shifted."""
    dtype = torch_dtype(attrs["dtype"])
    u = _uniform_01(ctx, attrs, list(attrs["shape"]), torch.float32)
    lo = torch.special.ndtr(torch.tensor(-2.0, device=ctx.device))
    r = torch.special.ndtri(lo + (1.0 - 2.0 * lo) * u).clamp(-2.0, 2.0)
    return out((r * attrs["std"] + attrs["mean"]).to(dtype))


@register("randint", grad=None, stochastic=True, infer_shape=_rand_infer,
          attrs={"shape": [], "low": 0, "high": 100, "seed": 0,
                 "dtype": "int64"})
def _randint(ctx, ins, attrs):
    return out(torch.randint(attrs["low"], attrs["high"],
                             _shape_from(ins, attrs),
                             generator=ctx.generator(attrs),
                             device=ctx.device,
                             dtype=torch_dtype(attrs["dtype"])))


@register("randperm", grad=None, stochastic=True,
          attrs={"n": 0, "seed": 0, "dtype": "int64"})
def _randperm(ctx, ins, attrs):
    return out(torch.randperm(attrs["n"], generator=ctx.generator(attrs),
                              device=ctx.device,
                              dtype=torch_dtype(attrs["dtype"])))


@register("bernoulli", grad=None, stochastic=True)
def _bernoulli(ctx, ins, attrs):
    v = x(ins)
    u = _uniform_01(ctx, attrs, list(v.shape), v.dtype)
    return out((u < v).to(v.dtype))


@register("multinomial", grad=None, stochastic=True,
          attrs={"num_samples": 1, "replacement": False})
def _multinomial(ctx, ins, attrs):
    v = x(ins)
    probs = v.reshape(-1, v.shape[-1]).float()
    r = torch.multinomial(probs, attrs["num_samples"],
                          replacement=bool(attrs.get("replacement", False)),
                          generator=ctx.generator(attrs))
    return out(r.reshape(tuple(v.shape[:-1]) + (attrs["num_samples"],)))


@register("sampling_id", grad=None, stochastic=True,
          attrs={"min": 0.0, "max": 1.0, "seed": 0})
def _sampling_id(ctx, ins, attrs):
    v = x(ins)
    probs = v.reshape(-1, v.shape[-1]).float()
    r = torch.multinomial(probs, 1, generator=ctx.generator(attrs))
    return out(r.reshape(v.shape[:-1]))


@register("seed", grad=None, attrs={"seed": 0})
def _seed(ctx, ins, attrs):
    return out(torch.tensor([attrs["seed"]], dtype=torch.int32,
                            device=ctx.device))
