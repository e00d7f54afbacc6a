"""Replayable sampling in the port (paddle_tpu_torch/serving/
sampling.py): the Philox uniform is bit-equal to the JAX package's
stream (int64 lanes with the 16-bit product split), and sample_tokens
picks the same tokens as JAX's for the same logits — greedy, top-k,
top-p and mixed slots."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.serving import sampling as jsamp
from paddle_tpu_torch.serving import sampling as port

SEEDS = (0, 1, 12345, 2 ** 32 - 1, 2 ** 32, 2 ** 62, 2 ** 63,
         2 ** 63 + 11, 2 ** 64 - 1)


def test_philox_matches_random123_reference_vector():
    z = torch.zeros((), dtype=torch.int64)
    assert int(port._philox4(z, z, z, z, z, z)) == 0x6627E8D5


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bit_equal_to_jax_host_stream(seed):
    for step in (0, 1, 2, 7, 999, 4096, 2 ** 31 - 1):
        assert port.philox_uniform_host(seed, step) \
            == jsamp.philox_uniform_host(seed, step), (seed, step)


def test_uniform_batched_equals_jax_device_stream():
    seeds = np.stack([jsamp.seed_to_key(s) for s in SEEDS])
    steps = np.arange(len(SEEDS), dtype=np.int32) * 97
    want = np.asarray(jsamp._uniform(jnp, jnp.asarray(seeds),
                                     jnp.asarray(steps)))
    got = port.uniform(torch.from_numpy(seeds.astype(np.int64)),
                       torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_seed_to_key_and_derive_seed_match(seed):
    np.testing.assert_array_equal(port.seed_to_key(seed),
                                  jsamp.seed_to_key(seed))
    assert port.derive_seed(f"req-{seed}") \
        == jsamp.derive_seed(f"req-{seed}")


def test_sampling_params_validation():
    for bad in (dict(temperature=-0.1), dict(top_k=-1), dict(top_p=0.0),
                dict(top_p=1.5)):
        with pytest.raises(ValueError):
            port.SamplingParams(**bad)
    sp = port.SamplingParams(temperature=0.7, top_k=4, top_p=0.9, seed=9)
    assert (sp.temperature, sp.top_k, sp.top_p, sp.seed) == (0.7, 4, 0.9, 9)


def _cases():
    S = 6
    return {
        "greedy": ([0.0] * S, [0] * S, [1.0] * S),
        "top_k": ([0.8] * S, [1, 2, 4, 8, 16, 0], [1.0] * S),
        "top_p": ([1.0] * S, [0] * S, [0.1, 0.3, 0.5, 0.7, 0.9, 1.0]),
        "mixed": ([0.0, 0.5, 1.3, 0.9, 0.0, 2.0], [0, 8, 0, 3, 5, 40],
                  [1.0, 0.9, 0.6, 1.0, 0.2, 0.95]),
    }


@pytest.mark.parametrize("case", ["greedy", "top_k", "top_p", "mixed"])
@pytest.mark.parametrize("data_seed", [0, 1, 2])
def test_sample_tokens_match_jax(case, data_seed):
    rng = np.random.RandomState(data_seed)
    S, V = 6, 97
    logits = (rng.randn(S, V) * 2).astype(np.float32)
    temps, topks, topps = (np.asarray(a) for a in _cases()[case])
    temps, topks, topps = (temps.astype(np.float32),
                           topks.astype(np.int32), topps.astype(np.float32))
    seeds = np.stack([jsamp.seed_to_key(1000 * data_seed + i + 2 ** 63)
                      for i in range(S)])
    for step_base in (0, 11):
        want = np.asarray(jsamp.sample_tokens(
            jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(topks),
            jnp.asarray(topps), jnp.asarray(seeds),
            jnp.arange(S, dtype=jnp.int32) + step_base))
        got = port.sample_tokens(
            torch.from_numpy(logits), torch.from_numpy(temps),
            torch.from_numpy(topks), torch.from_numpy(topps),
            torch.from_numpy(seeds.astype(np.int64)),
            torch.arange(S, dtype=torch.int32) + step_base).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    if case == "greedy":
        np.testing.assert_array_equal(got, logits.argmax(-1))


def test_greedy_ties_pick_the_first_maximum():
    logits = torch.zeros(2, 16)
    logits[0, [3, 9]] = 5.0
    logits[1, [0, 15]] = 1.0
    z = torch.zeros(2)
    out = port.sample_tokens(logits, z, torch.zeros(2, dtype=torch.int32),
                             torch.ones(2), torch.zeros(2, 2,
                                                        dtype=torch.int64),
                             torch.zeros(2, dtype=torch.int32))
    assert out.tolist() == [3, 0]
