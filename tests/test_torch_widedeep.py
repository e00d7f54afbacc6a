"""The port's wide&deep model (paddle_tpu_torch/models/wide_deep.py)
against the JAX package's, on the CPU: the seeded init bit for bit, the
forward and loss, and three train steps (dense Adam on every leaf, the
tables' untouched rows included) within 1e-5 relative.

Size: WideDeepConfig.tiny() (vocab 4096, 8 slots, embed 8, 4 dense
features, hidden 32-16), batch 64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import wide_deep as J
from paddle_tpu_torch.models import WideDeepConfig, WideDeepTrainStep
from paddle_tpu_torch.models import wide_deep as P

BATCH = 64
RTOL = ATOL = 1e-5


def _batch(cfg, rng):
    ids = rng.randint(0, cfg.vocab_size, (BATCH, cfg.num_slots))
    dense = rng.randn(BATCH, cfg.dense_dim).astype(np.float32)
    label = (ids[:, 0] % 2).astype(np.float32)[:, None]
    return ids, dense, label


def _named(tree):
    """name -> array of a JAX-layout wide&deep tree (numpy, jax or
    torch leaves)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]:
        out[jax.tree_util.keystr(path)] = np.asarray(
            leaf.detach().cpu() if isinstance(leaf, torch.Tensor) else leaf)
    return out


def test_init_is_bit_identical_to_jax():
    for cfg in (J.WideDeepConfig.tiny(),
                J.WideDeepConfig(vocab_size=2048)):
        want = _named(J.init_widedeep_params(cfg, seed=4))
        got = _named(P.init_widedeep_params(
            WideDeepConfig(**vars(cfg)), seed=4))
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_leaf_order_is_the_jax_flatten_order():
    tree = P.init_widedeep_params(WideDeepConfig.tiny())
    want = jax.tree_util.tree_leaves(tree)
    got = P._leaves(tree)
    assert len(got) == len(want) and all(a is b for a, b in zip(got, want))
    assert P._unflatten(tree, got)["mlp"][1]["w"] is tree["mlp"][1]["w"]


def test_forward_and_loss_match_jax():
    cfg = WideDeepConfig.tiny()
    tree = P.init_widedeep_params(cfg, seed=1)
    ids, dense, label = _batch(cfg, np.random.RandomState(2))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jz = np.asarray(J.widedeep_forward(jparams, jnp.asarray(ids),
                                       jnp.asarray(dense), cfg))
    jl = float(J.widedeep_loss(jparams, jnp.asarray(ids),
                               jnp.asarray(dense), jnp.asarray(label), cfg))
    params = P.params_from_numpy(tree)
    ti, td = torch.as_tensor(ids), torch.as_tensor(dense)
    z = P.widedeep_forward(params, ti, td, cfg)
    loss = P.widedeep_loss(params, ti, td, torch.as_tensor(label), cfg)
    assert z.shape == (BATCH, 1)
    np.testing.assert_allclose(z.numpy(), jz, rtol=RTOL, atol=ATOL)
    assert abs(float(loss) - jl) <= RTOL * abs(jl)


def _close(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _schedule(values, seen):
    it = iter(values)

    def lr():
        seen.append(next(it))
        return seen[-1]
    return lr


@pytest.mark.parametrize("lr", ["float", "callable"])
def test_three_train_steps_match_jax(lr):
    cfg = WideDeepConfig.tiny()
    lrs, seen = [3e-3, 2e-3, 1e-3], []
    jlr = _schedule(lrs, []) if lr == "callable" else 3e-3
    plr = _schedule(lrs, seen) if lr == "callable" else 3e-3
    jstep = J.WideDeepTrainStep(cfg, dp=1, mp=1, lr=jlr, seed=5,
                                devices=jax.devices()[:1])
    pstep = WideDeepTrainStep(cfg, lr=plr, seed=5, device="cpu")
    _close(_named(pstep.params), _named(jstep.params))
    rng = np.random.RandomState(7)
    touched = set()
    for _ in range(3):
        ids, dense, label = _batch(cfg, rng)
        jl = float(jstep(ids, dense, label))
        pl = float(pstep(ids, dense, label))
        assert abs(pl - jl) <= RTOL * abs(jl), (pl, jl)
        _close(_named(pstep.params), _named(jstep.params))
        _close(_named(pstep.opt_state), _named(jstep.opt_state))
        for a, b in zip(pstep._pows, jstep._pows):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7)
        last = set(ids.ravel().tolist())
        touched |= last
    # dense Adam: rows touched in an earlier step but not the last keep
    # moving and their moments keep decaying (a lazy update would freeze
    # them); rows never touched stay put
    earlier = sorted(touched - last)
    assert earlier
    m1 = pstep.opt_state["embed"]["m1"].numpy()
    assert np.all(np.abs(m1[earlier]).sum(1) > 0)
    start = P.init_widedeep_params(cfg, seed=5)["embed"]
    moved = pstep.params["embed"].numpy()
    assert np.all((moved[earlier] != start[earlier]).any(1))
    never = sorted(set(range(cfg.vocab_size)) - touched)
    np.testing.assert_array_equal(moved[never], start[never])
    assert seen == (lrs if lr == "callable" else [])


def test_inputs_may_be_tensors_and_loss_falls():
    cfg = WideDeepConfig.tiny()
    step = WideDeepTrainStep(cfg, lr=1e-2, device="cpu")
    ids, dense, label = _batch(cfg, np.random.RandomState(0))
    args = (torch.as_tensor(ids), torch.as_tensor(dense),
            torch.as_tensor(label))
    losses = [float(step(*args)) for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("kw", [dict(mp=2), dict(dp=2), dict(mesh=object())])
def test_mesh_raises_naming_item_14(kw):
    with pytest.raises(NotImplementedError, match="item 14"):
        WideDeepTrainStep(WideDeepConfig.tiny(), device="cpu", **kw)


def test_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WideDeepTrainStep(WideDeepConfig.tiny())
