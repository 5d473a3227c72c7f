"""The port's checkpoints: atomicity, bit-exact round trip, async, GC,
device restore, and one directory layout with the JAX package.

Mirrors tests/test_checkpoint.py; the elastic case restores onto
`device="cpu"`.  The cross-package cases write a tree with one package's
`save` and restore it with the other's, every leaf bit for bit: nested
dicts and lists, a NamedTuple (the optimizer's `AdamState`), and a
bfloat16 leaf stored as its uint16 bits.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jax_ckpt
from repro.train.optimizer import AdamState as JaxAdamState
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamState


def _tree(seed):
    gen = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 16), generator=gen),
                   "b16": torch.randn((4,), generator=gen).to(
                       torch.bfloat16)},
        "step": torch.tensor(7, dtype=torch.int32),
        "nested": [torch.arange(5), {"x": torch.ones((2, 2))}],
        "opt": AdamState(step=torch.tensor(3, dtype=torch.int32),
                         mu={"a": torch.randn((3,), generator=gen)},
                         nu={"a": torch.rand((3,), generator=gen)}),
    }


def _leaves(tree):
    return ckpt.tree_flatten(tree)[0]


def _assert_same(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu(), b.cpu())


def test_roundtrip_bit_exact(tmp_path):
    tree = _tree(0)
    ckpt.save(tmp_path, 7, tree)
    assert ckpt.latest_step(tmp_path) == 7
    restored = ckpt.restore(tmp_path, 7, tree)
    assert isinstance(restored["opt"], AdamState)
    assert isinstance(restored["params"]["w"], np.ndarray)
    assert restored["params"]["b16"].dtype == torch.bfloat16
    _assert_same(restored, tree)


def test_restore_structure_mismatch_raises_value_error(tmp_path):
    """Config drift between writer and restorer must be a catchable error,
    not an assert."""
    tree = _tree(3)
    ckpt.save(tmp_path, 1, tree)
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(tmp_path, 1, {"only": torch.zeros((2,))})
    wrong = ckpt.tree_unflatten(tree, [torch.zeros((3,) + tuple(a.shape))
                                       for a in _leaves(tree)])
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(tmp_path, 1, wrong)


def test_torn_checkpoint_ignored(tmp_path):
    ckpt.save(tmp_path, 10, _tree(1))
    # a crash mid-write of step 20: a directory without COMMIT
    torn = tmp_path / "step_00000020"
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    assert ckpt.latest_step(tmp_path) == 10


def test_async_save_and_gc(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path, keep=2, save_every=5)
    tree = _tree(2)
    for step in [5, 10, 15]:
        assert mgr.maybe_save(step, tree)
    assert not mgr.maybe_save(16, tree)      # not on the cadence
    mgr.wait()
    assert ckpt.latest_step(tmp_path) == 15
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert len(kept) <= 2                     # GC keeps the last 2
    step, restored = mgr.restore_latest(tree)
    assert step == 15
    _assert_same(restored, tree)


def test_async_save_copies_before_returning(tmp_path):
    """The host copy is taken on the caller's thread: mutating a CPU tensor
    in place right after `save_async` does not reach the checkpoint."""
    tree = {"w": torch.zeros((64, 64))}
    writer = ckpt.save_async(tmp_path, 1, tree)
    tree["w"].add_(1.0)
    writer.join()
    restored = ckpt.restore(tmp_path, 1, tree)
    assert float(np.abs(restored["w"]).max()) == 0.0


def test_elastic_restore_onto_a_device(tmp_path):
    """Leaves are stored as host arrays and restored onto whatever device
    the caller names (here the CPU; the card in production)."""
    tree = {"w": torch.arange(32, dtype=torch.float32).reshape(8, 4)}
    ckpt.save(tmp_path, 1, tree)
    restored = ckpt.restore(tmp_path, 1, tree, device="cpu")
    assert isinstance(restored["w"], torch.Tensor)
    assert restored["w"].device == torch.device("cpu")
    assert torch.equal(restored["w"], tree["w"])


# --------------------------------------------------------------------------- #
# one layout, two packages
# --------------------------------------------------------------------------- #
def _jax_tree(key):
    k1, k2, k3 = jax.random.split(key, 3)
    return {
        "params": {"w": jax.random.normal(k1, (8, 16), jnp.float32),
                   "b16": jax.random.normal(k2, (4,), jnp.bfloat16)},
        "step": jnp.asarray(7, jnp.int32),
        "nested": [jnp.arange(5), {"x": jnp.ones((2, 2))}],
        "opt": JaxAdamState(step=jnp.asarray(3, jnp.int32),
                            mu={"a": jax.random.normal(k3, (3,))},
                            nu={"a": jnp.full((3,), 0.5)}),
    }


def _like_port(jtree):
    """The port's tree of the same structure (AdamState -> the port's)."""
    def conv(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(
            torch.bfloat16) if x.dtype == jnp.bfloat16 else \
            torch.from_numpy(np.array(x))
    opt = jtree["opt"]
    return {"params": {k: conv(v) for k, v in jtree["params"].items()},
            "step": conv(jtree["step"]),
            "nested": [conv(jtree["nested"][0]),
                       {"x": conv(jtree["nested"][1]["x"])}],
            "opt": AdamState(conv(opt.step), {"a": conv(opt.mu["a"])},
                             {"a": conv(opt.nu["a"])})}


def test_jax_written_checkpoint_restores_into_the_port(tmp_path):
    jtree = _jax_tree(jax.random.PRNGKey(5))
    jax_ckpt.save(tmp_path, 3, jtree)
    want = _like_port(jtree)
    restored = ckpt.restore(tmp_path, 3, want)
    _assert_same(restored, want)
    on_cpu = ckpt.restore(tmp_path, 3, want, device="cpu")
    _assert_same(on_cpu, want)
    # the port names every leaf as JAX's checkpoint does
    assert ckpt.tree_flatten(want)[1] == jax_ckpt._tree_paths(jtree)


def test_port_written_checkpoint_restores_into_jax(tmp_path):
    jtree = _jax_tree(jax.random.PRNGKey(6))
    tree = _like_port(jtree)
    ckpt.save(tmp_path, 4, tree)
    restored = jax_ckpt.restore(tmp_path, 4, jax.eval_shape(lambda: jtree))
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
