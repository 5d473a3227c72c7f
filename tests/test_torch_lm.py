"""The port's RWKV-6 LM serving path against the JAX package's, on the same
numpy inputs and parameters.

Parameters come from the JAX package's own init on rwkv6-3b SMOKE (2 layers,
d_model 64, 4 heads of 16, vocab 256, f32), with seeded numpy noise added to
every leaf so that the zero-initialised mixes and LoRAs take part, and are
carried over with `convert.lm_params_from_jax`.  Tolerance rtol = atol =
1e-4 on activations, states and logits: both sides compute in f32, the
recurrence in chunks summed in another order (its own parity test holds
2e-4 on unit-scale inputs; here the outputs are smaller).  Greedy tokens
must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import rwkv6 as jrw
from repro.models import transformer as jtfm
from repro.models.kv_cache import cache_init as jax_cache_init
from repro.models.zoo import build as jax_build
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_arch, list_archs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import rwkv6 as rw
from repro_torch.models import transformer as tfm
from repro_torch.models.kv_cache import cache_init
from repro_torch.models.zoo import build
from repro_torch.serve.engine import Request, ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
JCFG = jax_get_arch("rwkv6-3b").smoke
CFG = get_arch("rwkv6-3b").smoke


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), tree)


@pytest.fixture(scope="module")
def jax_params():
    """JAX init + seeded noise (0.05 on every leaf), as numpy."""
    params = _np_tree(jtfm.init_params(JCFG, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        params)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return lm_params_from_jax(jax_params, CFG)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, dtype=np.float32), **TOL,
                               err_msg=what)


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree["layers"][0])


def test_config_transcribed_from_jax():
    full, jfull = get_arch("rwkv6-3b").config, jax_get_arch("rwkv6-3b").config
    for f in dataclasses.fields(full):
        if f.name != "dtype":
            assert getattr(full, f.name) == getattr(jfull, f.name), f.name
    assert full.dtype == torch.bfloat16 and CFG.dtype == torch.float32
    assert (CFG.n_layers, CFG.d_model, CFG.rwkv_head_dim, CFG.vocab) == (
        JCFG.n_layers, JCFG.d_model, JCFG.rwkv_head_dim, JCFG.vocab)
    assert {"rwkv6-3b", "mixtral-8x22b"} <= set(list_archs())
    assert get_arch("mixtral-8x22b").config.n_experts == 8
    with pytest.raises(KeyError):
        get_arch("gpt-2")
    # as in the JAX package, only the attention blocks of a hybrid take
    # the MoE FFN; its RWKV-6 blocks keep their channel mix
    params = build(CFG.with_(pattern=("rwkv6", "attn"), n_experts=4)).init(
        0, device="cpu")
    assert [sorted(p) for p in params["layers"]] == [
        ["norm1", "norm2", "rwkv"], ["attn", "moe", "norm1", "norm2"]]


def test_init_params_match_jax_tree(jax_params, port_params):
    mine = tfm.init_params(CFG, seed=0, device="cpu")
    flat = lambda t: {k: tuple(v.shape) for k, v in _flatten(t)}
    assert flat(mine) == flat(port_params)
    assert len(mine["layers"]) == CFG.n_layers
    # the stacked JAX leaves come apart layer by layer
    for i in range(CFG.n_layers):
        np.testing.assert_array_equal(
            port_params["layers"][i]["rwkv"]["wr"]["w"].numpy(),
            jax_params["layers"][0]["rwkv"]["wr"]["w"][i])


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_cache_init_matches_jax_layout():
    mine = cache_init(CFG, 3, 64, "cpu")
    ref = jax_cache_init(JCFG, 3, 64)
    assert len(mine["layers"]) == CFG.n_layers
    for i, entry in enumerate(mine["layers"]):
        for name, t in entry.items():
            want = ref["layers"][0][name][i]
            assert tuple(t.shape) == want.shape, name
            assert str(t.dtype).split(".")[-1] == str(want.dtype), name
    assert tuple(mine["pos"].shape) == ref["pos"].shape


@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "carried"])
def test_time_and_channel_mix_match_jax(jax_params, port_params, carry):
    rng = np.random.default_rng(1)
    B, T, d, hd = 2, 37, CFG.d_model, CFG.rwkv_head_dim
    H = d // hd
    x = rng.normal(size=(B, T, d)).astype(np.float32)
    last = rng.normal(size=(B, d)).astype(np.float32) if carry else None
    state = (0.1 * rng.normal(size=(B, H, hd, hd))).astype(np.float32) \
        if carry else None
    jp = _layer(jax_params, 1)["rwkv"]
    tp = port_params["layers"][1]["rwkv"]
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.from_numpy(a)
    jy, (jlast, jstate) = jrw.rwkv6_time_mix(
        jp, j(x), head_dim=hd, last_x=j(last), state=j(state), chunk=16)
    y, (nlast, nstate) = rw.rwkv6_time_mix(
        tp, t(x), head_dim=hd, last_x=t(last), state=t(state), chunk=16)
    _close(y, jy, "time mix y")
    _close(nlast, jlast, "time mix last")
    _close(nstate, jstate, "time mix state")
    jy, jlast = jrw.rwkv6_channel_mix(jp, j(x), last_x=j(last))
    y, nlast = rw.rwkv6_channel_mix(tp, t(x), last_x=t(last))
    _close(y, jy, "channel mix y")
    _close(nlast, jlast, "channel mix last")


def test_decode_functions_match_jax(jax_params, port_params):
    rng = np.random.default_rng(2)
    B, d, hd = 3, CFG.d_model, CFG.rwkv_head_dim
    H = d // hd
    x1, last, last2 = (rng.normal(size=(B, d)).astype(np.float32)
                       for _ in range(3))
    state = (0.1 * rng.normal(size=(B, H, hd, hd))).astype(np.float32)
    jp = _layer(jax_params, 0)["rwkv"]
    tp = port_params["layers"][0]["rwkv"]
    jy, jlast, jstate = jrw.rwkv6_time_mix_decode(
        jp, jnp.asarray(x1), jnp.asarray(last), jnp.asarray(state),
        head_dim=hd)
    y, nlast, nstate = rw.rwkv6_time_mix_decode(
        tp, torch.from_numpy(x1), torch.from_numpy(last),
        torch.from_numpy(state), head_dim=hd)
    _close(y, jy, "decode time mix y")
    _close(nlast, jlast, "decode time mix last")
    _close(nstate, jstate, "decode time mix state")
    jy, jlast = jrw.rwkv6_channel_mix_decode(jp, jnp.asarray(x1),
                                             jnp.asarray(last2))
    y, nlast = rw.rwkv6_channel_mix_decode(tp, torch.from_numpy(x1),
                                           torch.from_numpy(last2))
    _close(y, jy, "decode channel mix y")
    _close(nlast, jlast, "decode channel mix last")


def test_prefill_and_decode_steps_match_jax(jax_params, port_params):
    """rwkv6-3b SMOKE has 2 layers, so JAX takes its lax.scan path over
    cycles; the port loops over its per-layer list."""
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, CFG.vocab, size=(2, 29)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, jax_params)
    jcache, jlogits = jtfm.prefill(JCFG, jparams, jnp.asarray(tokens), 64)
    cache, logits = tfm.prefill(CFG, port_params, torch.from_numpy(tokens),
                                64)
    assert logits.dtype == torch.float32 and logits.shape == (2, CFG.vocab)
    _close(logits, jlogits, "prefill logits")
    for step in range(7):
        for i, entry in enumerate(cache["layers"]):
            for name, t in entry.items():
                _close(t, jcache["layers"][0][name][i],
                       f"step {step} layer {i} {name}")
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        if step == 6:
            break
        nxt = np.array(jnp.argmax(jlogits, axis=-1), dtype=np.int32)
        assert torch.argmax(logits, -1).tolist() == nxt.tolist(), step
        jcache, jlogits = jtfm.decode_step(JCFG, jparams, jcache,
                                           jnp.asarray(nxt))
        cache, logits = tfm.decode_step(CFG, port_params, cache,
                                        torch.from_numpy(nxt))
        _close(logits, jlogits, f"decode step {step + 1} logits")


def _engines(jax_params, port_params, slots):
    jeng = JaxServeEngine(jax_build(JCFG), slots=slots, max_len=64)
    jeng.load(jax.tree.map(jnp.asarray, jax_params))
    eng = ServeEngine(build(CFG), slots=slots, max_len=64, device="cpu")
    eng.load(port_params)
    return jeng, eng


def _run(engine, make, prompts, n_new):
    reqs = [make(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, n_new))]
    done = engine.generate(reqs)
    return {r.rid: r.generated for r in done}


@pytest.mark.parametrize("case", ["two-prompts", "continuous-admission"])
def test_engine_greedy_tokens_match_jax(jax_params, port_params, case):
    if case == "two-prompts":      # tests/test_serve.py's prompts
        prompts = [np.arange(5, 13, dtype=np.int32),
                   np.arange(40, 44, dtype=np.int32)]
        n_new = [6, 6]
    else:                          # more requests than slots
        prompts = [np.arange(3 + i, dtype=np.int32) + 1 for i in range(5)]
        n_new = [3 + i % 2 for i in range(5)]
    jeng, eng = _engines(jax_params, port_params, slots=2)
    want = _run(jeng, JaxRequest, prompts, n_new)
    got = _run(eng, Request, prompts, n_new)
    assert sorted(got) == list(range(len(prompts)))
    assert got == want
    assert all(len(got[i]) == n for i, n in enumerate(n_new))
    assert not eng.active and len(eng.free_slots()) == 2


def test_sampling_is_deterministic_under_a_seed(port_params):
    def sample(seed):
        eng = ServeEngine(build(CFG), slots=2, max_len=64, seed=seed,
                          device="cpu")
        eng.load(port_params)
        reqs = [Request(rid=i, prompt=np.arange(4 + i, dtype=np.int32),
                        max_new_tokens=8, temperature=1.0) for i in range(3)]
        return {r.rid: r.generated for r in eng.generate(reqs)}
    first, again = sample(11), sample(11)
    assert first == again
    assert all(len(t) == 8 and all(0 <= x < CFG.vocab for x in t)
               for t in first.values())
