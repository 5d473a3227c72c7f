"""The port's LM zoo against the JAX package's, for the six architectures of
the attention and Mamba-2 slice (SMOKE configs), on the same numpy inputs
and parameters.

Parameters come from the JAX package's own init, with seeded numpy noise
(0.05) added to every leaf so that zero-initialised biases and unit norms
take part, and are carried over with `convert.lm_params_from_jax`.  Besides
the six SMOKE configs, zamba2's SMOKE at 10 layers has a 1-layer tail, so
the shared block also runs before the tail (4 invocations).  Every case:
the config transcribed field for field; the converted tree's shapes equal
the port's own init; the cache layout equals JAX's modulo the stacking;
prefill and 6 decode steps (logits and every cache leaf); `forward`;
decode against forward.  The `ServeEngine`'s greedy tokens against JAX's
engine are in tests/test_torch_zoo_serve.py.  Tolerance rtol = atol =
1e-4 in f32 (sums in another order; measured differences are below
1e-5).  Greedy tokens must be equal.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import transformer as jtfm
from repro.models.kv_cache import cache_init as jax_cache_init
from repro.models.layers import embed_lookup as jax_embed_lookup
from repro_torch.configs import PORTED, get_arch
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import transformer as tfm
from repro_torch.models.kv_cache import cache_init, n_shared
from repro_torch.models.zoo import build

TOL = dict(rtol=1e-4, atol=1e-4)
NEW = ("zamba2-7b", "qwen3-8b", "starcoder2-15b", "chatglm3-6b",
       "gemma3-12b", "chameleon-34b")
CASES = list(NEW) + ["zamba2-7b+tail"]
PROMPT_T, MAX_LEN, DECODE_STEPS = 21, 48, 6


def _configs(case):
    arch = case.split("+")[0]
    jcfg, cfg = jax_get_arch(arch).smoke, get_arch(arch).smoke
    if case.endswith("+tail"):
        jcfg, cfg = jcfg.with_(n_layers=10), cfg.with_(n_layers=10)
    return jcfg, cfg


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), tree)


@pytest.fixture(scope="module", params=CASES)
def case(request):
    """JAX init + seeded noise on every leaf, as numpy; the converted port
    parameters."""
    jcfg, cfg = _configs(request.param)
    params = _np_tree(jtfm.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        params)
    return dict(name=request.param, jcfg=jcfg, cfg=cfg, jparams=jparams,
                params=lm_params_from_jax(jparams, cfg))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, dtype=np.float32), **TOL,
                               err_msg=what)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _jax_cache_as_port(jcache, cfg):
    """JAX's cache (leaves stacked [n_cycles, ...] per pattern position,
    shared entries beside the blocks of each cycle and of the tail) in the
    port's layout: one entry per layer in depth order, shared entries in a
    list of their own."""
    def cyc(tree, c):
        return jax.tree.map(lambda a: a[c], tree)
    layers, shared = [], []
    groups = [cyc(jcache["layers"], c) for c in range(cfg.cycles)]
    if cfg.tail:
        groups.append(jcache["tail"])
    for g in groups:
        if cfg.shared_every:
            shared.append(g["shared"])
            g = g["blocks"]
        layers.extend(g)
    out = {"layers": layers[:cfg.n_layers], "pos": jcache["pos"]}
    if cfg.shared_every:
        out["shared"] = shared
    return out


def _cache_close(cache, jcache, cfg, what):
    want = dict(_flatten(_jax_cache_as_port(jcache, cfg)))
    got = dict(_flatten(cache))
    assert sorted(got) == sorted(want), what
    for name, t in got.items():
        if t.dtype in (torch.int32, torch.int64):
            np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]),
                                          err_msg=f"{what} {name}")
        else:
            _close(t, want[name], f"{what} {name}")


def test_ported_archs_are_registered():
    assert set(NEW) <= set(PORTED)
    for arch in ("mixtral-8x22b", "arctic-480b"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
            get_arch(arch)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        get_arch("whisper-large-v3")
    moe = get_arch("qwen3-8b").smoke.with_(n_experts=4)
    with pytest.raises(NotImplementedError, match="MoE"):
        build(moe)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        build(moe.with_(n_experts=0, enc_layers=2))


def test_config_transcribed_from_jax(case):
    jcfg, cfg = case["jcfg"], case["cfg"]
    arch = case["name"].split("+")[0]
    for mine, ref in ((cfg, jcfg), (get_arch(arch).config,
                                    jax_get_arch(arch).config)):
        for f in dataclasses.fields(mine):
            if f.name != "dtype":
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert str(mine.dtype).split(".")[-1] == jnp.dtype(ref.dtype).name
    assert get_arch(arch).skip_shapes == jax_get_arch(arch).skip_shapes
    assert get_arch(arch).notes == jax_get_arch(arch).notes


def test_init_tree_matches_jax(case):
    cfg, params, jparams = case["cfg"], case["params"], case["jparams"]
    mine = tfm.init_params(cfg, seed=0, device="cpu")
    shapes = lambda t: {k: (tuple(v.shape), v.dtype) for k, v in _flatten(t)}
    assert shapes(mine) == shapes(params)
    assert len(params["layers"]) == cfg.n_layers
    assert ("shared" in params) == bool(cfg.shared_every)
    # JAX's stacked leaves come apart layer by layer, the tail after them
    P = len(cfg.pattern)
    for layer in range(cfg.n_layers):
        c, i = divmod(layer, P)
        src = (jax.tree.map(lambda a: a[c], jparams["layers"][i])
               if c < cfg.cycles else jparams["tail"][i])
        for (name, got), (_, want) in zip(_flatten(params["layers"][layer]),
                                          _flatten(src)):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_cache_init_matches_jax_layout(case):
    jcfg, cfg = case["jcfg"], case["cfg"]
    mine = cache_init(cfg, 3, 40, "cpu")
    ref = _jax_cache_as_port(jax_cache_init(jcfg, 3, 40), cfg)
    assert len(mine["layers"]) == cfg.n_layers
    assert len(mine.get("shared", [])) == n_shared(cfg)
    want = dict(_flatten(ref))
    got = dict(_flatten(mine))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
        assert str(t.dtype).split(".")[-1] == str(want[name].dtype), name
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]),
                                      err_msg=name)


def test_prefill_and_decode_steps_match_jax(case):
    """Prefill of 21 tokens (gemma3's SMOKE window of 8 wraps its ring
    caches) into caches of 48, then 6 greedy decode steps: logits and every
    cache leaf after each."""
    jcfg, cfg = case["jcfg"], case["cfg"]
    jparams = jax.tree.map(jnp.asarray, case["jparams"])
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, size=(2, PROMPT_T)).astype(np.int32)
    jcache, jlogits = jtfm.prefill(jcfg, jparams, jnp.asarray(tokens),
                                   MAX_LEN)
    with torch.no_grad():
        cache, logits = tfm.prefill(cfg, case["params"],
                                    torch.from_numpy(tokens).long(), MAX_LEN)
    assert logits.dtype == torch.float32 and logits.shape == (2, cfg.vocab)
    _close(logits, jlogits, "prefill logits")
    for step in range(DECODE_STEPS + 1):
        _cache_close(cache, jcache, cfg, f"step {step}")
        if step == DECODE_STEPS:
            break
        nxt = np.array(jnp.argmax(jlogits, axis=-1), dtype=np.int32)
        assert torch.argmax(logits, -1).tolist() == nxt.tolist(), step
        jcache, jlogits = jtfm.decode_step(jcfg, jparams, jcache,
                                           jnp.asarray(nxt))
        with torch.no_grad():
            cache, logits = tfm.decode_step(cfg, case["params"], cache,
                                            torch.from_numpy(nxt).long())
        _close(logits, jlogits, f"decode step {step + 1} logits")


def test_forward_matches_jax(case):
    jcfg, cfg = case["jcfg"], case["cfg"]
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab, size=(2, 19)).astype(np.int32)
    jlogits, _ = jtfm.forward(jcfg, jax.tree.map(jnp.asarray,
                                                 case["jparams"]),
                              jnp.asarray(tokens))
    with torch.no_grad():
        logits = tfm.forward(cfg, case["params"],
                             torch.from_numpy(tokens).long())
    assert logits.shape == (2, 19, cfg.vocab)
    _close(logits, jlogits, "forward logits")


def test_decode_matches_forward(case):
    """tests/test_archs_smoke.py's check on the port: prefill on T-2 tokens,
    then 2 decode steps, each equal to the teacher-forced forward's row
    (no soft-capping in any SMOKE config, so prefill's row compares too)."""
    cfg, params = case["cfg"], case["params"]
    T = 16
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, T))).long()
    api = build(cfg)
    with torch.no_grad():
        ref = tfm.forward(cfg, params, tokens)
        cache, logits = api.prefill(params, {"tokens": tokens[:, :T - 2]}, T)
        _close(logits, ref[:, T - 3].numpy(), "prefill row")
        for t in range(T - 2, T):
            cache, logits = api.decode(params, cache, tokens[:, t])
            _close(logits, ref[:, t].numpy(), f"decode row {t}")


def test_embed_scale_rounds_to_the_model_dtype():
    """gemma3-12b's width in bfloat16: sqrt(3840) = 61.9677 rounds to 62.0
    in bf16, and the JAX package multiplies by the rounded scale
    (transformer.py's `jnp.asarray(math.sqrt(d), cfg.dtype)`); so must the
    port, product for product."""
    cfg = get_arch("rwkv6-3b").smoke.with_(
        d_model=3840, vocab=64, embed_scale=True, dtype=torch.bfloat16)
    rng = np.random.default_rng(5)
    table = rng.normal(size=(cfg.vocab, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, size=(2, 8)).astype(np.int32)
    jtable = {"w": jnp.asarray(table).astype(jnp.bfloat16)}
    want = (jax_embed_lookup(jtable, jnp.asarray(tokens)).astype(jnp.bfloat16)
            * jnp.asarray(math.sqrt(cfg.d_model), jnp.bfloat16))
    params = {"embed": {"w": torch.from_numpy(table).to(torch.bfloat16)}}
    got = tfm._embed(cfg, params, torch.from_numpy(tokens).long())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, dtype=np.float32))
