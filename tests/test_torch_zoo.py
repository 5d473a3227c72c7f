"""The port's LM zoo against the JAX package's, for the six architectures of
the attention and Mamba-2 slice, the two MoE LMs and the encoder-decoder
(SMOKE configs), on the same numpy inputs and parameters.

Parameters come from the JAX package's own init (its zoo's `build(cfg).init`),
with seeded numpy noise (0.05) added to every leaf so that zero-initialised
biases and unit norms take part, and are carried over with
`convert.lm_params_from_jax` (`whisper_params_from_jax` for Whisper).
Besides the SMOKE configs, zamba2's SMOKE at 10 layers has a 1-layer tail,
so the shared block also runs before the tail (4 invocations).  Every
case: the config transcribed field for field; the converted tree equals
JAX's leaf for leaf and its shapes and dtypes the port's own init; the
cache layout equals JAX's modulo the stacking; prefill and 6 decode steps
through the model API (logits and every cache leaf; Whisper's over 24
encoder frames); `forward`'s logits and MoE auxiliary loss (Whisper's
encoder plus teacher-forced decoder); decode against forward.  The MoE
routers stay f32 in a bf16 model on both sides.  The `ServeEngine`'s greedy
tokens against JAX's engine are in tests/test_torch_zoo_serve.py.
Tolerance rtol = atol = 1e-4 in f32 (sums in another order; measured
differences are below 1e-5).  Greedy tokens must be equal.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import list_archs as jax_list_archs
from repro.models import encdec as jencdec
from repro.models import transformer as jtfm
from repro.models.layers import embed_lookup as jax_embed_lookup
from repro.models.zoo import build as jax_build
from repro_torch.configs import get_arch, list_archs
from repro_torch.convert import lm_params_from_jax, whisper_params_from_jax
from repro_torch.models import encdec
from repro_torch.models import transformer as tfm
from repro_torch.models.kv_cache import n_shared
from repro_torch.models.zoo import build

TOL = dict(rtol=1e-4, atol=1e-4)
NEW = ("zamba2-7b", "qwen3-8b", "starcoder2-15b", "chatglm3-6b",
       "gemma3-12b", "chameleon-34b")
MOE = ("mixtral-8x22b", "arctic-480b")
ENCDEC = ("whisper-large-v3",)
CASES = list(NEW) + ["zamba2-7b+tail"] + list(MOE) + list(ENCDEC)
PROMPT_T, MAX_LEN, DECODE_STEPS = 21, 48, 6
T_ENC = 24          # Whisper's encoder frames in the direct prefill


def _configs(case):
    arch = case.split("+")[0]
    jcfg, cfg = jax_get_arch(arch).smoke, get_arch(arch).smoke
    if case.endswith("+tail"):
        jcfg, cfg = jcfg.with_(n_layers=10), cfg.with_(n_layers=10)
    return jcfg, cfg


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), tree)


def _convert(jparams, cfg):
    if cfg.enc_layers:
        return whisper_params_from_jax(jparams, cfg)
    return lm_params_from_jax(jparams, cfg)


@pytest.fixture(scope="module", params=CASES)
def case(request):
    """JAX init + seeded noise on every leaf, as numpy; the converted port
    parameters."""
    jcfg, cfg = _configs(request.param)
    params = _np_tree(jax_build(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        params)
    return dict(name=request.param, jcfg=jcfg, cfg=cfg, jparams=jparams,
                params=_convert(jparams, cfg))


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


def _cyc(tree, c):
    return jax.tree.map(lambda a: a[c], tree)


def _jax_params_as_port(jparams, cfg):
    """JAX's parameters in the port's layout: stacked [n_cycles, ...]
    leaves (Whisper's [L, ...]) split into one dict per layer, the tail's
    after them."""
    if cfg.enc_layers:
        out = dict(jparams)
        for side, n in (("enc_layers", cfg.enc_layers),
                        ("dec_layers", cfg.n_layers)):
            out[side] = [_cyc(jparams[side], i) for i in range(n)]
        return out
    P = len(cfg.pattern)
    out = {k: v for k, v in jparams.items() if k not in ("layers", "tail")}
    out["layers"] = [_cyc(jparams["layers"][i], c) for c in range(cfg.cycles)
                     for i in range(P)] + list(jparams.get("tail", []))
    return out


def _jax_cache_as_port(jcache, cfg):
    """JAX's cache (leaves stacked [n_cycles, ...] per pattern position,
    shared entries beside the blocks of each cycle and of the tail;
    Whisper's self and cross entries stacked [L, ...]) in the port's
    layout: one entry per layer in depth order, shared entries in a list of
    their own."""
    cyc = _cyc
    if cfg.enc_layers:
        return {side: [cyc(jcache[side], i) for i in range(cfg.n_layers)]
                for side in ("self", "cross")} | {"pos": jcache["pos"]}
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
    """Every architecture of the JAX package builds in the port, the MoE
    LMs and the encoder-decoder too; a MoE config of a dense one takes the
    MoE FFN, a config with encoder layers the encoder-decoder API."""
    assert set(NEW + MOE + ENCDEC + ("rwkv6-3b",)) == set(list_archs())
    assert list_archs() == sorted(jax_list_archs())
    for arch in list_archs():
        spec = get_arch(arch)
        assert spec.name == arch and spec.smoke.name == arch
        assert build(spec.smoke).is_encdec == (arch in ENCDEC)
    moe = get_arch("qwen3-8b").smoke.with_(n_experts=4)
    layer = build(moe).init(0, device="cpu")["layers"][0]
    assert "moe" in layer and "ffn" not in layer
    assert build(moe.with_(n_experts=0, enc_layers=2)).is_encdec


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
    mine = build(cfg).init(seed=0, device="cpu")
    shapes = lambda t: {k: (tuple(v.shape), v.dtype) for k, v in _flatten(t)}
    assert shapes(mine) == shapes(params)
    if not cfg.enc_layers:
        assert len(params["layers"]) == cfg.n_layers
        assert ("shared" in params) == bool(cfg.shared_every)
    # JAX's stacked leaves come apart layer by layer, the tail after them
    want = dict(_flatten(_jax_params_as_port(jparams, cfg)))
    got = dict(_flatten(params))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[name], err_msg=name)


@pytest.mark.parametrize("arch", MOE)
def test_bf16_moe_keeps_the_router_f32(arch):
    """In a bf16 model every leaf is bf16 but the MoE routers, which stay
    f32: in JAX's init, in the port's, and through the converter."""
    jcfg = jax_get_arch(arch).smoke.with_(dtype=jnp.bfloat16)
    cfg = get_arch(arch).smoke.with_(dtype=torch.bfloat16)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(0))
    want = {k: ("float32" if "/router/" in k else "bfloat16")
            for k, _ in _flatten(_jax_params_as_port(jparams, cfg))}
    for k, a in _flatten(_jax_params_as_port(jparams, cfg)):
        assert str(a.dtype) == want[k], k
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    for tree in (build(cfg).init(0, device="cpu"),
                 lm_params_from_jax(host, cfg)):
        got = {k: str(t.dtype).split(".")[-1] for k, t in _flatten(tree)}
        assert got == want
    assert sum("/router/" in k for k in want) == cfg.n_layers


def test_cache_init_matches_jax_layout(case):
    jcfg, cfg = case["jcfg"], case["cfg"]
    mine = build(cfg).cache_init(3, 40, "cpu")
    ref = _jax_cache_as_port(jax_build(jcfg).cache_init(3, 40), cfg)
    if cfg.enc_layers:        # the cross caches span max_len frames
        assert mine["cross"][0]["k"].shape[1] == 40
    else:
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


def _batch(cfg, rng, T):
    """The same numpy batch for both packages: tokens [2, T] and, for
    Whisper, T_ENC frames drawn x 0.1 as tests/test_archs_smoke.py's."""
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(2, T)).astype(
        np.int32)}
    if cfg.enc_layers:
        batch["enc_x"] = (rng.normal(size=(2, T_ENC, cfg.d_model))
                          * 0.1).astype(np.float32)
    return batch


def _as_torch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


def test_prefill_and_decode_steps_match_jax(case):
    """Prefill of 21 tokens (gemma3's SMOKE window of 8 and mixtral's of
    16 wrap their ring caches) into caches of 48, then 6 greedy decode
    steps through the model API: logits and every cache leaf after each."""
    jcfg, cfg = case["jcfg"], case["cfg"]
    jparams = jax.tree.map(jnp.asarray, case["jparams"])
    japi, api = jax_build(jcfg), build(cfg)
    batch = _batch(cfg, np.random.default_rng(3), PROMPT_T)
    jcache, jlogits = japi.prefill(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, MAX_LEN)
    with torch.no_grad():
        cache, logits = api.prefill(case["params"], _as_torch(batch),
                                    MAX_LEN)
    assert logits.dtype == torch.float32 and logits.shape == (2, cfg.vocab)
    _close(logits, jlogits, "prefill logits")
    for step in range(DECODE_STEPS + 1):
        _cache_close(cache, jcache, cfg, f"step {step}")
        if step == DECODE_STEPS:
            break
        nxt = np.array(jnp.argmax(jlogits, axis=-1), dtype=np.int32)
        assert torch.argmax(logits, -1).tolist() == nxt.tolist(), step
        jcache, jlogits = japi.decode(jparams, jcache, jnp.asarray(nxt))
        with torch.no_grad():
            cache, logits = api.decode(case["params"], cache,
                                       torch.from_numpy(nxt).long())
        _close(logits, jlogits, f"decode step {step + 1} logits")


def _forward(cfg, params, batch):
    """The port's teacher-forced logits and MoE auxiliary loss (Whisper:
    encoder, then the decoder over all tokens; no aux)."""
    if cfg.enc_layers:
        enc = encdec.whisper_encode(cfg, params, batch["enc_x"])
        return (encdec.whisper_decode_forward(cfg, params, batch["tokens"],
                                              enc), None)
    return tfm.forward(cfg, params, batch["tokens"])


def test_forward_matches_jax(case):
    """Logits, and the MoE auxiliary loss summed over layers (0 for the
    dense and recurrent LMs, on both sides)."""
    jcfg, cfg = case["jcfg"], case["cfg"]
    jparams = jax.tree.map(jnp.asarray, case["jparams"])
    batch = _batch(cfg, np.random.default_rng(4), 19)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if cfg.enc_layers:
        jlogits = jencdec.whisper_decode_forward(
            jcfg, jparams, jb["tokens"],
            jencdec.whisper_encode(jcfg, jparams, jb["enc_x"]))
    else:
        jlogits, jaux = jtfm.forward(jcfg, jparams, jb["tokens"])
    with torch.no_grad():
        logits, aux = _forward(cfg, case["params"], _as_torch(batch))
    assert logits.shape == (2, 19, cfg.vocab)
    _close(logits, jlogits, "forward logits")
    if not cfg.enc_layers:
        assert aux.dtype == torch.float32 and aux.shape == ()
        assert (float(aux) > 0) == bool(cfg.n_experts)
        _close(aux, jaux, "forward aux")


def test_decode_matches_forward(case):
    """tests/test_archs_smoke.py's check on the port: prefill on T-2 tokens,
    then 2 decode steps, each equal to the teacher-forced forward's row
    (no soft-capping in any SMOKE config, so prefill's row compares too;
    the MoE SMOKE configs' capacity drops no token)."""
    cfg, params = case["cfg"], case["params"]
    T = 16
    batch = _as_torch(_batch(cfg, np.random.default_rng(1), T))
    tokens = batch["tokens"]
    api = build(cfg)
    with torch.no_grad():
        ref, _ = _forward(cfg, params, batch)
        cache, logits = api.prefill(
            params, dict(batch, tokens=tokens[:, :T - 2]), T)
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
