"""The port's encoder-decoder (models/encdec.py, whisper-large-v3 SMOKE)
against the JAX package's models/encdec.py, on the same numpy inputs and
parameters: the encoder's sinusoidal positions, `whisper_encode`,
`whisper_decode_forward`, and `whisper_prefill`'s caches (self and cross)
and logits followed by 4 greedy decode steps.  On the port alone: decode
against the teacher-forced forward, as tests/test_archs_smoke.py checks
JAX's.

Parameters come from the JAX package's init with seeded numpy noise (0.05)
on every leaf, so the zero LayerNorm biases take part, carried over with
`convert.whisper_params_from_jax`.  Tolerance rtol = atol = 1e-4 in f32
(sums in another order); greedy tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import encdec as jencdec
from repro.models.layers import sinusoidal_positions as jax_sinusoidal
from repro_torch.configs import get_arch
from repro_torch.convert import whisper_params_from_jax
from repro_torch.models import encdec
from repro_torch.models.layers import sinusoidal_positions

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "whisper-large-v3"
T_ENC, PROMPT_T, MAX_LEN, DECODE_STEPS = 24, 7, 32, 4


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jax_get_arch(ARCH).smoke, get_arch(ARCH).smoke
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jencdec.whisper_init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        params)
    rng = np.random.default_rng(1)
    enc_x = (rng.normal(size=(2, T_ENC, cfg.d_model)) * 0.1).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab, size=(2, PROMPT_T)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jax.tree.map(jnp.asarray, jparams),
                params=whisper_params_from_jax(jparams, cfg), enc_x=enc_x,
                tokens=tokens)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, dtype=np.float32), **TOL,
                               err_msg=what)


@pytest.mark.parametrize("T,d", [(16, 64), (1500, 1280), (5, 2), (9, 7)])
def test_sinusoidal_positions_match_jax(T, d):
    """Including d = 2 (half - 1 = 0: the divisor's floor of 1) and an odd
    width (the table is 2 * (d // 2) wide, as JAX's).  XLA's and torch's
    f32 exp differ by 1 ulp on some frequencies (43 of Whisper's 640), and
    the angle t * freq carries that t-fold, plus its own rounding: at t =
    1,499 up to 1.2e-4.  So the table is held to 1e-4 at the SMOKE widths
    and, at Whisper's 1,500 frames, to that bound, T * 2^-24 + ulp(T)."""
    got = sinusoidal_positions(T, d)
    want = np.asarray(jax_sinusoidal(T, d))
    assert got.shape == want.shape and got.dtype == torch.float32
    if T <= 64:
        _close(got, want, f"T={T} d={d}")
    else:
        bound = T * 2.0 ** -24 + 2.0 ** (np.floor(np.log2(T)) - 23)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=bound)


def test_converted_tree_matches_the_port_init(model):
    cfg, params = model["cfg"], model["params"]
    mine = encdec.whisper_init(cfg, seed=0, device="cpu")

    def shapes(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in shapes(v, f"{prefix}/{k}").items()}
        if isinstance(tree, list):
            return {k2: v2 for i, v in enumerate(tree)
                    for k2, v2 in shapes(v, f"{prefix}/{i}").items()}
        return {prefix: (tuple(tree.shape), tree.dtype)}
    assert shapes(mine) == shapes(params)
    assert len(params["enc_layers"]) == cfg.enc_layers
    assert len(params["dec_layers"]) == cfg.n_layers
    np.testing.assert_array_equal(
        params["dec_layers"][1]["cross"]["wk"]["w"].numpy(),
        np.asarray(model["jparams"]["dec_layers"]["cross"]["wk"]["w"][1]))


def test_encode_and_decode_forward_match_jax(model):
    jcfg, cfg = model["jcfg"], model["cfg"]
    jenc = jencdec.whisper_encode(jcfg, model["jparams"],
                                  jnp.asarray(model["enc_x"]))
    jlogits = jencdec.whisper_decode_forward(
        jcfg, model["jparams"], jnp.asarray(model["tokens"]), jenc)
    with torch.no_grad():
        enc = encdec.whisper_encode(cfg, model["params"],
                                    torch.from_numpy(model["enc_x"]))
        logits = encdec.whisper_decode_forward(
            cfg, model["params"], torch.from_numpy(model["tokens"]).long(),
            enc)
    assert enc.shape == (2, T_ENC, cfg.d_model)
    assert logits.shape == (2, PROMPT_T, cfg.vocab)
    _close(enc, jenc, "encoder output")
    _close(logits, jlogits, "decoder logits")


def _cache_close(cache, jcache, what):
    assert sorted(cache) == ["cross", "pos", "self"]
    np.testing.assert_array_equal(cache["pos"].numpy(), jcache["pos"])
    for side in ("self", "cross"):
        for layer, entry in enumerate(cache[side]):
            for name, t in entry.items():
                want = np.asarray(jcache[side][name][layer])
                assert tuple(t.shape) == want.shape
                if name == "pos":
                    np.testing.assert_array_equal(t.numpy(), want)
                else:
                    _close(t, want, f"{what} {side} {layer} {name}")


def test_prefill_and_decode_steps_match_jax(model):
    """The prompt's 7 tokens over 24 frames into caches of 32, then 4
    greedy decode steps: logits and every self and cross cache leaf after
    each (the cross caches are never written after prefill)."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    batch = {"enc_x": model["enc_x"], "tokens": model["tokens"]}
    jcache, jlogits = jencdec.whisper_prefill(
        jcfg, model["jparams"], {k: jnp.asarray(v) for k, v in batch.items()},
        MAX_LEN)
    with torch.no_grad():
        cache, logits = encdec.whisper_prefill(
            cfg, model["params"],
            {"enc_x": torch.from_numpy(batch["enc_x"]),
             "tokens": torch.from_numpy(batch["tokens"]).long()}, MAX_LEN)
    assert cache["cross"][0]["k"].shape == (2, T_ENC, cfg.n_kv_heads,
                                            cfg.head_dim)
    _close(logits, jlogits, "prefill logits")
    for step in range(DECODE_STEPS + 1):
        _cache_close(cache, jcache, f"step {step}")
        if step == DECODE_STEPS:
            break
        nxt = np.array(jnp.argmax(jlogits, axis=-1), dtype=np.int32)
        assert torch.argmax(logits, -1).tolist() == nxt.tolist(), step
        jcache, jlogits = jencdec.whisper_decode_step(
            jcfg, model["jparams"], jcache, jnp.asarray(nxt))
        with torch.no_grad():
            cache, logits = encdec.whisper_decode_step(
                cfg, model["params"], cache, torch.from_numpy(nxt).long())
        _close(logits, jlogits, f"decode step {step + 1} logits")


def test_decode_matches_teacher_forced_forward(model):
    """Prefill on the first T-2 tokens, then 2 decode steps, each equal to
    the forward's row at that position."""
    cfg, params = model["cfg"], model["params"]
    enc_x = torch.from_numpy(model["enc_x"])
    tokens = torch.from_numpy(model["tokens"]).long()
    T = tokens.shape[1]
    with torch.no_grad():
        ref = encdec.whisper_decode_forward(
            cfg, params, tokens, encdec.whisper_encode(cfg, params, enc_x))
        cache, logits = encdec.whisper_prefill(
            cfg, params, {"enc_x": enc_x, "tokens": tokens[:, :T - 2]}, T)
        _close(logits, ref[:, T - 3].numpy(), "prefill row")
        for t in range(T - 2, T):
            cache, logits = encdec.whisper_decode_step(cfg, params, cache,
                                                       tokens[:, t])
            _close(logits, ref[:, t].numpy(), f"decode row {t}")
