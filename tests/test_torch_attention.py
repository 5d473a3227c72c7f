"""The port's attention and layers (models/attention.py, models/layers.py)
against the JAX package's, on the same numpy inputs, and the cases of
tests/test_models_property.py against a naive attention.

Against JAX: `flash_attention` (blocked, with padded query and KV blocks),
`local_attention` (windows that do and do not divide T) and
`decode_attention` at GQA groups 1, 2 and 4 and T = 8, 17, 32;
`attention_apply`/`attention_decode` with qk-norm, partial interleaved
RoPE and a ring cache; `apply_rope` (neox, interleaved, fraction 0.5) and
the four MLPs.  Tolerance rtol = atol = 1e-5 in f32 (the same products
summed in another order); 1e-2 for the bf16 RoPE (one bf16 rounding of the
operands and each product).  Against the naive attention, the property
file's tolerances (2e-3; 1e-5 for the causality check; 2e-4 for RoPE's
shift invariance), at fixed seeds in place of hypothesis draws.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.models import attention as attn
from repro_torch.models import layers

TOL = dict(rtol=1e-5, atol=1e-5)
INT_MAX = np.iinfo(np.int32).max


def _close(got, want, what="", tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, dtype=np.float32), **tol,
                               err_msg=what)


def _qkv(seed, B, Tq, H, n_kv, dh, Tk=None):
    rng = np.random.default_rng(seed)
    Tk = Tq if Tk is None else Tk
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return f(B, Tq, H, dh), f(B, Tk, n_kv, dh), f(B, Tk, n_kv, dh)


def _both(fn_jax, fn_port, arrays, **kw):
    want = fn_jax(*(jnp.asarray(a) for a in arrays), **kw)
    got = fn_port(*(torch.from_numpy(a) for a in arrays), **kw)
    return got, want


@pytest.mark.parametrize("T", [8, 17, 32])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_flash_attention_matches_jax(G, T):
    q, k, v = _qkv(G * 100 + T, 2, T, 2 * G, 2, 8)
    # blocks of 8: T = 17 pads the last query and KV blocks
    got, want = _both(jattn.flash_attention, attn.flash_attention, (q, k, v),
                      causal=True, kv_block=8, q_block=8)
    _close(got, want, "causal")
    got, want = _both(jattn.flash_attention, attn.flash_attention, (q, k, v),
                      causal=True)
    _close(got, want, "one block")


def test_flash_attention_with_positions_matches_jax():
    """Explicit positions (not 0..T-1) and a non-causal call with Tq != Tk:
    no block is skipped, padded KV positions are masked."""
    B, Tq, Tk, H, n_kv, dh = 2, 9, 13, 4, 2, 8
    q, k, v = _qkv(7, B, Tq, H, n_kv, dh, Tk)
    rng = np.random.default_rng(8)
    qp = np.sort(rng.integers(0, 20, size=(B, Tq)), axis=1).astype(np.int32)
    kp = np.sort(rng.integers(0, 20, size=(B, Tk)), axis=1).astype(np.int32)
    for causal in (True, False):
        want = jattn.flash_attention(
            *(jnp.asarray(a) for a in (q, k, v)), causal=causal, kv_block=4,
            q_block=4, q_positions=jnp.asarray(qp),
            kv_positions=jnp.asarray(kp))
        got = attn.flash_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
            kv_block=4, q_block=4, q_positions=torch.from_numpy(qp),
            kv_positions=torch.from_numpy(kp))
        _close(got, want, f"causal={causal}")


@pytest.mark.parametrize("T,window", [(8, 4), (17, 4), (17, 5), (32, 8),
                                      (32, 12), (8, 16)])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_local_attention_matches_jax(G, T, window):
    q, k, v = _qkv(G * 1000 + T * 10 + window, 2, T, 2 * G, 2, 8)
    got, want = _both(jattn.local_attention, attn.local_attention, (q, k, v),
                      window=window)
    _close(got, want)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_decode_attention_matches_jax(G):
    B, S, n_kv, dh = 3, 12, 2, 8
    rng = np.random.default_rng(G)
    q = rng.normal(size=(B, 1, n_kv * G, dh)).astype(np.float32)
    kc = rng.normal(size=(B, S, n_kv, dh)).astype(np.float32)
    vc = rng.normal(size=(B, S, n_kv, dh)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[:, 9:] = INT_MAX                                 # empty slots
    qpos = np.array([8, 4, 11], dtype=np.int32)
    arrays = (q, kc, vc, pos, qpos)
    got, want = _both(jattn.decode_attention, attn.decode_attention, arrays)
    _close(got, want)


def _attn_params(seed, d, H, n_kv, dh, qk_norm_kind=None):
    rng = np.random.default_rng(seed)
    w = lambda a, b: (rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
    p = {"wq": {"w": w(d, H * dh)}, "wk": {"w": w(d, n_kv * dh)},
         "wv": {"w": w(d, n_kv * dh)}, "wo": {"w": w(H * dh, d)}}
    if qk_norm_kind:
        norm = lambda: {"scale": (1 + 0.1 * rng.normal(size=dh)).astype(
            np.float32), **({"bias": (0.1 * rng.normal(size=dh)).astype(
                np.float32)} if qk_norm_kind == "layernorm" else {})}
        p["qk_norm"] = {"q": norm(), "k": norm()}
    return p


def _tree(p, to):
    if isinstance(p, dict):
        return {k: _tree(v, to) for k, v in p.items()}
    return to(p)


ATTN_CASES = {
    # qwen3: rmsnorm qk-norm, neox RoPE; chatglm3: partial interleaved;
    # chameleon: layernorm qk-norm; gemma3 local: a window (ring cache)
    "qk-rms": dict(qk="rmsnorm", kw=dict(rope_theta=1e6)),
    "partial-interleaved": dict(qk=None, kw=dict(rope_fraction=0.5,
                                                 rope_interleaved=True)),
    "qk-layernorm": dict(qk="layernorm", kw=dict(norm_kind="layernorm")),
    "window": dict(qk="rmsnorm", kw=dict(window=4)),
}


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_attention_apply_and_decode_match_jax(name):
    """Prefill 11 tokens, then decode 3 against a cache of 16 (a ring of 4
    for the windowed case) at per-row positions."""
    case = ATTN_CASES[name]
    B, T, d, H, n_kv, dh = 2, 11, 32, 4, 2, 8
    p = _attn_params(3, d, H, n_kv, dh, case["qk"])
    kw = dict(n_heads=H, n_kv=n_kv, head_dim=dh, **case["kw"])
    window = kw.pop("window", None)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, T, d)).astype(np.float32)
    jp, tp = _tree(p, jnp.asarray), _tree(p, torch.from_numpy)
    jy, (jk, jv) = jattn.attention_apply(jp, jnp.asarray(x), window=window,
                                         return_kv=True, **kw)
    y, (k, v) = attn.attention_apply(tp, torch.from_numpy(x), window=window,
                                     return_kv=True, **kw)
    _close(y, jy, "prefill y")
    _close(k, jk, "prefill k")
    _close(v, jv, "prefill v")
    S = 4 if window else 16
    kind = "ring" if window else "full"
    cache = {"k": np.zeros((B, S, n_kv, dh), np.float32),
             "v": np.zeros((B, S, n_kv, dh), np.float32),
             "pos": np.full((B, S), INT_MAX, np.int32)}
    jcache = _tree(cache, jnp.asarray)
    tcache = _tree(cache, lambda a: torch.from_numpy(a.copy()))
    position = np.array([5, 2], dtype=np.int32)
    for step in range(S + 2):                        # the ring wraps
        x1 = rng.normal(size=(B, 1, d)).astype(np.float32)
        jy, jcache = jattn.attention_decode(
            jp, jnp.asarray(x1), jcache, position=jnp.asarray(position),
            cache_kind=kind, **kw)
        y, tcache = attn.attention_decode(
            tp, torch.from_numpy(x1), tcache,
            position=torch.from_numpy(position.copy()), cache_kind=kind,
            **kw)
        _close(y, jy, f"decode {step} y")
        for key in ("k", "v"):
            _close(tcache[key], jcache[key], f"decode {step} {key}")
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        position = position + 1


@pytest.mark.parametrize("fraction,interleaved", [(1.0, False), (1.0, True),
                                                  (0.5, False), (0.5, True)])
def test_apply_rope_matches_jax(fraction, interleaved):
    rng = np.random.default_rng(int(fraction * 10) + interleaved)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, size=(2, 7)).astype(np.int32)
    kw = dict(theta=1e4, fraction=fraction, interleaved=interleaved)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), **kw)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), **kw)
    _close(got, want, tol=dict(rtol=1e-5, atol=2e-5))
    want = jlayers.apply_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos),
                              **kw)
    got = layers.apply_rope(torch.from_numpy(x).to(torch.bfloat16),
                            torch.from_numpy(pos), **kw)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32),
           tol=dict(rtol=1e-2, atol=1e-2))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_matches_jax(kind):
    rng = np.random.default_rng(len(kind))
    d, f = 16, 40
    w = lambda a, b: (rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
    p = {"up": {"w": w(d, f)}, "down": {"w": w(f, d)}}
    if kind in ("swiglu", "geglu"):
        p["gate"] = {"w": w(d, f)}
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    want = jlayers.mlp(_tree(p, jnp.asarray), jnp.asarray(x), kind)
    got = layers.mlp(_tree(p, torch.from_numpy), torch.from_numpy(x), kind)
    _close(got, want)
    # the init tree has the JAX package's keys and shapes
    gen = torch.Generator().manual_seed(0)
    mine = layers.mlp_init(gen, d, f, kind)
    assert {k: tuple(v["w"].shape) for k, v in mine.items()} == {
        k: v["w"].shape for k, v in p.items()}


def test_qk_norm_and_unembed_scale_match_jax():
    rng = np.random.default_rng(9)
    q = rng.normal(size=(2, 3, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 3, 2, 8)).astype(np.float32)
    for kind in ("rmsnorm", "layernorm"):
        p = _tree(jlayers.qk_norm_init(8, kind), np.asarray)
        p = {n: {m: a + 0.1 * rng.normal(size=a.shape).astype(np.float32)
                 for m, a in e.items()} for n, e in p.items()}
        want = jlayers.apply_qk_norm(_tree(p, jnp.asarray), jnp.asarray(q),
                                     jnp.asarray(k), kind)
        got = layers.apply_qk_norm(_tree(p, torch.from_numpy),
                                   torch.from_numpy(q), torch.from_numpy(k),
                                   kind)
        for g, w in zip(got, want):
            _close(g, w, kind)
        assert {n: sorted(e) for n, e in layers.qk_norm_init(8, kind).items()
                } == {n: sorted(e) for n, e in p.items()}
    table = rng.normal(size=(11, 8)).astype(np.float32)
    x = rng.normal(size=(2, 3, 8)).astype(np.float32)
    want = jlayers.unembed({"w": jnp.asarray(table)}, jnp.asarray(x), 0.5)
    got = layers.unembed({"w": torch.from_numpy(table)}, torch.from_numpy(x),
                         scale=0.5)
    _close(got, want)


# --------------------------------------------------------------------------- #
# tests/test_models_property.py's cases, against a naive attention
# --------------------------------------------------------------------------- #
def _naive_attention(q, k, v, causal=True, window=None):
    B, T, H, dh = q.shape
    n_kv = k.shape[2]
    G = H // n_kv
    qg = q.reshape(B, T, n_kv, G, dh).float() * dh ** -0.5
    s = torch.einsum("btkgd,bjkd->btkgj", qg, k.float())
    i = torch.arange(T)
    mask = torch.ones((T, T), dtype=torch.bool)
    if causal:
        mask &= i[None, :] <= i[:, None]
    if window:
        mask &= i[None, :] > i[:, None] - window
    s = torch.where(mask[None, :, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("btkgj,bjkd->btkgd", p, v.float())
    return o.reshape(B, T, H, dh)


PROP = dict(rtol=2e-3, atol=2e-3)


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("t", [8, 17, 32])
def test_flash_matches_naive(seed, g, t):
    gen = torch.Generator().manual_seed(seed * 100 + g * 10 + t)
    B, n_kv, dh = 2, 2, 8
    q = _randn(gen, B, t, n_kv * g, dh)
    k, v = _randn(gen, B, t, n_kv, dh), _randn(gen, B, t, n_kv, dh)
    out = attn.flash_attention(q, k, v, causal=True, kv_block=8, q_block=8)
    torch.testing.assert_close(out, _naive_attention(q, k, v), **PROP)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("w", [4, 8])
def test_local_matches_naive_windowed(seed, w):
    gen = torch.Generator().manual_seed(seed * 10 + w)
    B, T, n_kv, g, dh = 1, 24, 2, 2, 8
    q = _randn(gen, B, T, n_kv * g, dh)
    k, v = _randn(gen, B, T, n_kv, dh), _randn(gen, B, T, n_kv, dh)
    out = attn.local_attention(q, k, v, window=w)
    torch.testing.assert_close(out, _naive_attention(q, k, v, window=w),
                               **PROP)


def test_causality_future_independence():
    """Changing future tokens must not change past attention outputs."""
    gen = torch.Generator().manual_seed(0)
    B, T, H, dh = 1, 16, 4, 8
    q, k, v = (_randn(gen, B, T, H, dh) for _ in range(3))
    out1 = attn.flash_attention(q, k, v, causal=True, kv_block=8, q_block=8)
    k2, v2 = k.clone(), v.clone()
    k2[:, T // 2:] += _randn(gen, B, T // 2, H, dh)
    v2[:, T // 2:] += 1.0
    out2 = attn.flash_attention(q, k2, v2, causal=True, kv_block=8,
                                q_block=8)
    torch.testing.assert_close(out1[:, :T // 2], out2[:, :T // 2],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("interleaved", [False, True])
def test_rope_relative_shift_invariance(seed, fraction, interleaved):
    """RoPE: q.k inner products depend only on relative positions."""
    gen = torch.Generator().manual_seed(seed)
    B, T, H, dh = 1, 8, 1, 16
    q, k = _randn(gen, B, T, H, dh), _randn(gen, B, T, H, dh)
    pos = torch.arange(T).expand(B, T)

    def scores(shift):
        kw = dict(fraction=fraction, interleaved=interleaved)
        qr = layers.apply_rope(q, pos + shift, **kw)
        kr = layers.apply_rope(k, pos + shift, **kw)
        return torch.einsum("bthd,bshd->bhts", qr, kr)

    torch.testing.assert_close(scores(0), scores(13), rtol=2e-4, atol=2e-4)


def test_decode_attention_matches_full():
    """decode of position t == row t of full causal attention."""
    gen = torch.Generator().manual_seed(1)
    B, S, n_kv, g, dh = 2, 12, 2, 2, 8
    q_all = _randn(gen, B, S, n_kv * g, dh)
    k, v = _randn(gen, B, S, n_kv, dh), _randn(gen, B, S, n_kv, dh)
    ref = _naive_attention(q_all, k, v)
    t = S - 1
    out = attn.decode_attention(q_all[:, t:t + 1], k, v,
                                torch.arange(S).expand(B, S),
                                torch.full((B,), t, dtype=torch.int32))
    torch.testing.assert_close(out[:, 0], ref[:, t], **PROP)
