"""The port's `ServeEngine` against the JAX package's on the architectures
of tests/test_torch_zoo.py (the attention and Mamba-2 slice, zamba2 with a
tail, the two MoE LMs and Whisper; SMOKE configs), from the same
parameters: greedy tokens equal on tests/test_serve.py's two prompts and
under continuous admission (more requests than slots).  Every cache leaf
-- the attention k/v/pos, the Mamba-2 conv and SSM states, the shared
block's caches, Whisper's self and cross caches -- goes through the
engine's slot write.  Whisper's requests carry max_len frames each (the
JAX package's engine takes no other count), drawn x 0.1.

Two behaviours of the reference, shown on both engines: mixtral at the
published capacity 1.25 drops routed tokens (the batched decode routes
every slot, active or not, against a capacity of ceil(2 * slots * 1.25 /
E)), and both drop the same ones (greedy tokens equal); and a Whisper
request with fewer frames than max_len is refused by both, since the
engine's cross caches span max_len frames.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as jax_get_arch
from repro.models.zoo import build as jax_build
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_arch
from repro_torch.models import moe
from repro_torch.models.zoo import build
from repro_torch.serve.engine import Request, ServeEngine
from test_torch_zoo import _convert, _np_tree
from test_torch_zoo import case  # noqa: F401  (the parametrised fixture)

MAX_LEN = 64


def _frames(cfg, n, T=MAX_LEN):
    """n requests' frame embeddings [T, d] (None for a decoder-only LM)."""
    if not cfg.enc_layers:
        return [None] * n
    rng = np.random.default_rng(11)
    return [(rng.normal(size=(T, cfg.d_model)) * 0.1).astype(np.float32)
            for _ in range(n)]


def _run(engine, make, prompts, n_new, frames):
    reqs = [make(rid=i, prompt=p, max_new_tokens=n, enc_x=f)
            for i, (p, n, f) in enumerate(zip(prompts, n_new, frames))]
    return {r.rid: r.generated for r in engine.generate(reqs)}


def _smoke(arch, **over):
    """JAX's init of `arch` SMOKE (fields `over` replaced on both sides)
    with seeded noise on every leaf, and the port's copy."""
    jcfg = jax_get_arch(arch).smoke.with_(**over)
    cfg = get_arch(arch).smoke.with_(**over)
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        _np_tree(jax_build(jcfg).init(jax.random.PRNGKey(0))))
    return jcfg, cfg, jparams, _convert(jparams, cfg)


def _engines(jcfg, cfg, jparams, params, slots=2):
    jeng = JaxServeEngine(jax_build(jcfg), slots=slots, max_len=MAX_LEN)
    jeng.load(jax.tree.map(jnp.asarray, jparams))
    eng = ServeEngine(build(cfg), slots=slots, max_len=MAX_LEN, device="cpu")
    eng.load(params)
    return jeng, eng


@pytest.mark.parametrize("admission", ["two-prompts", "continuous"])
def test_engine_greedy_tokens_match_jax(case, admission):
    """tests/test_serve.py's two prompts, and more requests than slots."""
    if admission == "two-prompts":
        prompts = [np.arange(5, 13, dtype=np.int32),
                   np.arange(40, 44, dtype=np.int32)]
        n_new = [6, 6]
    else:
        prompts = [np.arange(3 + i, dtype=np.int32) + 1 for i in range(5)]
        n_new = [3 + i % 2 for i in range(5)]
    jeng, eng = _engines(case["jcfg"], case["cfg"], case["jparams"],
                         case["params"])
    frames = _frames(case["cfg"], len(prompts))
    want = _run(jeng, JaxRequest, prompts, n_new, frames)
    got = _run(eng, Request, prompts, n_new, frames)
    assert got == want
    assert all(len(got[i]) == n for i, n in enumerate(n_new))
    assert not eng.active and len(eng.free_slots()) == 2


def test_mixtral_at_capacity_1_25_drops_the_same_tokens_as_jax(monkeypatch):
    """mixtral SMOKE at the published capacity 1.25, 2 slots: the prompts'
    prefills drop routed assignments (C = ceil(2 * T * 1.25 / 4) for a
    T-token prompt), and both engines still give the same greedy tokens:
    the same tokens were dropped.  The port's drops are counted at its
    router."""
    jcfg, cfg, jparams, params = _smoke("mixtral-8x22b", moe_capacity=1.25)
    routed = {"kept": 0, "total": 0}
    real = moe.router_topk

    def counting(logits, top_k, capacity):
        combine, aux = real(logits, top_k, capacity)
        routed["kept"] += int((combine > 0).sum())
        routed["total"] += logits.shape[0] * logits.shape[1] * top_k
        return combine, aux
    monkeypatch.setattr(moe, "router_topk", counting)
    prompts = [np.arange(5 + 3 * i, 29 + 5 * i, dtype=np.int32) % 256
               for i in range(4)]
    n_new = [6, 5, 6, 5]
    jeng, eng = _engines(jcfg, cfg, jparams, params)
    frames = _frames(cfg, len(prompts))
    want = _run(jeng, JaxRequest, prompts, n_new, frames)
    got = _run(eng, Request, prompts, n_new, frames)
    assert got == want
    assert routed["kept"] < routed["total"], routed


def test_both_engines_refuse_whisper_frames_short_of_max_len():
    """Whisper's engine cache spans max_len encoder frames: a request of
    max_len / 2 frames is refused by the JAX engine's slot write and by the
    port's copy_, and one of max_len frames is served by both."""
    jcfg, cfg, jparams, params = _smoke("whisper-large-v3")
    jeng, eng = _engines(jcfg, cfg, jparams, params)
    prompt = np.arange(4, dtype=np.int32)
    short = _frames(cfg, 1, MAX_LEN // 2)[0]
    with pytest.raises(ValueError, match="Incompatible shapes"):
        jeng.admit(JaxRequest(rid=0, prompt=prompt, enc_x=short))
    with pytest.raises(RuntimeError, match="must match"):
        eng.admit(Request(rid=0, prompt=prompt, enc_x=short))
    full = _frames(cfg, 1)[0]
    assert jeng.admit(JaxRequest(rid=1, prompt=prompt, enc_x=full))
    assert eng.admit(Request(rid=1, prompt=prompt, enc_x=full))
