"""LM training of the port against the JAX package's, on the CPU.

For every architecture of the zoo at its SMOKE config: the model API's
`loss` (loss, nll, aux) and the gradient of every parameter leaf against
`jax.value_and_grad(api.loss)` on the same tokens
(`test_archs_smoke.py::test_train_step_smoke` ported, with the parity it
lacks).  For rwkv6, qwen3, mixtral and whisper: 3 steps of
`make_train_step` with AdamW on the cosine schedule (weight decay 0.1) on
`TokenStream` batches against JAX's jitted step, once with
`grad_accum=2` and once with the top-k compressor: the loss and every
parameter after each step.  Recomputation (`cfg.remat`) on and off gives
the same losses and gradients.  The scan's autograd Function (the CUDA
kernel's forward, the plain version replayed in the backward) is checked
with the plain version standing in for the kernel, under recomputation
too; and the port's chunked scan keeps its gradient finite where JAX's
chunked reference returns NaN.

Parameters are JAX's own init with seeded numpy noise (0.05) on every leaf
(as tests/test_torch_zoo.py), carried over with `convert`.  The JAX side
runs as its own tests run it: the jnp chunked scan (`use_pallas=False`).
Tolerance rtol = atol = 1e-4 in f32 (sums in another order).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.configs import get_arch as jax_get_arch
from repro.distributed.compression import topk_compressor as jax_topk
from repro.kernels.linear_scan.ref import linear_scan_chunked as jax_chunked
from repro.kernels.linear_scan.ref import linear_scan_seq as jax_seq
from repro.models.zoo import build as jax_build
from repro.train import optimizer as jopt
from repro.train.train_state import init_state as jax_init_state
from repro.train.train_state import make_train_step as jax_make_train_step
from repro_torch.configs import get_arch, list_archs
from repro_torch.convert import lm_params_from_jax, whisper_params_from_jax
from repro_torch.data.tokens import TokenStream
from repro_torch.distributed.compression import topk_compressor
from repro_torch.kernels.linear_scan import ops as scan_ops
from repro_torch.kernels.linear_scan.ref import linear_scan_chunked
from repro_torch.models.zoo import build
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import tree_flatten
from repro_torch.train.train_state import (init_state, make_train_step,
                                           value_and_grad)

TOL = dict(rtol=1e-4, atol=1e-4)
B, T = 2, 16
# the two heaviest SMOKE configs carry the JAX smoke test's slow mark
_HEAVY = {"arctic-480b", "gemma3-12b"}
ARCHS = [pytest.param(a, marks=pytest.mark.slow) if a in _HEAVY else a
         for a in list_archs()]


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), tree)


def _convert(tree, cfg):
    conv = whisper_params_from_jax if cfg.enc_layers else lm_params_from_jax
    return conv(tree, cfg)


def _params(arch):
    """(jcfg, cfg, JAX params + noise as numpy, the port's params)."""
    jcfg, cfg = jax_get_arch(arch).smoke, get_arch(arch).smoke
    params = _np_tree(jax_build(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        params)
    return jcfg, cfg, jparams, _convert(jparams, cfg)


def _stream(cfg, batch, seed=1):
    return TokenStream(vocab=cfg.vocab, batch=batch, seq_len=T, seed=seed,
                       d_frontend=cfg.d_model if cfg.enc_layers else None)


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, dtype=np.float32), **TOL,
                               err_msg=what)


def _trees_close(mine, jax_tree, cfg, what):
    """A port tree against a JAX params-shaped tree, leaf by leaf (the JAX
    tree carried into the port's layout by the converter, in f32)."""
    want = _convert(_np_tree(jax_tree), cfg.with_(dtype=torch.float32))
    got, paths = tree_flatten(mine)
    ref, ref_paths = tree_flatten(want)
    assert paths == ref_paths, what
    for a, b, p in zip(got, ref, paths):
        _close(a, b.numpy(), f"{what} {p}")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg, cfg, jparams, params = _params(arch)
    batch = _stream(cfg, B).batch_at(0)
    japi, api = jax_build(jcfg), build(cfg)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(japi.loss,
                                                     has_aux=True))(
        jax.tree.map(jnp.asarray, jparams), batch)
    (loss, m), grads = value_and_grad(api.loss, params, _torch_batch(batch))
    assert sorted(m) == sorted(jm) == ["aux", "nll"]
    _close(loss, jloss, f"{arch} loss")
    for k in m:
        _close(m[k], jm[k], f"{arch} {k}")
    assert np.isfinite(float(loss))
    if cfg.n_experts:
        assert float(m["aux"]) > 0
    _trees_close(grads, jgrads, cfg, f"{arch} grad")
    gnorm = sum(float(g.abs().sum()) for g in opt.tree_leaves(grads))
    assert np.isfinite(gnorm) and gnorm > 0.0


# arch -> make_train_step options: once grad_accum=2, once the compressor
STEPS = {"rwkv6-3b": {}, "qwen3-8b": {"grad_accum": 2},
         "mixtral-8x22b": {"compress": 0.25}, "whisper-large-v3": {}}


@pytest.mark.parametrize("arch", sorted(STEPS))
def test_train_steps_match_jax(arch):
    """3 train steps (AdamW, `cosine_schedule(3e-3, 10, 3)`, weight decay
    0.1, clipping at 1.0: train_lm's optimizer) on TokenStream batches of
    4: each step's loss and the params after it equal JAX's jitted
    step's."""
    kw = STEPS[arch]
    jcfg, cfg, jparams, params = _params(arch)
    japi, api = jax_build(jcfg), build(cfg)
    jo = jopt.adamw(lr=jopt.cosine_schedule(3e-3, 10, 3), weight_decay=0.1)
    o = opt.adamw(lr=opt.cosine_schedule(3e-3, 10, 3), weight_decay=0.1)
    accum = kw.get("grad_accum", 1)
    jcomp = jax_topk(kw["compress"]) if "compress" in kw else None
    comp = (topk_compressor(kw["compress"], group=api.stack_key)
            if "compress" in kw else None)
    jstep = jax.jit(jax_make_train_step(japi.loss, jo, grad_accum=accum,
                                        compressor=jcomp))
    step = make_train_step(api.loss, o, grad_accum=accum, compressor=comp)
    jstate = jax_init_state(jax.tree.map(jnp.asarray, jparams), jo)
    state = init_state(params, o)
    if comp is not None:
        jstate["comp"] = jcomp.init(jstate["params"])
        state["comp"] = comp.init(params)
    stream = _stream(cfg, 4, seed=0)
    for i in range(3):
        batch = stream.batch_at(i)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, _torch_batch(batch))
        _close(m["loss"], jm["loss"], f"{arch} step {i} loss")
        _close(m["nll"], jm["nll"], f"{arch} step {i} nll")
        _trees_close(state["params"], jstate["params"], cfg,
                     f"{arch} step {i} params")
    assert int(state["step"]) == 3 and int(state["opt"].step) == 3
    if comp is not None:
        _trees_close(state["comp"], jstate["comp"], cfg, f"{arch} error")


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b", "mixtral-8x22b",
                                  "whisper-large-v3"])
def test_remat_on_and_off_give_the_same_loss_and_grads(arch):
    """Recomputation changes what is saved for the backward, not the
    numbers: with `remat` off and on (each cycle, Zamba2's shared block
    inside it; each Whisper block) the loss and every gradient agree bit
    for bit on the CPU."""
    _, cfg, _, params = _params(arch)
    batch = _torch_batch(_stream(cfg, B).batch_at(0))
    out = [value_and_grad(build(cfg.with_(remat=r)).loss, params, batch)
           for r in (False, True)]
    (l0, m0), g0 = out[0]
    (l1, m1), g1 = out[1]
    assert torch.equal(l0, l1) and torch.equal(m0["nll"], m1["nll"])
    for a, b in zip(opt.tree_leaves(g0), opt.tree_leaves(g1)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# The scan's autograd Function, with the plain version as its kernel
# --------------------------------------------------------------------------- #
def _stand_in_kernel(calls):
    """A CPU stand-in for `linear_scan_kernel` on its [BH, T, *] operands:
    the plain chunked version, each head its own bonus row."""
    def kernel(q, k, v, w, u, s0, *, mode, chunk):
        calls.append(q.shape)
        BH = q.shape[0]
        uu = None if u is None else u.repeat(BH // u.shape[0], 1)
        o, s = linear_scan_chunked(
            q[None], k[None], v[None], w[None], uu, mode=mode, chunk=chunk,
            initial_state=None if s0 is None else s0[None])
        return o[0], s[0]
    return kernel


def _scan_inputs(seed, dtype, strong=False):
    rng = np.random.default_rng(seed)
    Bs, H, Ts, K, V = 2, 3, 37, 8, 6
    f = lambda *s, scale=0.5: torch.tensor(scale * rng.normal(size=s),
                                           dtype=torch.float32)
    lo, hi = (-1.0, 2.0) if strong else (-7.0, -1.5)
    w = -torch.exp(torch.tensor(rng.uniform(lo, hi, (Bs, H, Ts, K)),
                                dtype=torch.float32))
    return [f(Bs, H, Ts, K).to(dtype), f(Bs, H, Ts, K).to(dtype),
            f(Bs, H, Ts, V).to(dtype), w, f(H, K, scale=0.3),
            f(Bs, H, K, V, scale=0.1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["rwkv6", "ssd"])
@pytest.mark.parametrize("remat", [False, True])
def test_scan_function_replays_the_plain_version(monkeypatch, dtype, mode,
                                                 remat):
    """`_LinearScanKernel` (kernel forward, plain backward by replay), with
    the plain version standing in for the CUDA kernel: outputs and the
    gradients of q, k, v, w, u and s0 equal the plain version's under
    autograd, each in its input's dtype; the kernel runs once a forward,
    and twice when the forward is recomputed in the backward."""
    calls = []
    monkeypatch.setattr(scan_ops, "linear_scan_kernel",
                        _stand_in_kernel(calls))
    u_arg = None if mode == "ssd" else 4
    base = _scan_inputs(5, dtype)
    got_in = [t.clone().requires_grad_() for t in base]
    ref_in = [t.clone().requires_grad_() for t in base]

    def fn(q, k, v, w, u, s0):
        return scan_ops._LinearScanKernel.apply(
            q, k, v, w, u if u_arg else None, s0, mode, 16)
    o, s = checkpoint(fn, *got_in, use_reentrant=False) if remat \
        else fn(*got_in)
    ro, rs = linear_scan_chunked(*ref_in[:4], ref_in[4] if u_arg else None,
                                 mode=mode, chunk=16,
                                 initial_state=ref_in[5])
    torch.testing.assert_close(o, ro, rtol=0, atol=0)
    torch.testing.assert_close(s, rs, rtol=0, atol=0)
    cot = [torch.randn(o.shape, generator=torch.Generator().manual_seed(1)),
           torch.randn(s.shape, generator=torch.Generator().manual_seed(2))]
    grads = torch.autograd.grad((o, s), got_in, cot, allow_unused=True)
    ref = torch.autograd.grad((ro, rs), ref_in, cot, allow_unused=True)
    assert len(calls) == (2 if remat else 1)
    for i, (g, r, t) in enumerate(zip(grads, ref, got_in)):
        if i == 4 and not u_arg:
            assert r is None and (g is None or not g.any())
            continue
        assert g.dtype == t.dtype, i
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_scan_function_with_one_output_used(monkeypatch):
    """Only o reaches the loss (training drops the final state): the
    backward gets no cotangent for the state and still returns every
    input's gradient."""
    monkeypatch.setattr(scan_ops, "linear_scan_kernel",
                        _stand_in_kernel([]))
    base = _scan_inputs(6, torch.float32)
    got_in = [t.clone().requires_grad_() for t in base]
    ref_in = [t.clone().requires_grad_() for t in base]
    o, _ = scan_ops._LinearScanKernel.apply(*got_in, "rwkv6", 16)
    ro, _ = linear_scan_chunked(*ref_in[:5], mode="rwkv6", chunk=16,
                                initial_state=ref_in[5])
    for g, r in zip(torch.autograd.grad(o.square().sum(), got_in),
                    torch.autograd.grad(ro.square().sum(), ref_in)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["rwkv6", "ssd"])
def test_chunked_scan_gradient_is_finite_where_jax_returns_nan(mode):
    """Strong decays (a chunk's summed log decay far past -88): JAX's
    chunked reference takes exp of the masked pairs' positive differences,
    which overflow, and its gradient is NaN; the port's masks them before
    the exp, and its gradient equals JAX's sequential oracle's."""
    q, k, v, w, u, _ = [t.numpy() for t in _scan_inputs(7, torch.float32,
                                                        strong=True)]
    w = w * 10.0                    # decays down to exp(-74) a step
    cot = np.random.default_rng(8).normal(size=v.shape).astype(np.float32)

    def jax_grads(fn, **kw):
        loss = lambda *a: jnp.sum(fn(*a, u=jnp.asarray(u), mode=mode,
                                     **kw)[0] * cot)
        return jax.grad(loss, argnums=(0, 1, 2, 3))(
            *(jnp.asarray(x) for x in (q, k, v, w)))

    nan = jax_grads(jax_chunked, chunk=16)
    assert any(np.isnan(np.asarray(g)).any() for g in nan)
    oracle = jax_grads(jax_seq)
    ins = [torch.tensor(x, requires_grad=True) for x in (q, k, v, w)]
    o, _ = linear_scan_chunked(*ins, torch.tensor(u), mode=mode, chunk=16)
    mine = torch.autograd.grad((o * torch.tensor(cot)).sum(), ins)
    for g, r in zip(mine, oracle):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4,
                                   atol=2e-4)
