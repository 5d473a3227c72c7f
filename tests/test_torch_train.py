"""The port's training pieces against the JAX package's, on the CPU: the
token stream, the optimizers and the schedule, gradient compression, the
train state carried across from a JAX run, the fault-tolerant loop (a
bit-exact resume after an injected preemption, also with a straggler at
every step) and `launch/train.py --arch`.

Inputs are numpy arrays from a seed, handed to both packages.  The JAX
side runs as its own tests run it (the jnp paths).  Tolerance: f32 with
the same formulas, so rtol = atol = 1e-5 for the optimizers (transcendental
functions rounded apart) and 1e-4 for whole train steps (the port's LM
parity tolerance); the token stream and a CPU resume are exact.
"""
from __future__ import annotations

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro.configs import get_arch as jax_get_arch
from repro.data.tokens import TokenStream as JaxTokenStream
from repro.distributed import compression as jcomp
from repro.models.zoo import build as jax_build
from repro.train import optimizer as jopt
from repro.train.train_state import init_state as jax_init_state
from repro.train.train_state import make_train_step as jax_make_train_step
from repro_torch.configs import get_arch
from repro_torch.convert import train_state_from_jax
from repro_torch.data.tokens import TokenStream
from repro_torch.distributed.compression import Compressor
from repro_torch.distributed.compression import (dequantize_int8,
                                                 int8_compressor,
                                                 quantize_int8,
                                                 topk_compressor)
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     SimulatedPreemption)
from repro_torch.models.zoo import build
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import latest_step, tree_flatten
from repro_torch.train.loop import LoopConfig, run_loop
from repro_torch.train.train_state import init_state, make_train_step

OPT_TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, dtype=np.float32), **tol,
                               err_msg=what)


def _batches(batch, device="cpu"):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


# --------------------------------------------------------------------------- #
# TokenStream
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("d_frontend", [None, 24])
def test_token_stream_batches_are_byte_identical(d_frontend):
    kw = dict(vocab=300, batch=3, seq_len=40, seed=7, d_frontend=d_frontend)
    mine, ref = TokenStream(**kw), JaxTokenStream(**kw)
    for step in (0, 1, 5, 123):
        a, b = mine.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b) == (["enc_x", "tokens"] if d_frontend
                                          else ["tokens"])
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), (step, k)
    for ours, theirs in ((iter(mine), iter(ref)),
                         (mine.iter_from(9), ref.iter_from(9))):
        for _ in range(3):
            a, b = next(ours), next(theirs)
            assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    assert mine.batch_at(4)["tokens"].max() < 300


# --------------------------------------------------------------------------- #
# Optimizers and the schedule
# --------------------------------------------------------------------------- #
def _tree(rng, scale=1.0):
    """A params-shaped tree with factored (>= 128 x 128, a leading batch
    axis too) and unfactored leaves, as numpy f32."""
    f = lambda *s: (scale * rng.normal(size=s)).astype(np.float32)
    return {"a": f(130, 140), "b": [f(2, 129, 128), f(5)], "c": f(7, 3)}


def _to_port(tree):
    return opt.tree_map(lambda a: torch.tensor(a), tree)


def _run(port_opt, jax_opt, steps=4, params_scale=1.0, grad_scales=None):
    """`steps` updates of both optimizers from one params tree, each step on
    fresh numpy grads; returns every step's (port, JAX) updates, states and
    params."""
    rng = np.random.default_rng(0)
    p_np = _tree(rng, params_scale)
    p, jp = _to_port(p_np), jax.tree.map(jnp.asarray, p_np)
    s, js = port_opt.init(p), jax_opt.init(jp)
    out = []
    for i in range(steps):
        g_np = _tree(rng, 1.0 if grad_scales is None else grad_scales[i])
        u, s = port_opt.update(_to_port(g_np), s, p)
        ju, js = jax_opt.update(jax.tree.map(jnp.asarray, g_np), js, jp)
        p, jp = opt.apply_updates(p, u), jopt.apply_updates(jp, ju)
        out.append(((u, s, p), (ju, js, jp)))
    return out


def _leaves_close(mine, ref, tol, what):
    got = [x for x in tree_flatten(mine)[0]]
    want = jax.tree.leaves(ref)
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        _close(torch.as_tensor(a), b, tol, f"{what} leaf {i}")


@pytest.mark.parametrize("name", ["sgd", "sgd-clip", "adafactor",
                                  "adafactor-rms-clip", "adamw-cosine"])
def test_optimizers_match_jax(name):
    """sgd (momentum, with and without clipping), adafactor (factored and
    unfactored leaves, a step whose RMS clip binds) and adamw on the cosine
    schedule with weight decay: updates, state and params after each of 4
    steps."""
    sched = lambda mod: mod.cosine_schedule(0.05, 2, 4)
    pairs = {
        "sgd": lambda m: m.sgd(lr=0.1),
        "sgd-clip": lambda m: m.sgd(lr=sched(m), clip_norm=1.0),
        "adafactor": lambda m: m.adafactor(lr=0.05),
        "adafactor-rms-clip": lambda m: m.adafactor(lr=sched(m),
                                                    clip_threshold=0.5),
        "adamw-cosine": lambda m: m.adamw(lr=sched(m), weight_decay=0.1),
    }
    scales = [1.0, 50.0, 1e-3, 1.0]
    for i, ((u, s, p), (ju, js, jp)) in enumerate(_run(
            pairs[name](opt), pairs[name](jopt), grad_scales=scales)):
        _leaves_close(u, ju, OPT_TOL, f"{name} step {i} updates")
        _leaves_close(s, js, OPT_TOL, f"{name} step {i} state")
        _leaves_close(p, jp, OPT_TOL, f"{name} step {i} params")
        assert int(s.step) == i + 1 and s.step.dtype == torch.int32


def test_adafactor_state_shapes_match_jax():
    rng = np.random.default_rng(1)
    p_np = _tree(rng)
    s = opt.adafactor().init(_to_port(p_np))
    js = jopt.adafactor().init(jax.tree.map(jnp.asarray, p_np))
    for mine, ref in ((s.vr, js.vr), (s.vc, js.vc)):
        assert [tuple(x.shape) for x in tree_flatten(mine)[0]] == \
            [x.shape for x in jax.tree.leaves(ref)]
    assert tuple(s.vr["a"].shape) == (130,) and tuple(s.vc["a"].shape) == \
        (140,)                                  # factored
    assert tuple(s.vr["c"].shape) == (7, 3)     # unfactored: the full v


def test_cosine_schedule_matches_jax():
    mine, ref = opt.cosine_schedule(3e-3, 10, 50), jopt.cosine_schedule(
        3e-3, 10, 50)
    for step in range(0, 60, 3):
        got = mine(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(ref(step)), rtol=1e-6)
    assert float(mine(0)) == 0.0 and float(mine(10)) == pytest.approx(3e-3)


@pytest.mark.parametrize("name", ["adamw", "sgd", "adafactor"])
def test_donated_update_is_the_functional_update(name):
    """`donate=True` writes the new moments and params into the old tensors
    and gives the same numbers, bit for bit, as the functional update,
    which leaves its arguments untouched."""
    make = {"adamw": lambda: opt.adamw(lr=opt.cosine_schedule(0.01, 2, 5),
                                       weight_decay=0.1),
            "sgd": lambda: opt.sgd(lr=0.1),
            "adafactor": lambda: opt.adafactor(lr=0.05)}[name]
    o = make()
    rng = np.random.default_rng(2)
    p_np = _tree(rng)
    ref_p, don_p = _to_port(p_np), _to_port(p_np)
    ref_s, don_s = o.init(ref_p), o.init(don_p)
    for _ in range(3):
        g = _to_port(_tree(rng))
        before = [x.clone() for x in tree_flatten(ref_s)[0]]
        u, new_ref_s = o.update(g, ref_s, ref_p)
        assert all(torch.equal(a, b) for a, b in zip(
            before, tree_flatten(ref_s)[0]))          # untouched
        ref_p, ref_s = opt.apply_updates(ref_p, u), new_ref_s
        old_ids = [id(x) for x in tree_flatten(don_s)[0][1:]]
        du, don_s = o.update(g, don_s, don_p, donate=True)
        p_ids = [id(x) for x in opt.tree_leaves(don_p)]
        don_p = opt.apply_updates(don_p, du, donate=True)
        assert [id(x) for x in opt.tree_leaves(don_p)] == p_ids
        assert [id(x) for x in tree_flatten(don_s)[0][1:]] == old_ids
        for a, b in zip(tree_flatten((ref_p, ref_s))[0],
                        tree_flatten((don_p, don_s))[0]):
            assert torch.equal(a, b)


def test_clip_promotes_bf16_grads_to_f32_as_jax():
    g = {"w": torch.tensor([3.0, 4.0], dtype=torch.bfloat16)}
    clipped, norm = opt.clip_by_global_norm(g, 1.0)
    jclipped, jnorm = jopt.clip_by_global_norm(
        {"w": jnp.asarray([3.0, 4.0], jnp.bfloat16)}, 1.0)
    assert clipped["w"].dtype == torch.float32 == \
        getattr(torch, str(jclipped["w"].dtype))
    _close(clipped["w"], jclipped["w"], OPT_TOL)
    assert float(norm) == pytest.approx(float(jnorm))


# --------------------------------------------------------------------------- #
# Gradient compression (tests/test_compression.py's cases, ported)
# --------------------------------------------------------------------------- #
@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.floats(1e-3, 1e3))
def test_int8_quantization_error_bound(seed, scale):
    x_np = (np.random.default_rng(seed).normal(size=64) * scale).astype(
        np.float32)
    q, s = quantize_int8(torch.tensor(x_np))
    x_hat = dequantize_int8(q, s)
    assert q.dtype == torch.int8
    # error bounded by half a quantization step; equal to JAX's
    assert float(torch.max(torch.abs(torch.tensor(x_np) - x_hat))) <= \
        float(s) * 0.5 + 1e-6
    jq, js = jcomp.quantize_int8(jnp.asarray(x_np))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == pytest.approx(float(js), rel=1e-7)


def test_topk_error_feedback_sums_to_identity():
    """Over many steps, sum(sent) == sum(grads): error feedback loses
    nothing (telescoping residual); every step's sent grads and error equal
    JAX's."""
    comp, jc = topk_compressor(keep_frac=0.25), jcomp.topk_compressor(0.25)
    rng = np.random.default_rng(0)
    g_total = torch.zeros(32)
    sent_total = torch.zeros(32)
    err = jerr = None
    for _ in range(20):
        g_np = rng.normal(size=32).astype(np.float32)
        g = {"w": torch.tensor(g_np)}
        g_total = g_total + g["w"]
        sent, err = comp.apply(g, err)
        jsent, jerr = jc.apply({"w": jnp.asarray(g_np)}, jerr)
        _close(sent["w"], jsent["w"], OPT_TOL)
        _close(err["w"], jerr["w"], OPT_TOL)
        sent_total = sent_total + sent["w"]
    np.testing.assert_allclose((sent_total + err["w"]).numpy(),
                               g_total.numpy(), rtol=1e-5, atol=1e-5)


def test_topk_sparsity():
    comp = topk_compressor(keep_frac=0.1)
    g = {"w": torch.tensor(np.random.default_rng(1).normal(size=1000),
                           dtype=torch.float32)}
    sent, err = comp.apply(g, None)
    assert int(torch.sum(sent["w"] != 0.0)) <= 110       # ~10% kept
    assert comp.wire_bytes_per_param() < 4.0              # beats raw f32
    assert comp.wire_bytes_per_param() == \
        jcomp.topk_compressor(0.1).wire_bytes_per_param()


def test_int8_compressor_pytree():
    comp = int8_compressor()
    g = {"a": torch.ones((4, 4)) * 3.0, "b": torch.linspace(-1, 1, 16)}
    out, err = comp.apply(g, None)
    assert err is None
    np.testing.assert_allclose(out["a"].numpy(), 3.0, rtol=1e-2)
    jout, _ = jcomp.int8_compressor().apply(
        {"a": jnp.ones((4, 4)) * 3.0, "b": jnp.linspace(-1, 1, 16)}, None)
    _close(out["b"], jout["b"], OPT_TOL)


@pytest.mark.parametrize("kind", ["topk", "int8", "topk+int8"])
def test_grouped_leaves_compress_as_one_stacked_jax_leaf(kind):
    """The port keeps a leaf per layer where JAX stacks them: leaves of one
    `group` share the top-k threshold and the int8 scale, so three [8, 5]
    layers compress exactly as JAX's one [3, 8, 5] leaf."""
    rng = np.random.default_rng(4)
    stacked = (rng.normal(size=(3, 8, 5)) * np.array([[[1.0]], [[10.0]],
                                                      [[0.1]]])).astype(
        np.float32)
    bias = rng.normal(size=7).astype(np.float32)
    kw = {"topk": dict(keep_frac=0.2), "int8": dict(keep_frac=None,
                                                    int8=True),
          "topk+int8": dict(keep_frac=0.2, int8=True)}[kind]
    jc = jcomp.Compressor(**kw)
    pc = Compressor(**kw, group=lambda p: p.split("/")[0])
    jg = {"w": jnp.asarray(stacked), "b": jnp.asarray(bias)}
    g = {"w": [torch.tensor(x) for x in stacked], "b": torch.tensor(bias)}
    jerr = err = None
    for _ in range(2):
        jsent, jerr = jc.apply(jg, jerr)
        sent, err = pc.apply(g, err)
        _close(torch.stack(sent["w"]), jsent["w"], OPT_TOL)
        _close(sent["b"], jsent["b"], OPT_TOL)
        if jerr is not None:
            _close(torch.stack(err["w"]), jerr["w"], OPT_TOL)
    # per layer, without the group, the middle layer would keep them all
    if kw["keep_frac"]:
        alone, _ = Compressor(**kw).apply(g, None)
        assert int((alone["w"][0] != 0).sum()) > 0
        assert int((sent["w"][0] != 0).sum()) < int(
            (alone["w"][0] != 0).sum())


# --------------------------------------------------------------------------- #
# A JAX run continued by the port
# --------------------------------------------------------------------------- #
def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def test_train_state_from_jax_continues_a_jax_run():
    """qwen3-8b SMOKE, AdamW on the cosine schedule: 3 JAX steps, the
    state carried across with `train_state_from_jax`, then 2 port steps
    give JAX's 5-step params, moments and step counters within 1e-4."""
    arch = "qwen3-8b"
    jcfg, cfg = jax_get_arch(arch).smoke, get_arch(arch).smoke
    japi, api = jax_build(jcfg, max_position=16), build(cfg, max_position=16)
    stream = TokenStream(vocab=cfg.vocab, batch=2, seq_len=16, seed=3)
    jo = jopt.adamw(lr=jopt.cosine_schedule(3e-3, 2, 5), weight_decay=0.1)
    jstep = jax.jit(jax_make_train_step(japi.loss, jo))
    jstate = jax_init_state(japi.init(jax.random.PRNGKey(0)), jo)
    states = []
    for i in range(5):
        jstate, _ = jstep(jstate, stream.batch_at(i))
        states.append(_np(jstate))
    o = opt.adamw(lr=opt.cosine_schedule(3e-3, 2, 5), weight_decay=0.1)
    state = train_state_from_jax(states[2], cfg)
    assert state["step"].dtype == state["opt"].step.dtype == torch.int32
    assert int(state["step"]) == int(state["opt"].step) == 3
    step = make_train_step(api.loss, o)
    for i in (3, 4):
        state, _ = step(state, _batches(stream.batch_at(i)))
    want = train_state_from_jax(states[4], cfg)
    assert int(state["step"]) == int(want["step"]) == 5
    for (a, pa), b in zip(zip(*tree_flatten(state)), tree_flatten(want)[0]):
        _close(a, b.numpy(), STEP_TOL, pa)


# --------------------------------------------------------------------------- #
# The fault-tolerant loop (tests/test_fault_tolerance.py's resume, ported)
# --------------------------------------------------------------------------- #
def _setup():
    api = build(get_arch("qwen3-8b").smoke)
    o = opt.adamw(lr=1e-3)
    state = init_state(api.init(seed=0, device="cpu"), o)
    stream = TokenStream(vocab=api.cfg.vocab, batch=2, seq_len=16)
    return make_train_step(api.loss, o), state, stream


def _resume(tmp_path, step_fn, state0, stream, fail_at=5,
            straggler_threshold=3.0):
    """Checkpoint every 2 steps, die at `fail_at`, restart from the newest
    checkpoint on the stream seeked to it; returns (the newest committed
    step seen right after the preemption, the resumed state, history)."""
    ckpt_dir = str(tmp_path / "ckpt")
    quiet = dict(log_every=100, log_fn=lambda _: None,
                 straggler_threshold=straggler_threshold)
    cfg2 = LoopConfig(total_steps=8, ckpt_dir=ckpt_dir, ckpt_every=2,
                      injector=FailureInjector(fail_at_step=fail_at), **quiet)
    threads = set(threading.enumerate())
    with pytest.raises(SimulatedPreemption):
        run_loop(step_fn, state0, (_batches(b) for b in stream), cfg2)
    # no checkpoint writer outlives the preempted run
    assert not [t for t in threading.enumerate()
                if t not in threads and t.is_alive()]
    start = latest_step(ckpt_dir)
    assert start is not None and 0 < start < 8
    assert not list((tmp_path / "ckpt").glob(".tmp_step_*"))
    cfg3 = LoopConfig(total_steps=8, ckpt_dir=ckpt_dir, ckpt_every=2,
                      **quiet)
    resumed, hist = run_loop(step_fn, state0,
                             (_batches(b) for b in stream.iter_from(start)),
                             cfg3)
    return start, resumed, hist


def test_failure_injection_bit_exact_resume(tmp_path):
    step_fn, state0, stream = _setup()
    # uninterrupted run: 8 steps
    cfg = LoopConfig(total_steps=8, ckpt_dir=None, log_every=100,
                     log_fn=lambda _: None)
    ref_state, ref_hist = run_loop(step_fn, state0,
                                   (_batches(b) for b in stream), cfg)
    start, resumed, hist = _resume(tmp_path, step_fn, state0, stream)
    for a, b in zip(opt.tree_leaves(ref_state["params"]),
                    opt.tree_leaves(resumed["params"])):
        assert torch.equal(a, b)
    assert [h["loss"] for h in hist] == [h["loss"]
                                         for h in ref_hist[start:]]
    assert int(resumed["step"]) == int(ref_state["step"]) == 8


@pytest.mark.parametrize("fail_at", [4, 5])
def test_resume_with_a_straggler_at_every_step(tmp_path, monkeypatch,
                                               fail_at):
    """A straggler threshold so low that every step after the first is a
    straggler: every save is forced one step early and written again by
    the regular cadence, and the preemption lands while a write is pending
    (at 4: the rewrite of step 4; at 5: the forced save of 5), on a disk
    made slow (each write starts 50 ms late).  The loop joins the writer
    before the exception leaves it, so the newest commit is the last step
    saved, no temporary directory is left, the restart reads no directory
    that is being replaced, and the resume is bit-exact, 5 times over."""
    real_write = ckpt_mod._write

    def slow_write(*args):
        time.sleep(0.05)
        return real_write(*args)
    monkeypatch.setattr(ckpt_mod, "_write", slow_write)
    step_fn, state0, stream = _setup()
    cfg = LoopConfig(total_steps=8, ckpt_dir=None, log_every=100,
                     log_fn=lambda _: None)
    ref_state, _ = run_loop(step_fn, state0, (_batches(b) for b in stream),
                            cfg)
    for rep in range(5):
        start, resumed, _ = _resume(tmp_path / str(rep), step_fn, state0,
                                    stream, fail_at=fail_at,
                                    straggler_threshold=1e-9)
        assert start == fail_at, rep
        for a, b in zip(opt.tree_leaves(ref_state["params"]),
                        opt.tree_leaves(resumed["params"])):
            assert torch.equal(a, b), rep


# --------------------------------------------------------------------------- #
# launch/train.py --arch
# --------------------------------------------------------------------------- #
def test_train_lm_smoke_on_the_cpu(tmp_path, capsys):
    """`train_lm` at --smoke for 3 steps on the CPU (the tests' device):
    JAX's two print lines, finite losses, a final checkpoint, and the
    parameters the loop returns moved by the step; without a card the
    default device raises."""
    from repro_torch.launch.train import parser, train_lm
    args = parser().parse_args(["--arch", "rwkv6-3b", "--smoke", "--steps",
                                "3", "--batch", "2", "--seq-len", "32",
                                "--ckpt-dir", str(tmp_path / "ck"),
                                "--ckpt-every", "2"])
    state, hist = train_lm(args, device="cpu")
    out = capsys.readouterr().out
    assert "[train] rwkv6-3b (smoke): 174,208 params" in out
    assert "[train] done: loss" in out and "over 3 steps" in out
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert latest_step(tmp_path / "ck") == 3 and int(state["step"]) == 3
    init = build(get_arch("rwkv6-3b").smoke).init(seed=0, device="cpu")
    assert not torch.equal(state["params"]["embed"]["w"], init["embed"]["w"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_lm(args)
