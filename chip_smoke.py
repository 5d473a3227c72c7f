"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (src/repro_torch) only; it imports nothing of JAX.  Phases,
each of which raises on failure (the script then exits nonzero):

  1. build   the hand-written CUDA kernels from csrc/ (nvcc, one process per
             source, all started together);
  2. check   each kernel against its plain PyTorch version at the serving
             paths' shapes (plus a ragged batch, RK4 with m == 0, GRU with
             shared and per-slot weights, at H = 16, 48, 64, 96, 100, 128,
             136, T = 1, 50, B = 1 and the offline fleet's shape, forward
             and gradients; the offline paths' GRU at D = 2, 3 and F-8's
             recover over 776 windows, RK4 at every registered system's
             (n, m, order) and over one 6,000-step F-8 simulation; the
             kernels' wide paths: GRU at H = 160 and 256 (D = 4) and at
             H = 137 (D = 16, beside the fast paths' edge 136), RK4 at
             F8Crusader(n_aircraft=6) and (n_aircraft=11), 300 steps,
             forward and gradients; the linear scan in both modes, bf16
             and f32, with and without the bonus, ragged, short, carried
             and wide, and in ssd mode on Mamba-2's operands -- one value
             of decay a head broadcast over K, q and k shared by the heads
             -- at zamba2-7b's width (H=112, K=V=64, 2048 tokens) and at
             its SMOKE width K=V=16);
  3. serve   64 F-8 twins at the repo's own serving width
             (examples/online_twinning.py), warm-started with the true
             theta, 12 airframes damaged mid-stream, 40 ticks of 8 samples
             per twin, then predict and scenario requests;
  4. parity  the first 10 ticks again on the CPU (plain versions), per-tick
             losses and admissions held to the card's;
  4b. crash safety, at phase 3's width and telemetry: a snapshot after
             tick 10 written through train/checkpoint.py and restored into
             a fresh server, both then served 3 ticks (guard events equal,
             losses equal); a server checkpointed every 3 ticks with a
             telemetry journal, dropped at tick 20, restored from the
             newest commit, the journal suffix replayed (force=True) and
             served to the end (the flagged set is the uninterrupted run's,
             0 samples lost); the same with the newest commit torn (falls
             back one commit); 40 ticks with scheduler="reference" (the
             packed planner's plans, tick by tick); 40 ticks with
             async_ingest and 4 sensor threads (no sample lost or
             duplicated);
  5. LM      rwkv6-3b at its published width (32 layers, d_model 2560, bf16,
             random weights from a seed) behind a 4-slot ServeEngine: 8
             greedy requests, prompts of 256-2048 tokens, 32 new tokens each;
             then one more prefill and 4 decode steps under torch.profiler;
  6. LM parity  the same architecture at 2 layers in f32, card against CPU:
             prefill and 16 decode steps' logits, greedy tokens;
  7. offline model recovery: every registered system simulated on the card
             and on the CPU from the same draws; Table I's quick protocol
             (benchmarks/table1_accuracy.py) on F-8 and Lotka-Volterra:
             MERINDA, EMILY and PINN+SR fit and scored; F-8 training at
             hidden 96 (examples/train_f8_crusader.py), its polished
             recovery and MSE, its first 10 steps replayed on the CPU; the
             offline fleet of 16 twins (examples/fleet_twinning.py);
  9. fleet   (run before 8, whose kernel line reads every path's launches)
             the sharded and federated servers on the card, at the widths
             of the JAX package's example and benchmarks, uncut:
             conformance -- tests/test_service_conformance.py's scenario
             (8 Lotka-Volterra twins, guard-only, twins 2 and 5 damaged)
             on TwinServer, ShardedTwinServer (2 shards) and
             FederatedTwinServer (2 workers), event streams identical;
             sharded -- examples/sharded_fleet.py (F-8, Van der Pol and
             Lotka-Volterra, 384 each, one shard a family, 12 slots in
             all, 16 damaged F-8s, 40 ticks, 20 warm-up; every damaged
             F-8 flagged), then 8 ticks with synchronous ingest card
             against CPU (grants, plans, losses); scale --
             benchmarks/online_scale.py's quick headline points (1,000
             and 10,000 F-8 twins on 4 shards, 18 + 10 ticks; the guard-ms
             ratio printed, not gated); federated --
             benchmarks/online_federated.py's quick preset (10,000 twins
             in 4 worker processes, each with its own CUDA context;
             1,000 in 2 through the TCP front door; the kill row: 1,000
             twins in 4 workers, the last killed at tick 22, restarted
             after 1 tick from its checkpoint and the journal: 0 samples
             lost, its grant to the survivors while down, its pressure EMA
             held).  Any shard or worker death the chaos schedule did not
             order fails the phase.  Workers prove they ran on the card by
             their own launch counters (read over the wire) and by
             nvidia-smi's compute processes (where nvidia-smi sees
             another pid namespace it names every process pid 1, and
             their count stands in);
 10. LM zoo (run before 8): zamba2-7b and qwen3-8b at full width and
             cut depth (42 of 81 Mamba-2 layers + 7 shared-block
             invocations, d_model 3584; 12 of 36 attention layers, d_model
             4096; bf16, random weights from a seed), each behind a 4-slot
             ServeEngine with phase 5's protocol (8 greedy requests of
             256-2048 tokens, 32 new tokens; the zamba2 prefill path
             launches the scan exactly 42 times a request, decode and
             qwen3 none), then one more prefill
             and 4 decode steps under torch.profiler; the scan held to its
             plain version on the operands it got from one zamba2 layer
             of a 2048-token prefill; then the six architectures of the
             slice card against CPU in f32, the same weights, prefill and 8
             greedy decode steps (tokens equal, logits within LM_TOL), at
             full width and cut depth: zamba2 7 layers (a cycle of 6 and
             a 1-layer tail: both shared-block sites), qwen3, starcoder2,
             chatglm3 and chameleon 2 layers, gemma3 6 (a local x5 + global
             cycle) with an 1,100-token prompt, past its 1,024 window, so
             the local layers' ring caches wrap;
 11. MoE and encoder-decoder (run before 8): mixtral-8x22b at full width,
             4 of its 56 layers (d_model 6144, GQA 48/8, 8 experts top-2
             of d_ff 16384, window 4096, capacity 1.25, group 512), and
             arctic-480b at full width, 2 of its 35 layers (d_model 7168,
             GQA 56/8, 128 experts top-2 of d_ff 4864 plus the dense FFN
             of 4864), bf16, random weights from a seed, each behind the
             4-slot ServeEngine with phase 5's protocol, every prompt of
             1,024 tokens or more rounded down to a multiple of 512 (the
             MoE groups must divide it); a 1,025-token prefill must raise
             moe_apply's ValueError on the card; one 2,048-token prefill's
             routing gated (no expert keeps more than C a group, the kept
             total equals the host's recount of the router's top-k);
             whisper-large-v3 at 16 + 16 of its 32 + 32 layers (d_model
             1280) with
             max_len 1,500, 8 requests of 1,500 frames (drawn x 0.1) and a
             4-token prompt, 32 new tokens; each model's prefill and 4
             decode steps profiled; then card against CPU in f32, the
             same weights, prefill and 8 greedy decode steps (tokens
             equal, logits within LM_TOL, MoE routing equal call by call,
             the router's smallest top-k margin printed): mixtral 2
             layers with a 300-token prompt, whisper 4 + 4 layers over
             1,500 frames, arctic at its SMOKE config;
 12. LM training (run before 8): the scan's gradient on the card (kernel
             forward, the plain version replayed in the backward) against
             the plain version's for q, k, v, w, u and the initial state
             at an rwkv6-3b layer's training shape (B=4, H=40, T=1024,
             bf16) and a zamba2-7b Mamba-2 layer's (ssd, H=112, T=2048),
             one launch a call; rwkv6-3b whole (32 layers, bf16, random
             weights from a seed) trained 20 steps of 4 x 1,024 tokens
             through launch/train.py's `train_lm` (AdamW, cosine schedule,
             the JAX package's defaults): losses finite and falling, the
             scan exactly 2 x 32 launches a step (each layer recomputed in
             the backward), ms a step, tokens/s, peak memory; the trained
             state's every leaf against `state_specs` (shape, dtype,
             bytes) and launch/dryrun.py's trace of the same step on meta
             tensors: its peak within 20% of max_memory_allocated, its
             roofline step time beside the measured one; one step
             profiled; the kill row (4 layers, a checkpoint every 2 steps
             under build/, preempted at step 5, restarted from the newest
             commit: 0 steps lost, params and losses as uninterrupted);
             then card against CPU in f32, the first step's gradients and
             3 steps' losses and params: rwkv6 2 layers, qwen3 2, zamba2
             7, whisper 4 + 4 at full width, mixtral and arctic at SMOKE
             with grad_accum=2 (arctic with the top-k compressor), their
             routing equal call by call;
  8. time    each kernel and its plain version at every serving and
             offline shape (GRU: the online tick's refit, the offline
             fleet's, F-8 training's and recovery's, Table I's
             Lotka-Volterra; RK4: refit, guard, promote, predict, scenario,
             a fleet of 2048, the F-8 and Lorenz simulations; the scan:
             prompts of 256-4096 tokens, 4 prompts of 2048, and zamba2-7b's
             Mamba-2 prefill of 2048 tokens), and the scan's three launches
             apart.

Kernel launch counts are set to 0 just before each path (tick, predict,
scenario, the crash-safety runs, LM prefill and decode of rwkv6, zamba2,
qwen3, mixtral, arctic and whisper, LM training and its kill and parity
rows, the offline ones:
simulate, each Table I fit and its scoring, F-8 training and recovery,
the offline fleet; and phase 9's in-process runs) and read just after it;
a path that launches none of its kernels, or one it does not run, fails.
A federated run's coordinator must launch nothing; its workers' counts
are read from them before and after the run ("<path>_workers").

The last three lines of output are the kernel JSON line, the card's name and
power limit (nvidia-smi), and {"ok": true, "device": {...}}.  Without a CUDA
device the script exits 1 and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

CHUNK = 8             # telemetry samples per twin per tick
HISTORY = 96          # samples each twin has streamed before the first tick
TWINS, DAMAGED, TICKS, DAMAGE_TICK, WARMUP = 64, 12, 40, 4, 3
PARITY_TICKS = 10
PROFILE_TICKS = 3     # extra ticks traced by torch.profiler after serving
# crash safety: the round trip's snapshot tick and the ticks served after it;
# the checkpoint cadence and the tick the server is dropped at; the sensor
# threads of the async-ingest run
ROUNDTRIP_TICK, ROUNDTRIP_AFTER, CKPT_EVERY, KILL_TICK, SENSORS = \
    10, 3, 3, 20, 4
CKPT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
# the kernels' wide paths: F8Crusader(n_aircraft=k) stacks (n = 3k > 16)
F8_STACKS, WIDE_RK4_B, WIDE_RK4_T = (6, 11), 2, 300
GRU_TOL = dict(rtol=0.0, atol=1e-5)        # fp32, sums in another order
RK4_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)      # backward replays the plain path
# linear scan against its plain chunked version: both sides upcast the same
# bf16 / f32 values and sum in f32 in another order -- the JAX package's f32
# tolerance between its chunked forms and the sequential oracle
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
# card against CPU, f32 LM logits: 2560- and 8960-long f32 dot products and
# the recurrence summed in another order, through 2 layers
LM_TOL = dict(rtol=1e-3, atol=1e-3)
LM_SLOTS, LM_REQUESTS, LM_NEW, LM_PROMPTS = 4, 8, 32, (256, 2048)
LM_PARITY_LAYERS, LM_PARITY_PROMPT, LM_PARITY_STEPS = 2, 300, 16
LM_PROFILE_STEPS = 4  # decode steps traced by torch.profiler after serving
# phase 10, the LM zoo: served at full width with phase 5's protocol
# (arch -> the prefix of its two launch-count paths and the layers served:
# zamba2 7 of its 13 cycles and 42 of its 81 layers, qwen3 12 of 36; cut
# from the whole models since LM training joined the script), and card
# against CPU in f32 at full width and cut depth, arch -> (layers, prompt):
# zamba2 one cycle of 6 and a 1-layer tail (the shared block at both of its
# sites), gemma3 one local x5 + global cycle with a prompt past its 1,024
# window (the local rings wrap), the dense ones 2 layers
ZOO_SERVED = {"zamba2-7b": ("lm_zamba2", 42), "qwen3-8b": ("lm_qwen3", 12)}
ZOO_PARITY = {"zamba2-7b": (7, 300), "qwen3-8b": (2, 300),
              "starcoder2-15b": (2, 300), "chatglm3-6b": (2, 300),
              "gemma3-12b": (6, 1100), "chameleon-34b": (2, 300)}
ZOO_PARITY_STEPS = 8
# the scan's operands are recorded from this zamba2 layer of a prefill of
# LM_PROMPTS[1] tokens (outside the counted run)
ZOO_RECORD_LAYER = 40
# phase 11, the MoE LMs and the encoder-decoder, served at full width with
# phase 5's protocol (arch -> (prefix, layers)): mixtral cut to 4 of its
# 56 layers (5.01 GB of bf16 a layer: 56 are 281 GB), arctic to 2 of 35
# (27.2 GB a layer), whisper to 16 + 16 of its 32 + 32 layers (these three
# cut further since LM training joined the script), its requests each
# Whisper's 30-s window after the conv frontend (1,500 frames) and a
# 4-token decoder prompt, its engine's max_len 1,500 (the JAX package's
# zoo sizes the cross caches at max_len).  A prefill of MOE_REFUSED tokens
# must raise (its groups do not divide it).  Card against CPU in f32:
# mixtral 2 layers at full width (about 20 GB a side), whisper 4 + 4
# layers, arctic its SMOKE config (one full-width f32 layer is 54 GB a
# side)
MOE_SERVED = {"mixtral-8x22b": ("lm_mixtral", 4),
              "arctic-480b": ("lm_arctic", 2)}
WHISPER_FRAMES, WHISPER_PROMPT, WHISPER_SERVED_LAYERS = 1500, 4, 16
MOE_REFUSED = 1025
PARITY_11 = {"mixtral-8x22b": dict(layers=2, prompt_len=300),
             "whisper-large-v3": dict(layers=4, prompt_len=WHISPER_PROMPT),
             "arctic-480b": dict(smoke=True, prompt_len=300)}
# phase 12, LM training.  The scan's gradient (kernel forward, the plain
# version replayed in the backward) against the plain version's at one
# rwkv6-3b layer's training shape and at a zamba2-7b Mamba-2 layer's, each
# leaf within SCAN_GRAD_REL of its envelope (max |g|): the cotangent of the
# loss mean(o^2) + mean(S^2) is the kernel's own o and S, within SCAN_TOL of
# the plain ones.  The bf16 leaves (q, k, v) get their gradients rounded to
# bf16, where one rounding apart is up to 2^-7 of the envelope: they are
# held within SCAN_GRAD_REL + 2^-7
SCAN_GRAD_REL = 1e-3
SCAN_GRAD_BF16_ULP = 2.0 ** -7
SCAN_GRAD_SHAPES = {"rwkv6-3b layer B=4 H=40 T=1024 rwkv6": (4, 40, 1024),
                    "zamba2-7b Mamba-2 B=1 H=112 T=2048 ssd": (1, 112, 2048)}
# rwkv6-3b whole through launch/train.py's entry point, the JAX package's
# defaults otherwise (lr 3e-3, cosine with 10 warm-up steps, weight decay
# 0.1, clipping at 1.0); ms a step is the median over steps 3-20
TRAIN_ARGS = ["--arch", "rwkv6-3b", "--steps", "20", "--batch", "4",
              "--seq-len", "1024", "--seed", "0"]
TRAIN_TIMED_FROM = 2
# the dry-run's traced peak against the card's allocated peak, relative
PLAN_PEAK_TOL = 0.20
# the kill row: rwkv6-3b at full width, 4 of 32 layers, 8 steps of the
# training batch, a checkpoint every 2 steps (the 2 newest kept: one is 6.8
# GB of bf16 params and f32 moments), preempted at step 5, restarted from
# the newest commit.  The card's sums need not repeat bit for bit, so the
# resumed params are held within 2 bf16 ulps of the uninterrupted run's
# and its losses within 1e-3; bit-exactness is printed, not gated
KILL_LM_LAYERS, KILL_LM_STEPS, KILL_LM_EVERY, KILL_LM_AT = 4, 8, 2, 5
KILL_LM_PARAM_REL, KILL_LM_LOSS_REL = 2.0 ** -7, 1e-3
TRAIN_CKPT_DIR = Path(__file__).resolve().parent / "build" / \
    "chip_smoke_train_ckpt"
# card against CPU in f32 from the same weights and tokens (batches of 2 x
# 32 tokens, Whisper over 32 frames): 3 steps of make_train_step, each
# step's loss, the first step's every gradient and every param after the
# third, each leaf within 1e-3 of its envelope.  The steps take SGD with
# momentum at train_lm's learning rate, 3e-3, unclipped (the host's passes
# over the full-width tables dominate these rows; an unclipped step of 0.1
# made the losses climb).  Not Adam: its first step is g / |g|, so a
# gradient within rounding of 0 flips its update by 2 lr and no envelope
# tolerance holds; SGD's step is linear in the gradient.  The MoE LMs run
# at SMOKE (one full-width f32 MoE layer with grads is over 20 GB a side on
# the host) with grad_accum=2, arctic with the top-k compressor, and their
# routing equal call by call
TRAIN_PARITY = {"rwkv6-3b": dict(layers=2), "qwen3-8b": dict(layers=2),
                "zamba2-7b": dict(layers=7),
                "whisper-large-v3": dict(layers=4),
                "mixtral-8x22b": dict(smoke=True, grad_accum=2),
                "arctic-480b": dict(smoke=True, grad_accum=2,
                                    compress=0.25)}
TRAIN_PARITY_B, TRAIN_PARITY_T, TRAIN_PARITY_STEPS = 2, 32, 3
TRAIN_REL = 1e-3
# the kernels each serving path must launch (the LM decode path none)
# the CUDA kernels of csrc/, as the profiler names them
OWN_KERNELS = ("gru_scan_kernel", "rk4_poly_kernel", "chunk_state_kernel",
               "state_scan_kernel", "chunk_output_kernel")
PATH_KERNELS = {"tick": ("gru_scan", "rk4_poly"), "predict": ("rk4_poly",),
                "scenario": ("rk4_poly",), "lm_prefill": ("linear_scan",),
                "lm_decode": (),
                # the LM zoo: every Mamba-2 layer's prefill runs the scan;
                # attention and every decode run no kernel of ours
                "lm_zamba2_prefill": ("linear_scan",),
                "lm_zamba2_decode": (),
                "lm_qwen3_prefill": (), "lm_qwen3_decode": (),
                # the MoE LMs and the encoder-decoder: einsums and
                # attention only
                "lm_mixtral_prefill": (), "lm_mixtral_decode": (),
                "lm_arctic_prefill": (), "lm_arctic_decode": (),
                "lm_whisper_prefill": (), "lm_whisper_decode": (),
                # offline recovery: simulation; Table I's fits (EMILY's and
                # PINN+SR's run plain PyTorch only) and its scoring (MERINDA's
                # recover encodes; every score integrates); F-8 training,
                # its recovery, the offline fleet
                "simulate": ("rk4_poly",),
                "table1_merinda": ("gru_scan", "rk4_poly"),
                "table1_emily": (), "table1_pinn_sr": (),
                "table1_score": ("gru_scan", "rk4_poly"),
                "train_f8": ("gru_scan", "rk4_poly"),
                "f8_recover": ("gru_scan", "rk4_poly"),
                "fleet_offline": ("gru_scan", "rk4_poly"),
                # crash safety: every run serves ticks
                "crash_roundtrip": ("gru_scan", "rk4_poly"),
                "crash_checkpointed": ("gru_scan", "rk4_poly"),
                "crash_replay": ("gru_scan", "rk4_poly"),
                "crash_torn": ("gru_scan", "rk4_poly"),
                "reference_planner": ("gru_scan", "rk4_poly"),
                "async_ingest": ("gru_scan", "rk4_poly"),
                # the fleet: every shard ticks in this process; a federated
                # run's coordinator launches nothing (its workers do, and
                # report their launches as "<path>_workers")
                "conformance_single": ("gru_scan", "rk4_poly"),
                "conformance_sharded": ("gru_scan", "rk4_poly"),
                "conformance_federated": (),
                "fleet_sharded": ("gru_scan", "rk4_poly"),
                "fleet_parity": ("gru_scan", "rk4_poly"),
                "scale_1k": ("gru_scan", "rk4_poly"),
                "scale_10k": ("gru_scan", "rk4_poly"),
                "federated_10k": (), "federated_tcp": (),
                "federated_kill": (),
                # LM training: every RWKV-6 and Mamba-2 layer's forward,
                # twice a step (the backward recomputes it); the card
                # sides of the parity rows summed
                "lm_train": ("linear_scan",),
                "lm_train_resume": ("linear_scan",),
                "lm_train_parity": ("linear_scan",)}
# the offline phase, cut to its budget (about 3 minutes on the card):
# Table I's quick protocol (benchmarks/table1_accuracy.py: 400 steps, two
# seeds, four systems) at 100 steps, one seed, F-8 and Lotka-Volterra;
# F-8 training (examples/train_f8_crusader.py: 400 steps) at 100 (both cut
# from 200 since LM training joined the script); the offline fleet
# (examples/fleet_twinning.py) uncut
TABLE1_SYSTEMS, TABLE1_STEPS = ("f8_crusader", "lotka_volterra"), 100
F8_STEPS, F8_PARITY_STEPS, FLEET_STEPS = 100, 10, 60
# card against CPU, whole simulations: each trace within this share of its
# envelope.  Lorenz is chaotic (largest Lyapunov exponent about 0.9/s): over
# its 4-s horizon rounding differences grow about e^3.6 = 37-fold, and
# float32 against float64 on the CPU already differ by 3e-4 of the envelope
SIM_REL = {"lorenz": 1e-2}
SIM_REL_DEFAULT = 1e-4
# RK4's wide path, gradients of sum(ys^2) through 300 steps of an 11-
# airframe F-8 stack: each leaf within this share of its envelope (max |g|).
# Elementwise 1e-4 / 1e-5 does not hold for float32 itself there (the plain
# version in float32 against float64 fails it at entries near 0); phase 2
# prints that yardstick's envelope share beside the kernel's
WIDE_GRAD_REL = 1e-4
# phase 9, the fleet.  Conformance: tests/test_service_conformance.py's
# scenario (8 Lotka-Volterra twins, guard-only; healthy, damaged and
# recovering ticks).  The sharded fleet: examples/sharded_fleet.py's
# defaults (3 families x 384, 16 damaged F-8s, 40 ticks, 20 warm-up), then
# 8 ticks card against CPU.  Scale: benchmarks/online_scale.py's quick
# headline points (4 shards, 18 warm-up + 10 measured ticks, guard budget
# 128).  Federation: benchmarks/online_federated.py's quick preset (10,000
# twins in 4 workers; 1,000 in 2 through the TCP front door; the kill row,
# 1,000 twins in 4 workers, 12 measured ticks)
CONF_TWINS, CONF_DAMAGED, CONF_PER_TICK, CONF_TICKS = 8, (2, 5), 10, \
    (4, 6, 6)
FLEET_PER_FAMILY, FLEET_DAMAGED, FLEET_TICKS, FLEET_WARMUP = 384, 16, 40, 20
FLEET_PARITY_TICKS = 8
SCALE_TWINS, SCALE_SHARDS, SCALE_WARMUP, SCALE_TICKS = (1_000, 10_000), 4, \
    18, 10
SCALE_GUARD_BUDGET = 128
FED_TWINS, FED_WORKERS, FED_TCP = 10_000, 4, (1_000, 2)
KILL_TWINS, KILL_WORKERS, KILL_TICKS = 1_000, 4, 12
FLEET_CKPT_DIR = Path(__file__).resolve().parent / "build" / \
    "chip_smoke_fleet_ckpt"


def _server_config():
    from repro_torch.core.merinda import MerindaConfig
    from repro_torch.twin.monitor import GuardConfig
    from repro_torch.twin.server import TwinServerConfig
    return TwinServerConfig(
        merinda=MerindaConfig(n=3, m=1, order=3, dt=0.01, hidden=32,
                              head_hidden=32, n_active=24),
        max_twins=TWINS, refit_slots=8, capacity=256, window=24, stride=8,
        windows_per_twin=8, steps_per_tick=2, sparsify_after=40,
        deploy_after=16, min_residency=4, max_residency=24,
        guard=GuardConfig(window=32), deadline_s=1.0)


def _systems():
    """Nominal and elevator-damaged F-8 (`DamagedF8`, as in
    examples/online_twinning.py), confined to the trim neighbourhood as
    that example does (half the y0 range, inputs 0.03)."""
    from repro_torch.systems.f8_crusader import F8Crusader, f8_rows

    class DamagedF8(F8Crusader):
        """Partial elevator loss: every input-dependent coefficient scaled
        by `effectiveness`."""

        def __init__(self, effectiveness: float = 0.25):
            super().__init__()
            self.effectiveness = effectiveness

        def rows(self):
            return [{k: (v * self.effectiveness if "u0" in k else v)
                     for k, v in row.items()} for row in f8_rows()]

    def trim(system):
        spec = system.spec
        system.spec = dataclasses.replace(
            spec, y0_low=tuple(0.5 * v for v in spec.y0_low),
            y0_high=tuple(0.5 * v for v in spec.y0_high), input_scale=0.03)
        return system
    return trim(F8Crusader()), trim(DamagedF8())


def telemetry(device, seed: int = 0):
    """Host arrays ys [TWINS, HISTORY + (TICKS+PROFILE_TICKS)*CHUNK + 1, 3],
    us [..., 1]:
    all airframes nominal until DAMAGE_TICK, then the first DAMAGED lose
    three quarters of their elevator authority."""
    from repro_torch.systems.simulate import simulate_batch, simulate_from
    nominal, damaged = _systems()
    gen = torch.Generator().manual_seed(seed)
    pre = HISTORY + DAMAGE_TICK * CHUNK
    post = (TICKS + PROFILE_TICKS - DAMAGE_TICK) * CHUNK
    tr1 = simulate_batch(nominal, gen, TWINS, horizon=pre, noise_std=0.002,
                         device=device)
    us2 = nominal.sample_inputs(gen, post, (TWINS,)).movedim(0, 1)
    tr2 = simulate_from(nominal, tr1.ys[:, -1], us2, noise_std=0.002,
                        generator=gen, device=device)
    trd = simulate_from(damaged, tr1.ys[:DAMAGED, -1], us2[:DAMAGED],
                        noise_std=0.002, generator=gen, device=device)
    noisy2 = tr2.ys_noisy.clone()
    noisy2[:DAMAGED] = trd.ys_noisy
    ys = torch.cat([tr1.ys_noisy[:, :-1], noisy2], dim=1).cpu().numpy()
    us = torch.cat([tr1.us.cpu(), us2], dim=1).numpy()
    return ys, us


def _stream(srv, ys, us, t: int, journal=None):
    """Tick t's CHUNK samples per twin (journaled first, when a journal is
    given), then one tick."""
    lo = HISTORY + t * CHUNK
    batch = [(i, ys[i, lo:lo + CHUNK], us[i, lo:lo + CHUNK])
             for i in range(TWINS)]
    if journal is not None:
        for chunk in batch:
            journal.append(*chunk)
    srv.ingest_many(batch)
    return srv.tick()


def _fresh_server(device, ys, us, journal=None, **overrides):
    """A server of `_server_config()` (with `overrides`), every twin
    warm-started with the true theta and HISTORY samples streamed."""
    from repro_torch.twin.server import TwinServer
    srv = TwinServer(dataclasses.replace(_server_config(), **overrides),
                     device=device)
    nominal, _ = _systems()
    srv.deploy_many(range(TWINS), nominal.true_theta(srv.fleet.model.lib))
    history = [(i, ys[i, :HISTORY], us[i, :HISTORY]) for i in range(TWINS)]
    if journal is not None:
        for chunk in history:
            journal.append(*chunk)
    srv.ingest_many(history)
    return srv


def serve(device, ys, us, ticks: int):
    """Warm-start every twin with the true theta, stream HISTORY samples,
    then `ticks` ticks of CHUNK samples per twin.  Returns (server,
    reports)."""
    srv = _fresh_server(device, ys, us)
    reports = []
    for t in range(ticks):
        reports.append(_stream(srv, ys, us, t))
        if t + 1 == WARMUP:
            srv.reset_latency_stats()
    return srv, reports


# --------------------------------------------------------------------------- #
# kernel checks and timing
# --------------------------------------------------------------------------- #
def _gru_inputs(gen, dev, lead, fleet, T=24, H=32, D=4):
    wl = (fleet,) if fleet else ()
    rand = lambda *s: torch.rand(s, generator=gen) * 2 - 1
    return [(rand(*lead, T, D)).to(dev),
            (0.1 * rand(*lead, H)).to(dev),
            (rand(*wl, D, 3 * H) / D ** 0.5).to(dev),
            (rand(*wl, H, 3 * H) / H ** 0.5).to(dev),
            (0.1 * rand(*wl, 3 * H)).to(dev)]


def _rk4_inputs(gen, dev, lead, T, m):
    from repro_torch.core.library import make_library
    nominal, _ = _systems()
    lib = make_library(3, m, 3)
    if m:
        base = torch.as_tensor(nominal.true_theta(lib), dtype=torch.float32)
    else:
        base = torch.zeros(3, lib.size)
        base[0, 1], base[1, 3], base[2, 1] = -0.9, 1.0, -4.2
    theta = base + 0.05 * torch.randn(lead + (3, lib.size), generator=gen)
    y0 = 0.1 * torch.randn(lead + (3,), generator=gen)
    us = 0.03 * torch.randn(lead + (T, m), generator=gen)
    return lib, [t.to(dev) for t in (theta, y0, us)]


def _system_rk4_inputs(name, gen, dev, B, T, substeps=1, dense=0.01):
    """A registered system's (or, for a system instance, that system's) own
    library and coefficients, each instance's perturbed by 5% (plus `dense`
    on every term), y0 and inputs drawn from its spec; the inputs repeated
    `substeps` times for a simulation's fine grid.  Returns (lib, dt,
    [theta, y0, us])."""
    from repro_torch.systems.simulate import register_systems
    system = register_systems()[name]() if isinstance(name, str) else name
    lib = system.library()
    true = torch.as_tensor(system.true_theta(lib), dtype=torch.float32)
    theta = (true * (1 + 0.05 * torch.randn((B,) + true.shape,
                                            generator=gen))
             + dense * torch.randn((B,) + true.shape, generator=gen))
    y0 = system.sample_y0(gen, (B,))
    us = system.sample_inputs(gen, T, (B,)).movedim(0, 1)
    us = us.repeat_interleave(substeps, dim=1).contiguous()
    return lib, system.spec.dt / substeps, [t.to(dev) for t in (theta, y0,
                                                                us)]


def _grads(fn, args):
    args = [a.detach().clone().requires_grad_() for a in args]
    outs = fn(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum(torch.sum(o * o) for o in outs).backward()
    return [o.detach() for o in outs], [a.grad for a in args]


def _close_traces(name, got, want, rel):
    """Trajectories [B, T+1, n]: a trace the plain version lets diverge
    (a non-finite value) must diverge on the card too; every finite one is
    held within `rel` times its envelope (max |y|).  Returns the worst
    absolute error over the finite traces."""
    bad_got = ~torch.isfinite(got).flatten(1).all(dim=1)
    bad_want = ~torch.isfinite(want).flatten(1).all(dim=1)
    if not torch.equal(bad_got.cpu(), bad_want.cpu()):
        raise RuntimeError(f"{name}: traces diverged on the card "
                           f"{bad_got.tolist()}, on the plain version "
                           f"{bad_want.tolist()}")
    ok = ~bad_want
    if not ok.any():
        return 0.0
    g, w = got[ok].double(), want[ok].double()
    err = (g - w).abs().flatten(1).max(dim=1).values
    limit = rel * w.abs().flatten(1).max(dim=1).values
    if (err > limit).any():
        raise RuntimeError(f"{name}: max |card - plain| per trace "
                           f"{err.tolist()} above {rel} of the envelope "
                           f"{limit.tolist()}")
    return float(err.max())


def _close(name, got, want, tol):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **tol, msg=lambda m: f"{name}: {m}")
    return max(float((g - w).abs().max()) for g, w in zip(got, want)
               if g.numel())


def check_kernels(dev):
    from repro_torch.kernels.gru.ops import gru_scan
    from repro_torch.kernels.gru.ref import gru_scan_ref
    from repro_torch.kernels.rk4.ops import rk4_poly_solve
    from repro_torch.kernels.rk4.ref import rk4_poly_solve_ref
    gen = torch.Generator().manual_seed(1)
    worst = {"gru_scan": 0.0, "rk4_poly": 0.0}
    gru_cases = [("refit F=8 B=8", (8, 8), 8, 24, 32),
                 ("ragged F=8 B=61", (8, 61), 8, 24, 32),
                 ("shared weights [2, 61]", (2, 61), None, 24, 32),
                 ("H=16 F=8 B=8", (8, 8), 8, 24, 16),
                 ("H=48 F=8 B=13", (8, 13), 8, 24, 48),
                 ("H=64 F=8 B=8", (8, 8), 8, 24, 64),
                 ("H=96 F=2 B=5", (2, 5), 2, 24, 96),
                 ("H=128 F=2 B=5", (2, 5), 2, 24, 128),
                 ("H=136 F=2 B=5", (2, 5), 2, 24, 136),
                 ("T=1 F=8 B=8", (8, 8), 8, 1, 32),
                 ("B=1 F=8", (8, 1), 8, 24, 32),
                 ("fleet F=16 B=32 H=64", (16, 32), 16, 24, 64),
                 ("H=100 F=2 B=5", (2, 5), 2, 24, 100),
                 ("T=50 F=8 B=8", (8, 8), 8, 50, 32),
                 ("T=50 H=100 F=2 B=5", (2, 5), 2, 50, 100),
                 # offline recovery: Table I's m = 0 systems (D = n = 2, 3)
                 # at hidden 64, and F-8's recover over all 776 windows
                 ("D=2 H=64 shared B=64", (64,), None, 24, 64, 2),
                 ("D=3 H=64 shared B=64", (64,), None, 24, 64, 3),
                 ("recover H=96 shared B=776", (776,), None, 24, 96, 4),
                 # the fast paths' edge at D = 16, and the wide path past
                 # it (Wh read through L2): H = 137, 160, 256
                 ("H=136 D=16 F=2 B=5", (2, 5), 2, 24, 136, 16),
                 ("wide H=137 D=16 F=2 B=5", (2, 5), 2, 24, 137, 16),
                 ("wide H=160 F=8 B=8", (8, 8), 8, 24, 160),
                 ("wide H=256 F=8 B=8", (8, 8), 8, 24, 256)]
    for label, lead, fleet, T, H, *D in gru_cases:
        args = _gru_inputs(gen, dev, lead, fleet, T, H, *D)
        outs, grads = _grads(gru_scan, args)
        ref_outs, ref_grads = _grads(gru_scan_ref, args)
        torch.cuda.synchronize()
        err = _close(f"gru {label}", outs, ref_outs, GRU_TOL)
        _close(f"gru {label} grads", grads, ref_grads, GRAD_TOL)
        worst["gru_scan"] = max(worst["gru_scan"], err)
        print(f"  gru_scan   {label:24s} max|err| {err:.3e}")
    rk4_cases = [("refit B=64 T=24", (64,), 24, 1),
                 ("guard B=64 T=32", (64,), 32, 1),
                 ("promote B=8 T=32", (8,), 32, 1),
                 ("predict B=1 T=50", (1,), 50, 1),
                 ("scenario [4, 8] T=50", (4, 8), 50, 1),
                 ("ragged B=61 T=24", (61,), 24, 1),
                 ("m=0 B=61 T=24", (61,), 24, 0),
                 ("fleet B=2048 T=32", (2048,), 32, 1)]
    for label, lead, T, m in rk4_cases:
        lib, args = _rk4_inputs(gen, dev, lead, T, m)
        idx = lib.indices_on(dev)
        Bf = int(np.prod(lead))
        flat = lambda th, y, u: (th.reshape(Bf, 3, lib.size),
                                 y.reshape(Bf, 3), u.reshape(Bf, T, m))
        outs, grads = _grads(
            lambda *a: rk4_poly_solve(*a, dt=0.01, library=lib), args)
        ref_outs, ref_grads = _grads(
            lambda *a: rk4_poly_solve_ref(*flat(*a), 0.01, idx).reshape(
                lead + (T + 1, 3)), args)
        torch.cuda.synchronize()
        err = _close(f"rk4 {label}", outs, ref_outs, RK4_TOL)
        _close(f"rk4 {label} grads", grads, ref_grads, GRAD_TOL)
        worst["rk4_poly"] = max(worst["rk4_poly"], err)
        print(f"  rk4_poly   {label:24s} max|err| {err:.3e}")
    worst["rk4_poly"] = max(worst["rk4_poly"], check_rk4_systems(dev),
                            check_rk4_wide(dev))
    worst["linear_scan"] = check_scan(dev)
    return worst


def check_rk4_systems(dev) -> float:
    """RK4 at every registered system's (n, m, order), m = 0 included (61
    instances, 24 steps, forward and gradients), and at F-8's simulation
    length: 4 traces of 600 samples x 10 substeps = 6,000 steps, forward
    only, each trace within 1e-4 of its envelope (the bound rounding over
    6,000 steps keeps; a trace the plain version lets diverge must diverge
    on the card too)."""
    from repro_torch.kernels.rk4.ops import rk4_poly_solve
    from repro_torch.kernels.rk4.ref import rk4_poly_solve_ref
    from repro_torch.systems.simulate import register_systems
    gen = torch.Generator().manual_seed(4)
    worst = 0.0
    for name in sorted(register_systems()):
        lib, dt, args = _system_rk4_inputs(name, gen, dev, 61, 24)
        idx = lib.indices_on(dev)
        outs, grads = _grads(
            lambda *a: rk4_poly_solve(*a, dt=dt, library=lib), args)
        ref_outs, ref_grads = _grads(
            lambda *a: rk4_poly_solve_ref(*a, dt, idx), args)
        torch.cuda.synchronize()
        label = f"{name} n={lib.n} m={lib.m} O={lib.order}"
        err = _close(f"rk4 {label}", outs, ref_outs, RK4_TOL)
        _close(f"rk4 {label} grads", grads, ref_grads, GRAD_TOL)
        worst = max(worst, err)
        print(f"  rk4_poly   {label:40s} max|err| {err:.3e}")
    lib, dt, args = _system_rk4_inputs("f8_crusader", gen, dev, 4, 600,
                                       substeps=10)
    with torch.no_grad():
        ys = rk4_poly_solve(*args, dt=dt, library=lib)
        ref = rk4_poly_solve_ref(*args, dt, lib.indices_on(dev))
    torch.cuda.synchronize()
    err = _close_traces("rk4 f8 simulation T=6000", ys, ref, 1e-4)
    print(f"  rk4_poly   {'f8 simulation B=4 T=6000':40s} max|err| "
          f"{err:.3e}")
    return max(worst, err)


def _f8_stack(k: int):
    from repro_torch.systems.f8_crusader import F8Crusader
    return F8Crusader(n_aircraft=k)


def check_rk4_wide(dev) -> float:
    """RK4's wide path (a block an instance, past the warp path's 16
    states): F8Crusader(n_aircraft=k) for k in F8_STACKS, B = 2, 300 steps
    of its dt.  Forward at every system's tolerance; gradients within
    WIDE_GRAD_REL of each leaf's envelope, with the plain version's own
    float32-against-float64 share printed beside as the yardstick.  Each
    airframe's coefficients are perturbed by 5% but no zero term is made
    dense: 0.01 on each of 7,770 cubic terms couples 11 airframes into a
    system whose trajectory leaves the trim region and diverges."""
    from repro_torch.kernels.rk4.ops import rk4_poly_solve
    from repro_torch.kernels.rk4.ref import rk4_poly_solve_ref
    gen = torch.Generator().manual_seed(6)
    worst = 0.0
    for k in F8_STACKS:
        lib, dt, args = _system_rk4_inputs(_f8_stack(k), gen, dev,
                                           WIDE_RK4_B, WIDE_RK4_T, dense=0.0)
        idx = lib.indices_on(dev)
        outs, grads = _grads(
            lambda *a: rk4_poly_solve(*a, dt=dt, library=lib), args)
        ref_outs, ref_grads = _grads(
            lambda *a: rk4_poly_solve_ref(*a, dt, idx), args)
        torch.cuda.synchronize()
        label = (f"wide f8x{k} n={lib.n} L={lib.size} B={WIDE_RK4_B} "
                 f"T={WIDE_RK4_T}")
        if not torch.isfinite(outs[0]).all():
            raise RuntimeError(f"rk4 {label}: non-finite trajectory")
        err = _close(f"rk4 {label}", outs, ref_outs, RK4_TOL)
        _, f64_grads = _grads(lambda *a: rk4_poly_solve_ref(*a, dt, idx),
                              [a.double() for a in args])
        share, f32_share = [], []
        for name, g, r, r64 in zip(("theta", "y0", "us"), grads, ref_grads,
                                   f64_grads):
            env = float(r64.abs().max())
            share.append(float((g - r).abs().max()) / env)
            f32_share.append(float((r.double() - r64).abs().max()) / env)
            if not share[-1] <= WIDE_GRAD_REL:
                raise RuntimeError(f"rk4 {label} grads: d/d{name} off by "
                                   f"{share[-1]:.2e} of its envelope "
                                   f"(limit {WIDE_GRAD_REL})")
        worst = max(worst, err)
        print(f"  rk4_poly   {label:40s} max|err| {err:.3e}; grads within "
              f"{max(share):.2e} of their envelope (plain float32 against "
              f"float64: {max(f32_share):.2e})")
    return worst


def _scan_inputs(gen, dev, B, H, T, dtype, strong=False):
    """q, k, v (dtype), w (f32 log decay), u (f32) with K = V = 64: the JAX
    kernel tests' distributions; `strong` widens the decay to exp(-7.4) per
    step."""
    K = V = 64
    rand = lambda *s: torch.randn(s, generator=gen)
    lo, hi = (-1.0, 2.0) if strong else (-7.0, -1.5)
    w = -torch.exp(torch.rand((B, H, T, K), generator=gen) * (hi - lo) + lo)
    return ((0.5 * rand(B, H, T, K)).to(dev, dtype),
            (0.5 * rand(B, H, T, K)).to(dev, dtype),
            (0.5 * rand(B, H, T, V)).to(dev, dtype),
            w.to(dev), (0.3 * rand(H, K)).to(dev))


def _mamba2_scan_inputs(gen, dev, B, H, T, K, dtype):
    """The scan's operands as models/mamba2.py builds them, materialised as
    the wrapper hands them to the kernel: q = C_t and k = B_t shared by the
    heads, v = dt * x, w = -exp(A_log) * dt one value a head broadcast over
    K, with A_log = log(linspace(1, 16, H)) as mamba2_init draws it and
    dt = softplus(N(0, 2) + dt_bias), dt_bias from mamba2_init's range: a
    step decays by up to exp(-16 dt), dt reaching several units."""
    rand = lambda *s: torch.randn(s, generator=gen)
    u = torch.rand((H,), generator=gen)
    lo, hi = float(np.log(1e-3)), float(np.log(1e-1))
    dt_bias = torch.log(torch.expm1(torch.exp(lo + u * (hi - lo))))
    dt = torch.nn.functional.softplus(2.0 * rand(B, H, T)
                                      + dt_bias[None, :, None])
    w = -torch.linspace(1.0, 16.0, H)[None, :, None] * dt
    mat = lambda t, dt_: t.to(dev, dt_).expand(B, H, T, K).contiguous()
    return (mat(rand(B, 1, T, K), dtype), mat(rand(B, 1, T, K), dtype),
            (rand(B, H, T, K) * dt[..., None]).to(dev, dtype),
            mat(w[..., None], torch.float32))


def check_scan(dev) -> float:
    """The linear-scan kernel against its plain chunked version: the RWKV-6
    prefill shape (B=1, H=40, K=V=64, chunk 64) with a ragged T, T < 64
    (C = T), a state carried across two halves, strong decays, and B*H >
    132; both modes, with and without the bonus u, bf16 and f32.  Then ssd
    on Mamba-2's operands at zamba2-7b's width (H=112, K=V=64, T=2048) and
    its SMOKE width (H=8, K=V=16, T=333), fresh and carried."""
    from repro_torch.kernels.linear_scan.ops import linear_scan
    from repro_torch.kernels.linear_scan.ref import linear_scan_chunked
    gen = torch.Generator().manual_seed(3)
    cases = [("prefill B=1 H=40 T=1000", 1, 40, 1000, False),
             ("short B=1 H=40 T=37", 1, 40, 37, False),
             ("strong decay T=300", 1, 40, 300, True),
             ("wide B=4 H=40 T=200", 4, 40, 200, False)]
    variants = [("ssd", False), ("rwkv6", True), ("rwkv6", False)]
    worst = 0.0
    with torch.no_grad():
        for label, B, H, T, strong in cases:
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v, w, u = _scan_inputs(gen, dev, B, H, T, dtype,
                                             strong=strong)
                for mode, bonus in variants:
                    uu = u if bonus else None
                    got = linear_scan(q, k, v, w, uu, mode=mode)
                    want = linear_scan_chunked(q, k, v, w, uu, mode=mode)
                    torch.cuda.synchronize()
                    name = (f"{label} {mode}{'+u' if bonus else ''} "
                            f"{str(dtype)[6:]}")
                    err = _close(f"linear_scan {name}", got, want, SCAN_TOL)
                    worst = max(worst, err)
                    print(f"  linear_scan {name:40s} max|err| {err:.3e}")
        # a state carried across two halves equals one whole scan
        q, k, v, w, u = _scan_inputs(gen, dev, 1, 40, 1000, torch.bfloat16)
        for mode in ("ssd", "rwkv6"):
            whole = linear_scan(q, k, v, w, u, mode=mode)
            o1, s1 = linear_scan(*(x[:, :, :450] for x in (q, k, v, w)), u,
                                 mode=mode)
            o2, s2 = linear_scan(*(x[:, :, 450:] for x in (q, k, v, w)), u,
                                 mode=mode, initial_state=s1)
            torch.cuda.synchronize()
            err = _close(f"linear_scan carry {mode}",
                         (torch.cat([o1, o2], dim=2), s2), whole, SCAN_TOL)
            worst = max(worst, err)
            print(f"  linear_scan {'carry 450 + 550 ' + mode:40s} "
                  f"max|err| {err:.3e}")
        for label, H, T, K in (("mamba2 zamba2 H=112 T=2048 K=64", 112,
                                2048, 64),
                               ("mamba2 smoke H=8 T=333 K=16", 8, 333, 16)):
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v, w = _mamba2_scan_inputs(gen, dev, 1, H, T, K, dtype)
                s0 = 0.1 * torch.randn((1, H, K, K), generator=gen).to(dev)
                for init in (None, s0):
                    got = linear_scan(q, k, v, w, mode="ssd",
                                      initial_state=init)
                    want = linear_scan_chunked(q, k, v, w, mode="ssd",
                                               initial_state=init)
                    torch.cuda.synchronize()
                    name = (f"{label} {str(dtype)[6:]}"
                            f"{' carried' if init is not None else ''}")
                    err = _close(f"linear_scan {name}", got, want, SCAN_TOL)
                    worst = max(worst, err)
                    print(f"  linear_scan {name:40s} max|err| {err:.3e}")
    return worst


def _device_ms(fn, reps: int = 20, rounds: int = 10) -> float:
    """Device time of one call: `reps` calls captured in a CUDA graph,
    replayed `rounds` times between CUDA events (no host launch gaps)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (rounds * reps)


def _eager_ms(fn, reps: int = 200) -> float:
    """Time of one call launched from Python, host overhead included."""
    for _ in range(5):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# the GRU's shapes, (F, B, T, H, D): the online tick's refit encoder
# (examples/online_twinning.py; the first, main shape keeps its label), the
# offline fleet's at the JAX package's default width
# (examples/fleet_twinning.py), F-8 training's batch of 64 windows at
# hidden 96 (examples/train_f8_crusader.py), the one width above 64 the
# repo runs, that model's recover over all 776 windows, and Table I's
# Lotka-Volterra encoder (benchmarks/table1_accuracy.py: D = n = 2)
GRU_SHAPES = {
    "F=8 B=8 T=24 D=4 H=32": (8, 8, 24, 32, 4),
    "fleet F=16 B=32 T=24 D=4 H=64": (16, 32, 24, 64, 4),
    "train F=1 B=64 T=24 D=4 H=96": (1, 64, 24, 96, 4),
    "recover F=1 B=776 T=24 D=4 H=96": (1, 776, 24, 96, 4),
    "lotka_volterra F=1 B=64 T=24 D=2 H=64": (1, 64, 24, 64, 2),
    # the wide path: hidden widths past the fast paths' 136
    "wide F=8 B=8 T=24 D=4 H=160": (8, 8, 24, 160, 4),
    "wide F=8 B=8 T=24 D=4 H=256": (8, 8, 24, 256, 4),
}
RK4_SHAPES = {             # the serving paths' calls: (lead, T)
    "refit B=64 T=24": ((64,), 24),
    "guard B=64 T=32": ((64,), 32),
    "promote B=8 T=32": ((8,), 32),
    "predict B=1 T=50": ((1,), 50),
    "scenario [4, 8] T=50": ((4, 8), 50),
    "fleet B=2048 T=32": ((2048,), 32),
}
# simulations (systems/simulate.py): (system, traces), one launch over the
# default horizon at 10 substeps a sample
RK4_SIM_SHAPES = {
    "f8 simulate B=4 T=6000": ("f8_crusader", 4),
    "lorenz simulate B=4 T=8000 m=0": ("lorenz", 4),
}
SCAN_SHAPES = {            # (B, H, T): RWKV-6 prefills of one or 4 prompts
    "T=256": (1, 40, 256), "T=659": (1, 40, 659), "T=1024": (1, 40, 1024),
    "T=2048": (1, 40, 2048), "T=4096": (1, 40, 4096),
    "B=4 T=2048": (4, 40, 2048),
    # a zamba2-7b Mamba-2 layer's prefill of 2048 tokens: ssd mode, no
    # bonus, 112 heads, K = state 64, V = head dim 64
    "mamba2 B=1 H=112 T=2048": (1, 112, 2048),
}


def _timed(fn, plain, flops, nbytes, plain_reps=20, tf32_flops=0.0,
           eager=False):
    """Device ms of the kernel and of its plain version, and the bound;
    with `eager`, also each one's time a call launched from Python."""
    from repro_torch.kernels.work import bound_ms as bound
    bound_ms, bound_by = bound(flops, nbytes, tf32_flops)
    out = dict(ms=_device_ms(fn), plain_ms=_device_ms(plain, reps=plain_reps),
               bound_ms=bound_ms, bound_by=bound_by)
    if eager:
        out.update(eager_ms=_eager_ms(fn),
                   plain_eager_ms=_eager_ms(plain, reps=10 * plain_reps))
    return out


def _by_shape(line, timings, main):
    """The main shape's numbers as the line's own, every shape's by name."""
    line.update(timings[main])
    for key in ("ms", "plain_ms", "bound_ms"):
        line[f"{key}_by_shape"] = {s: t[key] for s, t in timings.items()}
    line["shape"] = main
    return line


def kernel_lines(dev, paths, worst):
    """One entry per kernel.  `ms`, `plain_ms` and `bound_ms` are at the main
    serving shape -- the GRU at the refit encoder (F=8 slots x B=8 windows,
    T=24, D=4, H=32; also timed at the offline fleet's F=16 x B=32, H=64,
    and at F-8 training's 64 windows, H=96),
    RK4 at the refit decoder (B=64, T=24, n=3, L=35, O=3,
    m=1), the linear scan at the RWKV-6 prefill (B=1, H=40, T=2048,
    K=V=64, C=64, bf16 q/k/v; also at a zamba2-7b Mamba-2 layer's, ssd,
    H=112) -- and `*_by_shape` hold every serving shape timed.  None has a
    single PyTorch call computing the same function (torch's GRU applies
    the reset gate after the hidden product; no call runs an ODE or a
    decayed linear recurrence), so library_ms is null."""
    from repro_torch.kernels.gru.ops import gru_scan
    from repro_torch.kernels.gru.ref import gru_scan_ref
    from repro_torch.kernels.linear_scan.ops import linear_scan
    from repro_torch.kernels.linear_scan.ref import linear_scan_chunked
    from repro_torch.kernels.rk4.ops import rk4_poly_solve
    from repro_torch.kernels.rk4.ref import rk4_poly_solve_ref
    from repro_torch.kernels.work import (bound_ms, gru_flops, rk4_flops,
                                          scan_work, scan_work_pairwise)
    from repro_torch.systems.simulate import register_systems
    gen = torch.Generator().manual_seed(2)
    common = lambda name: dict(
        name=name, route="cuda", library_ms=None,
        launches=sum(c[name] for c in paths.values()),
        launches_by_path={p: c[name] for p, c in paths.items()},
        max_abs_err=worst[name])
    lines = []
    with torch.no_grad():
        timings = {}
        main = next(iter(GRU_SHAPES))
        for label, (F, B, T, H, D) in GRU_SHAPES.items():
            args = _gru_inputs(gen, dev, (F, B), F, T, H, D)
            outs = gru_scan(*args)
            flops = gru_flops(F, B, T, H, D)
            nbytes = sum(t.nbytes for t in (*args, *outs))
            timings[label] = _timed(lambda a=args: gru_scan(*a),
                                    lambda a=args: gru_scan_ref(*a), flops,
                                    nbytes, eager=label == main)
        lines.append(_by_shape(dict(
            **common("gru_scan"), source="src/repro_torch/csrc/gru_scan.cu",
            replaces="src/repro/kernels/gru/gru.py:27"), timings, main))

        timings = {}
        cases = {label: (*_rk4_inputs(gen, dev, lead, T, 1), 0.01, lead)
                 for label, (lead, T) in RK4_SHAPES.items()}
        for label, (name, B) in RK4_SIM_SHAPES.items():
            horizon = register_systems()[name]().spec.horizon
            lib, dt, args = _system_rk4_inputs(name, gen, dev, B, horizon,
                                               substeps=10)
            cases[label] = (lib, args, dt, (B,))
        slow = set(RK4_SIM_SHAPES)       # the plain version's long calls
        for k in F8_STACKS:              # the wide path
            label = (f"wide f8x{k} n={3 * k} B={WIDE_RK4_B} "
                     f"T={WIDE_RK4_T}")
            lib, dt, args = _system_rk4_inputs(_f8_stack(k), gen, dev,
                                               WIDE_RK4_B, WIDE_RK4_T,
                                               dense=0.0)
            cases[label] = (lib, args, dt, (WIDE_RK4_B,))
            slow.add(label)
        for label, (lib, (theta, y0, us), dt, lead) in cases.items():
            idx = lib.indices_on(dev)
            Bf, n, L, O = int(np.prod(lead)), lib.n, lib.size, idx.shape[1]
            T = us.shape[-2]
            ys = rk4_poly_solve(theta, y0, us, dt=dt, library=lib)
            flops = rk4_flops(Bf, T, n, L, O)
            nbytes = sum(t.nbytes for t in (theta, y0, us, idx, ys))
            flat = [t.reshape((Bf,) + t.shape[len(lead):])
                    for t in (theta, y0, us)]
            sim = label in slow
            timings[label] = _timed(
                lambda a=(theta, y0, us), lb=lib, h=dt: rk4_poly_solve(
                    *a, dt=h, library=lb),
                lambda f=flat, ix=idx, h=dt: rk4_poly_solve_ref(*f, h, ix),
                flops, nbytes, plain_reps=1 if sim else 20,
                eager=label == "refit B=64 T=24")
        lines.append(_by_shape(dict(
            **common("rk4_poly"), source="src/repro_torch/csrc/rk4_poly.cu",
            replaces="src/repro/kernels/rk4/rk4.py:38"), timings,
            "refit B=64 T=24"))

        timings, pairwise = {}, {}
        K = V = C = 64
        for label, (B, H, T) in SCAN_SHAPES.items():
            rwkv6 = not label.startswith("mamba2")
            mode = "rwkv6" if rwkv6 else "ssd"
            if rwkv6:
                args = _scan_inputs(gen, dev, B, H, T, torch.bfloat16)
            else:
                # materialised as the wrapper hands them to the kernel: q,
                # k and w are read at [B, H, T, K] whatever they broadcast
                args = (*_mamba2_scan_inputs(gen, dev, B, H, T, K,
                                             torch.bfloat16), None)
            o, sf = linear_scan(*args, mode=mode, chunk=C)
            nbytes = sum(t.nbytes for t in (*args, o, sf) if t is not None)
            f32, tf32 = scan_work(B, H, T, K, V, C, rwkv6, True)
            timings[label] = _timed(
                lambda a=args, m=mode: linear_scan(*a, mode=m, chunk=C),
                lambda a=args, m=mode: linear_scan_chunked(*a, mode=m,
                                                           chunk=C),
                f32, nbytes, plain_reps=3, tf32_flops=tf32,
                eager=label == "T=2048")
            pairwise[label] = bound_ms(
                scan_work_pairwise(B, H, T, K, V, C, rwkv6), nbytes)[0]
            if label == "T=2048":
                scan_launches(lambda a=args: linear_scan(
                    *a, mode="rwkv6", chunk=C))
        line = _by_shape(dict(
            **common("linear_scan"),
            source="src/repro_torch/csrc/linear_scan.cu",
            replaces="src/repro/kernels/linear_scan/linear_scan.py:28"),
            timings, "T=2048")
        line["bound_ms_pairwise_form"] = pairwise["T=2048"]
        # phase 12: its gradients (kernel forward, replayed backward)
        # against the plain version's, the worst share of an envelope
        line["grad_max_rel_err"] = worst.get("linear_scan_grad")
        line["shape"] = f"B=1 H=40 T=2048 K={K} V={V} C={C} rwkv6 bf16"
        lines.append(line)
    return lines


def scan_launches(fn, calls: int = 10):
    """Device time of each of the scan's three launches (chunk states, the
    scan across chunks, chunk outputs) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # CPU activity too: after earlier profiler sessions a CUDA-only one
    # recorded no device events
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts = [(k, t / n / 1e3) for name, (t, n) in _device_events(prof).items()
             for k in OWN_KERNELS if k in name]
    if not parts:
        print("linear_scan launches: not measured (no device events)")
        return
    print("linear_scan launches at B=1 H=40 T=2048, device ms per call: "
          + ", ".join(f"{k} {t:.4f}" for k, t in parts))


def counted(paths: dict, path: str, fn, quiet: bool = False):
    """Drive one serving path with every kernel's launch count set to 0 just
    before it, add the counts just after to the path's total (a path driven
    call by call, like the LM engine's, sums its calls), and fail if a
    kernel the path runs was never launched."""
    from repro_torch.kernels.gru.ops import gru_scan
    from repro_torch.kernels.linear_scan.ops import linear_scan
    from repro_torch.kernels.rk4.ops import rk4_poly_solve
    kernels = {"gru_scan": gru_scan, "rk4_poly": rk4_poly_solve,
               "linear_scan": linear_scan}
    for k in kernels.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    total = paths.setdefault(path, dict.fromkeys(kernels, 0))
    for name, k in kernels.items():
        total[name] += k.launches
    if not quiet:
        print(f"kernel launches on the {path} path: {total}")
    for name in PATH_KERNELS[path]:
        if total[name] == 0:
            raise RuntimeError(f"{name} was never launched on the {path} "
                               "path")
    stray = {k: v for k, v in total.items()
             if v and k not in PATH_KERNELS[path]}
    if stray:
        raise RuntimeError(f"the {path} path launched {stray}; it runs "
                           f"only {PATH_KERNELS[path] or 'no kernel'}")
    return out


def check_ticks(srv, reports):
    """What the ticks must show: finite losses, at least one promoted refit
    and the guard flagging damaged airframes."""
    losses = [r.loss for r in reports if r.loss is not None]
    if not losses or not np.all(np.isfinite(losses)):
        raise RuntimeError(f"refit losses missing or non-finite: {losses}")
    promoted = sorted(t for t, r in srv.twins.items() if r.deploy_tick > 0)
    flagged = sorted({e.twin_id for e in srv.events})
    print(f"promoted twins: {promoted}")
    print(f"guard-flagged twins: {flagged} (damaged: 0..{DAMAGED - 1})")
    if not promoted:
        raise RuntimeError("no refit was promoted into the theta store")
    if not set(flagged) & set(range(DAMAGED)):
        raise RuntimeError("the guard flagged none of the damaged twins")


def check_answers(srv, preds, scn, ys):
    """Finite predictions and scenario answers of the expected shape, and a
    prediction equal to the plain version's on the same theta and state."""
    from repro_torch.kernels.rk4.ref import rk4_poly_solve_ref
    for p in preds:
        if p.shape != (51, 3) or not torch.isfinite(p).all():
            raise RuntimeError(f"bad prediction {tuple(p.shape)}")
    for f in ("ys", "lo", "hi"):
        a = getattr(scn, f)
        if a.shape != (8, 51, 3) or not np.isfinite(a).all():
            raise RuntimeError(f"bad scenario {f} {a.shape}")
    if not (np.all(scn.lo <= scn.ys) and np.all(scn.ys <= scn.hi)
            and np.all((scn.confidence > 0) & (scn.confidence <= 1))):
        raise RuntimeError("scenario envelope does not contain its center")
    # the prediction against the plain version on the CPU, same theta/state
    rec = srv.twins[DAMAGED]
    y0 = torch.as_tensor(ys[DAMAGED, HISTORY + TICKS * CHUNK - 1])[None]
    ref = rk4_poly_solve_ref(srv._theta[rec.ring_slot][None].cpu(), y0,
                             torch.zeros(1, 50, 1), 0.01,
                             srv.fleet.model.lib.term_indices)[0]
    torch.testing.assert_close(preds[1].cpu(), ref, **RK4_TOL)


def check_parity(reports, cpu_reports):
    """Per-tick admissions equal and losses within rtol 1e-3 / atol 1e-4
    (the JAX package's reference-vs-kernel server tolerance)."""
    for t, (rg, rc) in enumerate(zip(reports, cpu_reports)):
        if (rg.n_active, rg.admitted) != (rc.n_active, rc.admitted):
            raise RuntimeError(f"tick {t + 1}: card admitted {rg.admitted} "
                               f"({rg.n_active} active), CPU {rc.admitted} "
                               f"({rc.n_active})")
        if (rg.loss is None) != (rc.loss is None) or (
                rg.loss is not None and not np.isclose(
                    rg.loss, rc.loss, rtol=1e-3, atol=1e-4)):
            raise RuntimeError(f"tick {t + 1}: loss card {rg.loss} vs "
                               f"CPU {rc.loss}")
        print(f"  tick {t + 1:2d} active {rg.n_active} admitted "
              f"{len(rg.admitted)} loss card {rg.loss} cpu {rc.loss}")


# --------------------------------------------------------------------------- #
# crash safety: snapshot/restore, kill and replay, the reference planner,
# async ingest
# --------------------------------------------------------------------------- #
def _flagged(reports) -> list:
    return sorted({e.twin_id for r in reports for e in r.events})


def _events(report) -> list:
    return [(e.twin_id, e.kind) for e in report.events]


def _run_summary(name, srv, paths, path, smi, ck=None):
    """One line per sub-run: tick p50/p99 (registry histograms), the path's
    kernel launches, the checkpoint's snapshot and write seconds, the
    card."""
    lat = srv.latency_summary()
    ticks = (f"tick p50 {lat['p50_ms']:.2f} ms, p99 {lat['p99_ms']:.2f} ms "
             f"({lat['ticks']} ticks)" if lat["ticks"] else "no ticks")
    counts = paths[path]
    line = (f"  {name}: {ticks}; launches gru_scan {counts['gru_scan']}, "
            f"rk4_poly {counts['rk4_poly']}")
    if ck is not None:
        snap, write = ck._m_snapshot, ck._m_write
        line += (f"; twin_ckpt_snapshot_seconds mean "
                 f"{snap.sum / max(snap.count, 1):.6f} max {snap.max:.6f} "
                 f"(n={snap.count}), twin_ckpt_write_seconds mean "
                 f"{write.sum / max(write.count, 1):.6f} max "
                 f"{write.max:.6f} (n={write.count})")
    print(f"{line} [{smi}]")


def crash_roundtrip(ys, us, paths, smi):
    """Snapshot after tick ROUNDTRIP_TICK, written and read back through
    train/checkpoint.py into a fresh server sharing the modules; both serve
    the same ROUNDTRIP_AFTER ticks.  Guard events must be identical and
    losses equal (bit for bit, or within 1e-6 relative: which one is
    printed)."""
    from repro_torch.train import checkpoint
    from repro_torch.twin.server import TwinServer

    def run():
        srv, _ = serve(None, ys, us, ROUNDTRIP_TICK)
        d = CKPT_DIR / "roundtrip"
        t0 = time.perf_counter()
        host = checkpoint.to_host(srv.snapshot_state())
        t1 = time.perf_counter()
        checkpoint.save(d, srv.tick_count, host)
        t2 = time.perf_counter()
        twin = TwinServer(srv.cfg, share_modules_from=srv)
        twin.restore_state(checkpoint.restore(d, srv.tick_count,
                                              twin.snapshot_state()))
        t3 = time.perf_counter()
        pairs = [(_stream(srv, ys, us, t), _stream(twin, ys, us, t))
                 for t in range(ROUNDTRIP_TICK,
                                ROUNDTRIP_TICK + ROUNDTRIP_AFTER)]
        return srv, twin, pairs, (t1 - t0, t2 - t1, t3 - t2)

    srv, twin, pairs, (t_snap, t_write, t_restore) = counted(
        paths, "crash_roundtrip", run, quiet=True)
    exact = True
    for a, b in pairs:
        if _events(a) != _events(b) or (a.admitted, a.evicted, a.released) \
                != (b.admitted, b.evicted, b.released):
            raise RuntimeError(f"round trip: tick {a.tick} differs after "
                               f"restore: {_events(a)} / {_events(b)}")
        if (a.loss is None) != (b.loss is None):
            raise RuntimeError(f"round trip: tick {a.tick} loss {a.loss} "
                               f"vs {b.loss}")
        if a.loss is not None and a.loss != b.loss:
            exact = False
            if not np.isclose(a.loss, b.loss, rtol=1e-6, atol=0.0):
                raise RuntimeError(f"round trip: tick {a.tick} loss "
                                   f"{a.loss} vs restored {b.loss}")
    print(f"  round trip at tick {ROUNDTRIP_TICK}: {ROUNDTRIP_AFTER} ticks "
          f"after restore, guard events identical, losses "
          f"{'equal bit for bit' if exact else 'within 1e-6 relative'} "
          f"{[a.loss for a, _ in pairs]}; snapshot to host {t_snap:.4f} s, "
          f"write {t_write:.4f} s, restore {t_restore:.4f} s")
    _run_summary("round trip, restored server", twin, paths,
                 "crash_roundtrip", smi)


def _restore_and_replay(ck, journal, ys, us, start_tick):
    """A fresh server restored from the newest committed checkpoint, the
    journal suffix replayed past the staging bound (force=True), then the
    telemetry from `start_tick` on served, to the end of the stream.
    Returns (restored tick, server, reports, samples lost)."""
    from repro_torch.twin.server import TwinServer
    srv = TwinServer(_server_config())
    tick, state = ck.restore_latest(0, srv.snapshot_state())
    srv.restore_state(state)
    lost = 0
    for tid in journal.twin_ids():
        chunks, n_lost = journal.replay_since(tid, srv.twins[tid].samples)
        lost += n_lost
        srv.ingest_many([(tid, y, u) for y, u in chunks], force=True)
    # no later crash is simulated, so the rest goes unjournaled (a second
    # restore replays the journal as the first one found it)
    reports = [_stream(srv, ys, us, t) for t in range(start_tick, TICKS)]
    return tick, srv, reports, lost


def crash_replay(ys, us, reports, paths, smi):
    """Checkpoint every CKPT_EVERY ticks with a telemetry journal, drop the
    server at KILL_TICK, restore the newest commit, replay, serve to TICKS:
    the flagged set must be the uninterrupted run's (phase 3, which flags
    the damaged 0..DAMAGED-1) and no sample lost.  Then again with the
    newest commit torn: the restore falls back one commit."""
    from repro_torch.twin.recovery import (ChaosConfig, ChaosInjector,
                                           RecoveryConfig, TelemetryJournal,
                                           TwinCheckpointer)
    want = _flagged(reports)
    cfg = _server_config()
    final = HISTORY + TICKS * CHUNK
    ck = TwinCheckpointer(RecoveryConfig(ckpt_dir=str(CKPT_DIR / "replay"),
                                         ckpt_every=CKPT_EVERY, keep=2))
    chaos = ChaosInjector(ChaosConfig(kill_shard=0, kill_at_tick=KILL_TICK,
                                      torn_checkpoint=True))
    journal = TelemetryJournal(horizon=cfg.capacity)

    def before_kill():
        srv = _fresh_server(None, ys, us, journal)
        reps = []
        for t in range(TICKS):
            if chaos.should_kill(0, srv.tick_count):
                break
            reps.append(_stream(srv, ys, us, t, journal))
            ck.maybe_save(0, srv.tick_count, srv.snapshot_state)
        ck.wait()
        return srv, reps

    dead, pre = counted(paths, "crash_checkpointed", before_kill, quiet=True)
    _run_summary(f"checkpointed run, dropped at tick {dead.tick_count}",
                 dead, paths, "crash_checkpointed", smi, ck)
    kill_tick = dead.tick_count
    del dead
    for path, tear in (("crash_replay", False), ("crash_torn", True)):
        torn = None
        if tear and chaos.should_tear():
            torn = ck.tear_latest(0)
        tick, srv, post, lost = counted(
            paths, path, lambda: _restore_and_replay(
                ck, journal, ys, us, kill_tick), quiet=True)
        got = _flagged(pre + post)
        samples = {r.samples for r in srv.twins.values()}
        what = (f"torn commit {torn}, fell back to tick {tick}" if tear
                else f"restored tick {tick}")
        print(f"  kill at tick {kill_tick}, {what}: flagged {got}, "
              f"samples per twin {sorted(samples)}, lost {lost}")
        expect_tick = (kill_tick // CKPT_EVERY) * CKPT_EVERY - (
            CKPT_EVERY if tear else 0)
        if tick != expect_tick:
            raise RuntimeError(f"{path}: restored tick {tick}, expected "
                               f"{expect_tick}")
        if got != want or got != list(range(DAMAGED)):
            raise RuntimeError(f"{path}: flagged {got}, the uninterrupted "
                               f"run flagged {want} (damaged 0.."
                               f"{DAMAGED - 1})")
        if lost or samples != {final}:
            raise RuntimeError(f"{path}: {lost} samples lost, per-twin "
                               f"counts {sorted(samples)} (sent {final})")
        _run_summary(f"restored server ({'torn' if tear else 'newest'} "
                     f"commit)", srv, paths, path, smi, ck)


def reference_planner(ys, us, reports, paths, smi):
    """TICKS ticks with scheduler="reference": admissions, evictions and
    releases equal the packed planner's (phase 3) tick by tick."""
    def run():
        srv = _fresh_server(None, ys, us, scheduler="reference")
        return srv, [_stream(srv, ys, us, t) for t in range(TICKS)]

    srv, refs = counted(paths, "reference_planner", run, quiet=True)
    turnover = 0
    for a, b in zip(reports, refs):
        if (a.admitted, a.evicted, a.released) != \
                (b.admitted, b.evicted, b.released):
            raise RuntimeError(f"tick {a.tick}: packed planner "
                               f"{(a.admitted, a.evicted, a.released)}, "
                               f"reference {(b.admitted, b.evicted, b.released)}")
        turnover += len(a.admitted) + len(a.evicted) + len(a.released)
    print(f"  reference planner: {len(refs)} ticks, plans equal the packed "
          f"planner's tick by tick ({turnover} slot transitions)")
    _run_summary("reference planner", srv, paths, "reference_planner", smi)


def async_ingest(ys, us, paths, smi):
    """TICKS ticks with async_ingest: each tick's telemetry is ingested by
    SENSORS threads while the tick runs; after drain() every twin's sample
    count and its ring row's count equal what was sent."""
    import threading

    def run():
        srv = _fresh_server(None, ys, us, async_ingest=True)
        groups = np.array_split(np.arange(TWINS), SENSORS)
        try:
            threads = []
            for t in range(TICKS):
                lo = HISTORY + t * CHUNK
                threads = [threading.Thread(target=srv.ingest_many, args=(
                    [(int(i), ys[i, lo:lo + CHUNK], us[i, lo:lo + CHUNK])
                     for i in g],)) for g in groups]
                for th in threads:
                    th.start()
                srv.tick()
                for th in threads:
                    th.join()
            srv.drain()
        finally:
            srv.close()
        return srv

    srv = counted(paths, "async_ingest", run, quiet=True)
    final = HISTORY + TICKS * CHUNK
    counts = srv._rstate["count"].cpu().numpy()
    for tid, rec in srv.twins.items():
        if rec.samples != final or int(counts[rec.ring_slot]) != final:
            raise RuntimeError(f"async ingest: twin {tid} counted "
                               f"{rec.samples}, ring {counts[rec.ring_slot]}"
                               f", sent {final}")
    print(f"  async ingest: {SENSORS} sensor threads, {TICKS} ticks, every "
          f"twin {final} samples in the records and the ring, "
          f"{srv.dropped_samples} dropped")
    _run_summary("async ingest", srv, paths, "async_ingest", smi)


def crash_safety(ys, us, reports, paths, smi):
    import shutil
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        for what, fn in (
                ("round trip", lambda: crash_roundtrip(ys, us, paths, smi)),
                ("kill and replay",
                 lambda: crash_replay(ys, us, reports, paths, smi)),
                ("reference planner",
                 lambda: reference_planner(ys, us, reports, paths, smi)),
                ("async ingest", lambda: async_ingest(ys, us, paths, smi))):
            t0 = time.perf_counter()
            fn()
            print(f"   ({what}: {time.perf_counter() - t0:.1f} s)")
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)


# --------------------------------------------------------------------------- #
# LM serving (rwkv6-3b)
# --------------------------------------------------------------------------- #
def _lm_api(cfg, finite: list):
    """The model API with every prefill's and decode's logits recorded as
    finite or not (a device flag, read once at the end)."""
    from repro_torch.models.zoo import build
    api = build(cfg)

    def watch(fn):
        def call(*args):
            cache, logits = fn(*args)
            finite.append(torch.isfinite(logits).all())
            return cache, logits
        return call
    return dataclasses.replace(api, prefill=watch(api.prefill),
                               decode=watch(api.decode))


def _n_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_n_params(v) for v in tree)
    return tree.numel()


def _describe(cfg) -> str:
    kinds = cfg.layer_kinds()
    parts = [f"{kinds.count(k)} {k}" for k in dict.fromkeys(kinds)]
    if cfg.enc_layers:
        parts = [f"{cfg.enc_layers} encoder + {cfg.n_layers} decoder"]
    if cfg.shared_every:
        from repro_torch.models.kv_cache import n_shared
        parts.append(f"{n_shared(cfg)} shared-block invocations "
                     f"({cfg.shared_n_heads} heads of "
                     f"{2 * cfg.d_model // cfg.shared_n_heads})")
    if cfg.n_experts:
        parts.append(f"{cfg.n_experts} experts top-{cfg.top_k}, capacity "
                     f"{cfg.moe_capacity}, group {cfg.moe_group_size}"
                     + (f", dense FFN {cfg.dense_ff}" if cfg.dense_ff
                        else ""))
    return (f"{cfg.name}: {cfg.n_layers} layers ({', '.join(parts)}), "
            f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
            f"{cfg.dtype}")


def _prompt_lens(rng):
    """Phase 5's LM_REQUESTS prompt lengths in LM_PROMPTS (not all
    multiples of 64)."""
    lens = rng.integers(LM_PROMPTS[0], LM_PROMPTS[1] + 1, size=LM_REQUESTS)
    if np.all(lens % 64 == 0):
        lens[0] += 1
    return lens


def _lm_requests(cfg, rng) -> list[dict]:
    return [dict(prompt=rng.integers(0, cfg.vocab, size=n))
            for n in _prompt_lens(rng)]


def _moe_requests(cfg, rng) -> list[dict]:
    """Phase 5's lengths, each of 2 groups or more rounded down to a
    multiple of the MoE group, which moe_apply (as the JAX package's)
    needs: N tokens make N // group groups that must divide N."""
    lens = _prompt_lens(rng)
    g = cfg.moe_group_size
    cut = np.where(lens >= 2 * g, lens // g * g, lens)
    print(f"{cfg.name}: prompt lengths drawn {lens.tolist()}, served "
          f"{cut.tolist()} (from {2 * g} tokens on, multiples of {g})")
    return [dict(prompt=rng.integers(0, cfg.vocab, size=n)) for n in cut]


def _whisper_requests(cfg, rng) -> list[dict]:
    """WHISPER_FRAMES frame embeddings a request, drawn x 0.1 as
    tests/test_archs_smoke.py draws them, and a WHISPER_PROMPT-token
    decoder prompt."""
    return [dict(prompt=rng.integers(0, cfg.vocab, size=WHISPER_PROMPT),
                 enc_x=(rng.normal(size=(WHISPER_FRAMES, cfg.d_model))
                        * 0.1).astype(np.float32))
            for _ in range(LM_REQUESTS)]


def serve_lm(paths: dict, arch: str = "rwkv6-3b", prefix: str = "lm",
             after=None, layers: int | None = None, requests=_lm_requests,
             max_len: int = LM_PROMPTS[1] + LM_NEW):
    """`arch` at full width (its first `layers` layers if given) behind a
    4-slot engine: 8 greedy requests (`requests(cfg, rng)`: each a dict of
    Request fields), admitted as slots free up; every admit counted on the
    <prefix>_prefill path and every decode step on <prefix>_decode.  The
    prefill path must launch the scan once for every RWKV-6 or Mamba-2
    layer of every request.  `after(api, params)` runs last, outside the
    counted runs."""
    from repro_torch.configs import get_arch
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_arch(arch).config
    if layers is not None:
        cfg = cfg.with_(n_layers=layers,
                        enc_layers=layers if cfg.enc_layers else 0)
    pre_path, dec_path = f"{prefix}_prefill", f"{prefix}_decode"
    finite = []
    api = _lm_api(cfg, finite)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(seed=0)
    torch.cuda.synchronize()
    print(f"{_describe(cfg)}: {_n_params(params) / 1e9:.3f}B parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"drawn in {time.perf_counter() - t0:.2f} s")
    fields = requests(cfg, np.random.default_rng(7))
    lens = np.array([len(f["prompt"]) for f in fields])
    engine = ServeEngine(api, slots=LM_SLOTS, max_len=max_len, seed=0)
    engine.load(params)
    # warm-up outside the counted run: cuBLAS handles, allocator pools
    engine.generate([Request(rid=-1, **dict(
        fields[0], prompt=fields[0]["prompt"][:100]), max_new_tokens=2)])
    torch.cuda.synchronize()
    reqs = [Request(rid=i, max_new_tokens=LM_NEW, **f)
            for i, f in enumerate(fields)]
    pending, done = list(reqs), []
    prefill_s = decode_s = 0.0
    admitted = steps = 0
    while pending or engine.active:
        while pending and engine.free_slots():
            req = pending.pop(0)
            t0 = time.perf_counter()
            if not counted(paths, pre_path, lambda: engine.admit(req),
                           quiet=True):
                raise RuntimeError(f"request {req.rid} was not admitted")
            prefill_s += time.perf_counter() - t0
            admitted += 1
        t0 = time.perf_counter()
        done += counted(paths, dec_path, engine.step, quiet=True)
        decode_s += time.perf_counter() - t0
        steps += 1
    for path in (pre_path, dec_path):
        print(f"kernel launches on the {path} path: {paths[path]}")
    scan_layers = sum(k in ("rwkv6", "mamba2") for k in cfg.layer_kinds())
    want = scan_layers * admitted
    if paths[pre_path]["linear_scan"] != want:
        raise RuntimeError(f"{pre_path} launched linear_scan "
                           f"{paths[pre_path]['linear_scan']} times, "
                           f"expected {scan_layers} x {admitted} = {want}")
    if sorted(r.rid for r in done) != list(range(LM_REQUESTS)):
        raise RuntimeError(f"finished {sorted(r.rid for r in done)}")
    for r in done:
        if len(r.generated) != LM_NEW or not all(
                0 <= t < cfg.vocab for t in r.generated):
            raise RuntimeError(f"request {r.rid}: {r.generated}")
    if not bool(torch.stack(finite).all()):
        raise RuntimeError(f"non-finite logits on the {cfg.name} path")
    tokens = int(lens.sum())
    print(f"{cfg.name}: served {len(done)} requests (prompts "
          f"{sorted(lens.tolist())}), {LM_NEW} tokens each; {len(finite)} "
          f"logit rows finite; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
    frames = sum(len(f["enc_x"]) for f in fields if "enc_x" in f)
    print(f"{cfg.name}: prefill {tokens} tokens in {prefill_s * 1e3:.2f} ms: "
          f"{tokens / prefill_s:.1f} tokens/s"
          + (f" (encoder {frames} frames: {frames / prefill_s:.1f} "
             "frames/s)" if frames else "")
          + f"; decode {steps} steps of {LM_SLOTS} slots in "
          f"{decode_s * 1e3:.2f} ms: {decode_s * 1e3 / steps:.3f} ms per "
          "step")
    print(f"{cfg.name}: request 0 tokens: {reqs[0].generated}")
    # after the counted run: one more prefill, then decode steps, profiled
    extra = Request(rid=LM_REQUESTS, max_new_tokens=LM_PROFILE_STEPS + 1,
                    **dict(fields[-1], prompt=fields[-1]["prompt"][:1024]))
    profiled(f"{cfg.name} prefill of {len(extra.prompt)} tokens",
             lambda: engine.admit(extra))
    profiled(f"{LM_PROFILE_STEPS} {cfg.name} decode steps (1 active slot)",
             lambda: [engine.step() for _ in range(LM_PROFILE_STEPS)])
    del engine
    if after is not None:
        after(api, params)
    del params
    torch.cuda.empty_cache()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _routing_recorder(side: list):
    """Patch moe.router_topk to record each call's router probabilities
    [G, n, E] and kept assignments (the combine's support), with its top_k
    and capacity, on the host under the label in side[0].  Returns
    (records by label, restore)."""
    from repro_torch.models import moe
    real, rec = moe.router_topk, {}

    def record(logits, top_k, capacity):
        combine, aux = real(logits, top_k, capacity)
        rec.setdefault(side[0], []).append((
            torch.softmax(logits.to(torch.float32), -1).cpu(),
            (combine > 0).cpu(), top_k, capacity))
        return combine, aux
    moe.router_topk = record

    def restore():
        moe.router_topk = real
    return rec, restore


def _margin(probs, top_k: int) -> float:
    """The smallest gap between a token's k-th and (k+1)-th router
    probability."""
    top = torch.sort(probs, -1, descending=True).values
    return float((top[..., top_k - 1] - top[..., top_k]).min())


def lm_parity(dev, arch: str = "rwkv6-3b", layers: int = LM_PARITY_LAYERS,
              prompt_len: int = LM_PARITY_PROMPT,
              steps: int = LM_PARITY_STEPS, smoke: bool = False):
    """`arch` at full width, `layers` layers (an encoder-decoder's encoder
    too; `smoke`: its SMOKE config instead), f32: the same weights (drawn
    on the card) on the card and on the CPU give prefill logits within
    LM_TOL, and equal greedy tokens with logits within LM_TOL for `steps`
    decode steps.  An encoder-decoder's prompt has WHISPER_FRAMES frames;
    an MoE's routing must be equal, call by call (every layer of the
    prefill and of each decode step)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.zoo import build
    spec = get_arch(arch)
    cfg = (spec.smoke if smoke else spec.config.with_(
        n_layers=layers, enc_layers=layers if spec.config.enc_layers else 0))
    cfg = cfg.with_(dtype=torch.float32)
    api = build(cfg)
    t0 = time.perf_counter()
    params = api.init(seed=1, device=dev)
    cpu_params = _to(params, "cpu")
    rng = np.random.default_rng(8)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(1, prompt_len))}
    if cfg.enc_layers:
        batch["enc_x"] = (rng.normal(size=(1, WHISPER_FRAMES, cfg.d_model))
                          * 0.1).astype(np.float32)
    side = ["card"]
    routing, restore = (_routing_recorder(side) if cfg.n_experts
                        else ({}, lambda: None))
    worst, toks = 0.0, []
    try:
        with torch.no_grad():
            caches, logits = [], []
            for side[0], d, p in (("card", dev, params),
                                  ("cpu", "cpu", cpu_params)):
                c, lg = api.prefill(p, {k: torch.as_tensor(v, device=d)
                                        for k, v in batch.items()},
                                    prompt_len + steps)
                caches.append(c)
                logits.append(lg)
            for step in range(steps + 1):
                card, host = logits[0].cpu(), logits[1]
                torch.testing.assert_close(
                    card, host, **LM_TOL,
                    msg=lambda m: f"{arch} logits, step {step}: {m}")
                worst = max(worst, float((card - host).abs().max()))
                nxt = [int(torch.argmax(lg[0])) for lg in (card, host)]
                if nxt[0] != nxt[1]:
                    raise RuntimeError(f"{arch} step {step}: card token "
                                       f"{nxt[0]}, CPU {nxt[1]}")
                toks.append(nxt[0])
                if step == steps:
                    break
                for i, (side[0], d, p) in enumerate((
                        ("card", dev, params), ("cpu", "cpu", cpu_params))):
                    caches[i], logits[i] = api.decode(
                        p, caches[i], torch.tensor([nxt[0]], device=d))
    finally:
        restore()
    note = ""
    if cfg.n_experts:
        card, host = routing["card"], routing["cpu"]
        if len(card) != len(host) or not all(
                torch.equal(a[1], b[1]) for a, b in zip(card, host)):
            raise RuntimeError(f"{arch}: the card's MoE routing differs from "
                               "the CPU's")
        margin = lambda rec: min(_margin(r[0], cfg.top_k) for r in rec)
        note = (f"; routing equal in all {len(card)} router calls ("
                f"{cfg.n_layers} layers x {steps + 1} passes), smallest "
                f"top-{cfg.top_k} margin {margin(card):.3e} (CPU "
                f"{margin(host):.3e})")
    print(f"{_describe(cfg)}: prefill of {prompt_len} tokens"
          + (f" over {WHISPER_FRAMES} frames" if cfg.enc_layers else "")
          + f" + {steps} decode steps: greedy tokens equal ({toks}), logits "
          f"max|card - CPU| {worst:.3e}{note} "
          f"({time.perf_counter() - t0:.1f} s)")
    del params, cpu_params
    torch.cuda.empty_cache()


def _record_scan(worst: dict):
    """An `after` for serve_lm: one more prefill of LM_PROMPTS[1] tokens,
    recording the scan's operands in Mamba-2 layer ZOO_RECORD_LAYER, then
    the kernel against its plain version on exactly those operands."""
    def after(api, params):
        from repro_torch.kernels.linear_scan.ref import linear_scan_chunked
        from repro_torch.models import mamba2 as m2
        real, rec, calls = m2.linear_scan, {}, [0]

        def record(q, k, v, w, **kw):
            if calls[0] == ZOO_RECORD_LAYER:
                rec.update(args=(q, k, v, w), kw=kw)
            calls[0] += 1
            return real(q, k, v, w, **kw)
        tokens = np.random.default_rng(9).integers(
            0, api.cfg.vocab, size=(1, LM_PROMPTS[1]))
        m2.linear_scan = record
        try:
            with torch.no_grad():
                api.prefill(params, {"tokens": torch.as_tensor(
                    tokens, device=params["embed"]["w"].device)},
                    LM_PROMPTS[1] + 1)
        finally:
            m2.linear_scan = real
        q, k, v, w = rec["args"]
        with torch.no_grad():
            got = real(q, k, v, w, **rec["kw"])
            want = linear_scan_chunked(q, k, v, w, **rec["kw"])
        torch.cuda.synchronize()
        name = (f"zamba2 layer {ZOO_RECORD_LAYER} ssd {tuple(q.shape)} "
                f"{str(q.dtype)[6:]}")
        err = _close(f"linear_scan {name}", got, want, SCAN_TOL)
        worst["linear_scan"] = max(worst["linear_scan"], err)
        w_head = w[0, :, :, 0]
        flushed = float((w_head < -126 * np.log(2)).float().mean())
        print(f"  linear_scan {name} max|err| {err:.3e}; log decay per "
              f"step min {float(w_head.min()):.3f}, median "
              f"{float(w_head.median()):.4f}; share of steps decaying "
              f"below 2^-126: {flushed:.2e}; |o| max "
              f"{float(got[0].abs().max()):.3e}")
    return after


def lm_zoo(dev, paths, worst):
    """Phase 10: ZOO_SERVED at full width and cut depth with phase 5's
    protocol (zamba2's scan also held to its plain version on one layer's
    recorded operands), then every ZOO_PARITY architecture card against
    CPU in f32 at full width and cut depth."""
    for arch, (prefix, layers) in ZOO_SERVED.items():
        t0 = time.perf_counter()
        serve_lm(paths, arch, prefix, layers=layers,
                 after=_record_scan(worst) if arch == "zamba2-7b" else None)
        print(f"{arch}: {time.perf_counter() - t0:.1f} s")
    for arch, (layers, prompt) in ZOO_PARITY.items():
        lm_parity(dev, arch, layers, prompt, ZOO_PARITY_STEPS)


def _host_kept(probs: np.ndarray, top_k: int, capacity: int) -> int:
    """The kept assignments of slot-sequential routing, recounted on the
    host from the router's probabilities [G, n, E]: a stable descending
    order (ties to the lower expert), then, choice by choice and token by
    token, an assignment is kept while its expert has had fewer than
    `capacity` assignments before it (kept or dropped)."""
    order = np.argsort(-probs, axis=-1, kind="stable")[..., :top_k]
    kept = 0
    for g in range(probs.shape[0]):
        seen = np.zeros(probs.shape[-1], np.int64)
        for j in range(top_k):
            for e in order[g, :, j]:
                kept += int(seen[e] < capacity)
                seen[e] += 1
    return kept


def _moe_checks(api, params):
    """An `after` for serve_lm on an MoE LM: a 1,025-token prefill (2
    groups of 512 and one token over) must raise moe_apply's ValueError on
    the card; then one prefill of LM_PROMPTS[1] tokens with every layer's
    routing recorded: per group, no expert keeps more than C assignments
    and no capacity slot holds two, and the kept total equals the host's
    recount of the router's top-k."""
    from repro_torch.models import moe
    cfg, dev = api.cfg, params["embed"]["w"].device
    try:
        with torch.no_grad():
            api.prefill(params, {"tokens": torch.zeros(
                (1, MOE_REFUSED), dtype=torch.long, device=dev)},
                MOE_REFUSED + 1)
    except ValueError as e:
        print(f"{cfg.name}: a {MOE_REFUSED}-token prefill is refused on the "
              f"card: {e}")
    else:
        raise RuntimeError(f"{cfg.name}: a {MOE_REFUSED}-token prefill was "
                           "not refused")
    tokens = np.random.default_rng(10).integers(0, cfg.vocab,
                                                size=(1, LM_PROMPTS[1]))
    routing, restore = _routing_recorder(["served"])
    try:
        with torch.no_grad():
            api.prefill(params, {"tokens": torch.as_tensor(tokens,
                                                           device=dev)},
                        LM_PROMPTS[1] + 1)
    finally:
        restore()
    rec = routing["served"]
    if len(rec) != cfg.n_layers:
        raise RuntimeError(f"{cfg.name}: {len(rec)} router calls for "
                           f"{cfg.n_layers} layers")
    kept_by_layer, fullest = [], 0
    for layer, (probs, kept, top_k, C) in enumerate(rec):
        per_expert = kept.sum(dim=(1, 3))                       # [G, E]
        fullest = max(fullest, int(per_expert.max()))
        if int(per_expert.max()) > C or int(kept.sum(dim=1).max()) > 1:
            raise RuntimeError(f"{cfg.name} layer {layer}: an expert keeps "
                               f"{int(per_expert.max())} > C = {C}, or a "
                               "capacity slot holds two tokens")
        want = _host_kept(probs.numpy(), top_k, C)
        if int(kept.sum()) != want:
            raise RuntimeError(f"{cfg.name} layer {layer}: {int(kept.sum())} "
                               f"assignments kept, the host recounts {want}")
        kept_by_layer.append(want)
    G, n, C = moe.moe_groups(LM_PROMPTS[1], cfg.n_experts, cfg.top_k,
                             cfg.moe_capacity, cfg.moe_group_size)
    total = G * n * cfg.top_k
    print(f"{cfg.name}: routing of a {LM_PROMPTS[1]}-token prefill ({G} "
          f"groups of {n}, C = {C}): at most {fullest} kept per expert and "
          f"group; kept of {total} assignments by layer {kept_by_layer} "
          f"(the host's recount equal); dropped "
          f"{100 * (1 - sum(kept_by_layer) / (total * cfg.n_layers)):.2f}%")


def moe_encdec(dev, paths):
    """Phase 11: the MOE_SERVED LMs at full width and cut depth, then
    whisper-large-v3 at WHISPER_SERVED_LAYERS + WHISPER_SERVED_LAYERS
    layers, each behind the 4-slot engine with phase 5's
    protocol (MoE prompts rounded to whole groups; whisper's requests
    WHISPER_FRAMES frames and a WHISPER_PROMPT-token prompt, max_len =
    WHISPER_FRAMES); then PARITY_11 card against CPU in f32."""
    for arch, (prefix, layers) in MOE_SERVED.items():
        t0 = time.perf_counter()
        serve_lm(paths, arch, prefix, after=_moe_checks, layers=layers,
                 requests=_moe_requests)
        print(f"{arch}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve_lm(paths, "whisper-large-v3", "lm_whisper",
             layers=WHISPER_SERVED_LAYERS, requests=_whisper_requests,
             max_len=WHISPER_FRAMES)
    print(f"whisper-large-v3: {time.perf_counter() - t0:.1f} s")
    for arch, kw in PARITY_11.items():
        lm_parity(dev, arch, steps=ZOO_PARITY_STEPS, **kw)


# --------------------------------------------------------------------------- #
# phase 12: LM training
# --------------------------------------------------------------------------- #
def _envelope_err(got, want) -> float:
    """max |got - want| over the envelope max |want| (0 for a zero
    want)."""
    scale = float(want.abs().max())
    err = float((got.float() - want.float()).abs().max())
    return err / scale if scale else err


def check_scan_grads(dev) -> float:
    """SCAN_GRAD_SHAPES: the wrapper's gradients of q, k, v, w, u and the
    initial state (the kernel's forward, the plain version replayed in the
    backward) against the plain version's under autograd, on the card, bf16
    q/k/v; one launch a call (the replay launches none).  Returns the worst
    envelope share."""
    from repro_torch.kernels.linear_scan.ops import linear_scan
    from repro_torch.kernels.linear_scan.ref import linear_scan_chunked
    gen = torch.Generator().manual_seed(12)
    worst = 0.0
    for label, (B, H, T) in SCAN_GRAD_SHAPES.items():
        if label.endswith("rwkv6"):
            mode, (q, k, v, w, u) = "rwkv6", _scan_inputs(
                gen, dev, B, H, T, torch.bfloat16)
        else:
            mode, u = "ssd", None
            q, k, v, w = _mamba2_scan_inputs(gen, dev, B, H, T, 64,
                                             torch.bfloat16)
        s0 = (0.1 * torch.randn((B, H, 64, 64), generator=gen)).to(dev)
        base = [q, k, v, w, u, s0]
        sides = []
        for fn in (linear_scan, linear_scan_chunked):
            ins = [None if t is None else t.clone().requires_grad_()
                   for t in base]
            before = linear_scan.launches
            o, sf = fn(*ins[:5], mode=mode, initial_state=ins[5])
            loss = torch.mean(o * o) + torch.mean(sf * sf)
            live = [t for t in ins if t is not None]
            grads = torch.autograd.grad(loss, live)
            torch.cuda.synchronize()
            launched = linear_scan.launches - before
            sides.append((launched, [o.detach(), sf.detach()], grads,
                          live))
            del o, sf, loss
        (n_kernel, out, grads, live), (n_plain, ref_out, ref, _) = sides
        if n_kernel != 1 or n_plain != 0:
            raise RuntimeError(f"scan gradient {label}: {n_kernel} kernel "
                               f"launches (want 1), plain {n_plain}")
        fwd = _close(f"linear_scan {label} forward", out, ref_out, SCAN_TOL)
        names = ["q", "k", "v", "w", "u", "s0"]
        names = [n for n, t in zip(names, base) if t is not None]
        errs, bad = {}, []
        for name, g, r, t in zip(names, grads, ref, live):
            if g.dtype != t.dtype:
                raise RuntimeError(f"scan gradient {label} {name}: "
                                   f"{g.dtype}, input {t.dtype}")
            errs[name] = _envelope_err(g, r)
            limit = SCAN_GRAD_REL + (SCAN_GRAD_BF16_ULP
                                     if t.dtype == torch.bfloat16 else 0.0)
            if errs[name] > limit:
                bad.append(f"{name} {errs[name]:.3e} > {limit:.3e}")
        print(f"  linear_scan gradient {label} bf16: forward max|err| "
              f"{fwd:.3e}; gradients' max|kernel - plain| / max|plain|: "
              + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
              + f" (limit {SCAN_GRAD_REL}, bf16 leaves + 2^-7); 1 launch, "
              "0 in the backward")
        if bad:
            raise RuntimeError(f"scan gradient {label}: " + "; ".join(bad))
        worst = max(worst, *errs.values())
        del sides, grads, ref, live, base, q, k, v, w, u, s0
        torch.cuda.empty_cache()
    return worst


def _gib(tree) -> float:
    from repro_torch.train.checkpoint import tree_flatten
    return sum(t.nbytes for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor)) / 2**30


def _scan_layers(cfg) -> int:
    return sum(k in ("rwkv6", "mamba2") for k in cfg.layer_kinds())


def _scan_launches(cfg) -> int:
    """The scan's launches in one forward and backward: one for each
    RWKV-6 or Mamba-2 layer, and one more for each that the backward
    recomputes (`cfg.remat`: the layers of whole cycles, not the tail)."""
    P = len(cfg.pattern)
    return sum(1 + bool(cfg.remat and i < cfg.cycles * P)
               for i, k in enumerate(cfg.layer_kinds())
               if k in ("rwkv6", "mamba2"))


def train_full(dev, paths):
    """rwkv6-3b whole, bf16, through `train_lm` (TRAIN_ARGS): every loss
    finite and the last 5 below the first 5 on average; the scan launched
    exactly 2 x 32 times a step; the trained state and the dry-run of the
    step against the card (`check_plan`); then one more step under the
    profiler.  The dry-run traces on the host's CPU in a process of its
    own while the card trains."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.configs import Shape
    from repro_torch.launch.dryrun import plan
    from repro_torch.launch.train import parser
    args = parser().parse_args(TRAIN_ARGS)
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        planned = pool.submit(plan, args.arch, Shape(
            "phase12_train", "train", args.seq_len, args.batch),
            grad_accum=args.grad_accum)
        _train_full(dev, paths, args, planned)


def _train_full(dev, paths, args, planned):
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch.train import train_lm
    from repro_torch.models.zoo import build
    from repro_torch.train.optimizer import adamw, cosine_schedule
    from repro_torch.train.train_state import make_train_step
    cfg = get_arch(args.arch).config
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, hist = counted(paths, "lm_train", lambda: train_lm(args))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in hist]
    want = _scan_launches(cfg) * args.steps
    got = paths["lm_train"]["linear_scan"]
    if got != want:
        raise RuntimeError(f"lm_train launched linear_scan {got} times, "
                           f"expected {_scan_launches(cfg)} x "
                           f"{args.steps} = {want}")
    if not all(np.isfinite(losses)) or len(losses) != args.steps:
        raise RuntimeError(f"{cfg.name} training losses {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first:
        raise RuntimeError(f"{cfg.name}: the last 5 losses' mean {last:.4f} "
                           f"is not below the first 5's {first:.4f}")
    dts = [h["dt_s"] for h in hist[TRAIN_TIMED_FROM:]]
    p50 = float(np.median(dts))
    tokens = args.batch * args.seq_len
    opt_state = state["opt"]
    print(f"{_describe(cfg)}: trained {args.steps} steps of {args.batch} x "
          f"{args.seq_len} tokens in {wall:.1f} s: "
          f"{_n_params(state['params']) / 1e9:.3f}B parameters, params "
          f"{_gib(state['params']):.2f} GiB, optimizer state "
          f"{_gib(opt_state):.2f} GiB, peak {peak:.2f} GiB allocated")
    print(f"{cfg.name} training: ms a step p50 {p50 * 1e3:.1f} (steps "
          f"{TRAIN_TIMED_FROM + 1}-{args.steps}: min {min(dts) * 1e3:.1f}, "
          f"max {max(dts) * 1e3:.1f}), {tokens / p50:.1f} tokens/s; scan "
          f"launches {got} = {_scan_launches(cfg)} a step x {args.steps}; "
          f"losses {' '.join(f'{x:.4f}' for x in losses)} (first 5 mean "
          f"{first:.4f}, last 5 {last:.4f})")
    check_plan(args, cfg, state, peak * 2**30, p50, planned.result())
    api = build(cfg, max_position=args.seq_len)
    step = make_train_step(api.loss, adamw(lr=cosine_schedule(
        args.lr, 10, args.steps), weight_decay=0.1), donate=True)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in TokenStream(
        vocab=cfg.vocab, batch=args.batch, seq_len=args.seq_len,
        seed=args.seed).batch_at(args.steps).items()}
    profiled(f"one {cfg.name} training step ({tokens} tokens)",
             lambda: step(state, batch))
    del state, step, batch
    torch.cuda.empty_cache()


def check_plan(args, cfg, state, peak_bytes: float, step_s: float,
               rec: dict):
    """The planner against the card, on the state `train_full` trained:
    every leaf of `state_specs(param_specs(), adamw)` equal to the card's
    in shape, dtype and bytes (totals printed); then `rec`, the dry-run of
    the same step (launch/dryrun.py's `plan`: 4 x 1,024 tokens, grad_accum
    1, donated state, traced on meta tensors), its peak held to the card's
    `max_memory_allocated` within PLAN_PEAK_TOL, its roofline step time
    and roofline_fraction printed beside the measured median step."""
    from repro_torch.models.zoo import build
    from repro_torch.train.checkpoint import tree_flatten
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.train_state import state_specs
    t0 = time.perf_counter()
    api = build(cfg, max_position=args.seq_len)
    specs = state_specs(api.param_specs(), adamw(weight_decay=0.1))
    (got, paths), (want, want_paths) = tree_flatten(state), \
        tree_flatten(specs)
    if paths != want_paths:
        raise RuntimeError(f"{cfg.name}: the trained state's leaves "
                           f"{len(paths)} differ from state_specs' "
                           f"{len(want_paths)}")
    bad = [(p, tuple(g.shape), g.dtype, g.nbytes,
            tuple(w.shape), w.dtype, w.nbytes)
           for p, g, w in zip(paths, got, want)
           if (g.shape, g.dtype, g.nbytes) != (w.shape, w.dtype, w.nbytes)]
    if bad:
        raise RuntimeError(f"{cfg.name}: {len(bad)} leaves differ from "
                           f"state_specs, first {bad[0]}")
    gib = lambda tree: sum(t.nbytes for t in tree_flatten(tree)[0]) / 2**30
    print(f"{cfg.name} state against state_specs: {len(paths)} leaves equal "
          f"in shape, dtype and bytes; params {gib(state['params']):.2f} / "
          f"{gib(specs['params']):.2f} GiB, AdamW state "
          f"{gib(state['opt']):.2f} / {gib(specs['opt']):.2f} GiB (card / "
          f"specs)")
    traced, terms = rec["memory"]["total_bytes"], rec["roofline"]
    gap = traced / peak_bytes - 1
    print(f"{cfg.name} dry-run of the step (traced in {rec['trace_s']:.1f} "
          f"s, {rec['cost']['aten_ops']} aten ops, linear_scan "
          f"{rec['kernels']['linear_scan']['calls']} calls): traced peak "
          f"{traced / 2**30:.2f} GiB (arguments "
          f"{rec['memory']['argument_bytes'] / 2**30:.2f}, temp "
          f"{rec['memory']['temp_bytes'] / 2**30:.2f}) against "
          f"max_memory_allocated {peak_bytes / 2**30:.2f} GiB "
          f"({100 * gap:+.1f}%); roofline step "
          f"{terms['step_time_s'] * 1e3:.1f} ms ({terms['dominant']}: compute "
          f"{terms['compute_s'] * 1e3:.1f} ms for "
          f"{rec['cost']['flops']:.4e} flops, memory "
          f"{terms['memory_s'] * 1e3:.1f} ms for "
          f"{rec['cost']['bytes_accessed']:.4e} bytes) against the measured "
          f"{step_s * 1e3:.1f} ms a step ({terms['step_time_s'] / step_s:.3f} "
          f"of it), roofline_fraction {terms['roofline_fraction']:.4f}; the "
          f"check took {time.perf_counter() - t0:.1f} s after training")
    print(f"dry-run record: {json.dumps(rec)}")
    if abs(gap) > PLAN_PEAK_TOL:
        raise RuntimeError(f"{cfg.name}: traced peak {traced} bytes is "
                           f"{100 * gap:+.1f}% off the card's {peak_bytes:.0f}"
                           f" (limit {100 * PLAN_PEAK_TOL:.0f}%)")


def train_resume(dev, paths):
    """The kill row: KILL_LM_STEPS steps of rwkv6-3b at KILL_LM_LAYERS
    layers uninterrupted, then again with a checkpoint every KILL_LM_EVERY
    steps and a SimulatedPreemption at KILL_LM_AT, restarted from the
    newest commit on the stream seeked to it: 0 steps lost, params and
    losses as the uninterrupted run's (KILL_LM_*_REL)."""
    import shutil
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenStream
    from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                         SimulatedPreemption)
    from repro_torch.models.zoo import build
    from repro_torch.train.checkpoint import latest_step
    from repro_torch.train.loop import LoopConfig, run_loop
    from repro_torch.train.optimizer import (adamw, cosine_schedule,
                                             tree_leaves)
    from repro_torch.train.train_state import init_state, make_train_step
    args = dict(zip(TRAIN_ARGS[::2], TRAIN_ARGS[1::2]))
    B, T = int(args["--batch"]), int(args["--seq-len"])
    cfg = get_arch("rwkv6-3b").config.with_(n_layers=KILL_LM_LAYERS)
    api = build(cfg, max_position=T)
    opt = adamw(lr=cosine_schedule(3e-3, 10, KILL_LM_STEPS),
                weight_decay=0.1)
    step = make_train_step(api.loss, opt, donate=True)
    stream = TokenStream(vocab=cfg.vocab, batch=B, seq_len=T, seed=0)
    on_card = lambda it: ({k: torch.as_tensor(v, device=dev)
                           for k, v in b.items()} for b in it)
    fresh = lambda: init_state(api.init(seed=0, device=dev), opt)
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    ckpt = dict(ckpt_dir=str(TRAIN_CKPT_DIR), ckpt_every=KILL_LM_EVERY,
                ckpt_keep=2, log_every=100)
    t0 = time.perf_counter()
    try:
        def runs():
            ref, ref_hist = run_loop(step, fresh(), on_card(stream),
                                     LoopConfig(KILL_LM_STEPS,
                                                log_every=100))
            ref_params = [t.clone() for t in tree_leaves(ref["params"])]
            del ref
            done = []
            try:
                run_loop(step, fresh(), on_card(stream), LoopConfig(
                    KILL_LM_STEPS, injector=FailureInjector(KILL_LM_AT),
                    metrics_hook=lambda s, m: done.append(s), **ckpt))
            except SimulatedPreemption as e:
                print(f"{cfg.name} x {KILL_LM_LAYERS} layers: {e} after "
                      f"steps {done}")
            else:
                raise RuntimeError("the injected preemption did not fire")
            start = latest_step(TRAIN_CKPT_DIR)
            state, hist = run_loop(step, fresh(),
                                   on_card(stream.iter_from(start)),
                                   LoopConfig(KILL_LM_STEPS, **ckpt))
            return ref_params, ref_hist, done, start, state, hist
        ref_params, ref_hist, done, start, state, hist = counted(
            paths, "lm_train_resume", runs)
    finally:
        shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    ran = len(ref_hist) + len(done) + len(hist)
    want = _scan_launches(cfg) * ran
    if paths["lm_train_resume"]["linear_scan"] != want:
        raise RuntimeError(f"lm_train_resume launched linear_scan "
                           f"{paths['lm_train_resume']['linear_scan']} "
                           f"times, expected {_scan_launches(cfg)} x "
                           f"{ran} = {want}")
    lost = KILL_LM_STEPS - (start + len(hist))
    if lost or int(state["step"]) != KILL_LM_STEPS or \
            [h["step"] for h in hist] != list(range(start, KILL_LM_STEPS)):
        ran_steps = [h["step"] for h in hist]
        raise RuntimeError(f"resumed at {start}, ran {ran_steps}, step "
                           f"counter {int(state['step'])}: {lost} steps "
                           "lost")
    exact, worst_p = True, 0.0
    for a, b in zip(tree_leaves(state["params"]), ref_params):
        exact = exact and torch.equal(a, b)
        d = (a.float() - b.float()).abs()
        lim = KILL_LM_PARAM_REL * b.float().abs() + 1e-6
        if (d > lim).any():
            raise RuntimeError(f"resumed params differ beyond "
                               f"{KILL_LM_PARAM_REL} relative: max "
                               f"{float(d.max()):.3e}")
        worst_p = max(worst_p, float(d.max()))
    losses = [h["loss"] for h in hist]
    ref_losses = [h["loss"] for h in ref_hist[start:]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    if rel > KILL_LM_LOSS_REL:
        raise RuntimeError(f"resumed losses {losses} against {ref_losses}")
    shown = " ".join(f"{x:.4f}" for x in losses)
    print(f"{cfg.name} x {KILL_LM_LAYERS} layers, kill at step {KILL_LM_AT}"
          f": resumed from the checkpoint of step {start}, 0 steps lost "
          f"({len(done) - start} step redone), params max|resumed - "
          f"uninterrupted| {worst_p:.3e} (bit-exact: {exact}), losses max "
          f"relative difference {rel:.3e} ({shown}); "
          f"{time.perf_counter() - t0:.1f} s")
    del state, ref_params
    torch.cuda.empty_cache()


def _leaves_close(what, got, want, rel=TRAIN_REL) -> float:
    """Every leaf (a list of tensors against CPU tensors) within `rel` of
    its envelope; returns the worst share."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        err = _envelope_err(g.cpu(), w)
        if err > rel:
            raise RuntimeError(f"{what}: leaf {i} {tuple(w.shape)} differs "
                               f"by {err:.3e} of its envelope (limit {rel})")
        worst = max(worst, err)
    return worst


class _FirstGrads:
    """A compressor stand-in for the parity rows: keeps the gradients the
    train step hands it on its first call (then applies `inner`, if
    any), so the first step's own gradients are compared."""

    def __init__(self, inner=None):
        self.inner, self.grads = inner, None

    def init(self, grads):
        return None if self.inner is None else self.inner.init(grads)

    def apply(self, grads, err):
        if self.grads is None:
            self.grads = grads
        return (grads, err) if self.inner is None else self.inner.apply(
            grads, err)


def train_parity(dev, arch, layers=None, smoke=False, grad_accum=1,
                 compress=None, paths=None):
    """`arch` in f32 (full width at `layers` layers, or its SMOKE config)
    card against CPU from the same weights: TRAIN_PARITY_STEPS steps
    (TRAIN_PARITY's optimizer, the step consuming its state as train_lm's
    does), the first one's gradients, every step's loss, the params after
    the last; an MoE's routing equal call by call."""
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenStream
    from repro_torch.distributed.compression import topk_compressor
    from repro_torch.kernels.linear_scan.ops import linear_scan
    from repro_torch.models.zoo import build
    from repro_torch.train.optimizer import sgd, tree_leaves
    from repro_torch.train.train_state import init_state, make_train_step
    spec = get_arch(arch)
    cfg = (spec.smoke if smoke else spec.config.with_(
        n_layers=layers, enc_layers=layers if spec.config.enc_layers else 0))
    cfg = cfg.with_(dtype=torch.float32)
    api = build(cfg, max_position=TRAIN_PARITY_T)
    t0 = time.perf_counter()
    params = api.init(seed=1, device=dev)
    sides = (("card", dev, params), ("cpu", "cpu", _to(params, "cpu")))
    stream = TokenStream(vocab=cfg.vocab, batch=TRAIN_PARITY_B,
                         seq_len=TRAIN_PARITY_T, seed=2,
                         d_frontend=cfg.d_model if cfg.enc_layers else None)
    on = lambda b, d: {k: torch.as_tensor(v, device=d) for k, v in b.items()}
    side = ["card"]
    routing, restore = (_routing_recorder(side) if cfg.n_experts
                        else ({}, lambda: None))
    launches = {"card": 0, "cpu": 0}
    try:
        def card_then_cpu(fn):
            """fn(side index, device, params) on each side; the card's
            call counted on the lm_train_parity path when the model runs
            the scan."""
            out = []
            for i, (side[0], d, p) in enumerate(sides):
                if side[0] == "card" and _scan_layers(cfg):
                    before = paths.get("lm_train_parity",
                                       {}).get("linear_scan", 0)
                    out.append(counted(paths, "lm_train_parity",
                                       lambda: fn(i, d, p), quiet=True))
                    launches["card"] += (paths["lm_train_parity"]
                                         ["linear_scan"] - before)
                else:
                    linear_scan.launches = 0
                    out.append(fn(i, d, p))
                    launches[side[0]] += linear_scan.launches
            return out
        o = sgd(lr=3e-3)
        comp = (topk_compressor(compress, group=api.stack_key)
                if compress else None)
        record = [_FirstGrads(comp), _FirstGrads(comp)]
        steps = [make_train_step(api.loss, o, grad_accum=grad_accum,
                                 compressor=r, donate=True) for r in record]

        st = [init_state(p, o) for _, _, p in sides]
        if comp is not None:
            for s_, (_, _, p) in zip(st, sides):
                s_["comp"] = comp.init(p)
        losses = []
        for n in range(TRAIN_PARITY_STEPS):
            b = stream.batch_at(n)
            pairs = card_then_cpu(lambda i, d, p: steps[i](st[i], on(b, d)))
            st = [pairs[0][0], pairs[1][0]]
            lc, lh = (float(m["loss"]) for _, m in pairs)
            if abs(lc - lh) > TRAIN_REL * abs(lh):
                raise RuntimeError(f"{arch} step {n} loss card {lc}, CPU "
                                   f"{lh}")
            losses.append((lc, lh))
            if n == 0:
                g_err = _leaves_close(f"{arch} gradients",
                                      tree_leaves(record[0].grads),
                                      tree_leaves(record[1].grads))
                for r in record:
                    r.grads = False          # recorded; keep no more
        p_err = _leaves_close(f"{arch} params after {TRAIN_PARITY_STEPS} "
                              "steps", tree_leaves(st[0]["params"]),
                              tree_leaves(st[1]["params"]))
    finally:
        restore()
    want = _scan_launches(cfg) * TRAIN_PARITY_STEPS * grad_accum
    if launches["card"] != want or launches["cpu"]:
        raise RuntimeError(f"{arch}: the scan launched {launches}, expected "
                           f"{want} on the card and none on the CPU")
    note = ""
    if cfg.n_experts:
        card, host = routing["card"], routing["cpu"]
        if len(card) != len(host) or not all(
                torch.equal(a[1], b[1]) for a, b in zip(card, host)):
            raise RuntimeError(f"{arch}: the card's MoE routing differs from "
                               "the CPU's")
        note = f"; routing equal in all {len(card)} router calls"
    print(f"{_describe(cfg)}: card against CPU, {TRAIN_PARITY_B} x "
          f"{TRAIN_PARITY_T} tokens"
          + (f" over {TRAIN_PARITY_T} frames" if cfg.enc_layers else "")
          + f", grad_accum {grad_accum}"
          + (f", top-k compressor keeping {compress}" if compress else "")
          + f": gradients within {g_err:.2e} of their envelopes, losses "
          + " ".join(f"{a:.6f}/{b:.6f}" for a, b in losses)
          + f", params after {TRAIN_PARITY_STEPS} steps within {p_err:.2e};"
          f" scan launches {want}{note} ({time.perf_counter() - t0:.1f} s)")
    del params, sides, st
    torch.cuda.empty_cache()


def lm_train(dev, paths, worst):
    """Phase 12: the scan's gradient on the card, rwkv6-3b whole through
    `train_lm`, the kill row, and the card-against-CPU training steps."""
    def step(what, fn):
        print(f"-- {what}")
        t0 = time.perf_counter()
        out = fn()
        print(f"   ({time.perf_counter() - t0:.1f} s)")
        return out
    worst["linear_scan_grad"] = step(
        "the scan's gradient: kernel forward, plain backward replayed",
        lambda: check_scan_grads(dev))
    step("rwkv6-3b whole, bf16, through launch/train.py",
         lambda: train_full(dev, paths))
    step(f"kill and resume: rwkv6-3b x {KILL_LM_LAYERS} layers",
         lambda: train_resume(dev, paths))
    for arch, kw in TRAIN_PARITY.items():
        step(f"{arch}: training steps card against CPU, f32",
             lambda: train_parity(dev, arch, paths=paths, **kw))


def _device_events(prof) -> dict:
    """Device time (us) and count of each device event (kernels, copies,
    fills) by name, read from the profiler's raw events: the profiler's
    own `key_averages` builds an object a host event too, minutes for
    the hundred thousand launches of a training step."""
    from torch.autograd import DeviceType
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            t = out.setdefault(e.name(), [0.0, 0])
            t[0] += e.duration_ns() / 1e3
            t[1] += 1
    return out


def profiled(what: str, fn, top: int = 8):
    """Trace `fn` with torch.profiler and print the device's busy share of
    its wall time and the kernels that fill it (one stream, so summed
    kernel time is busy time).  Returns (busy share, device events), or
    None when the profiler recorded no device events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = _device_events(prof)
    busy_us = sum(t for t, _ in kernels.values())
    if busy_us == 0:
        print(f"{what}: device busy share not measured (the profiler "
              "recorded no device events)")
        return None
    launches = sum(n for _, n in kernels.values())
    print(f"profiled {what}: wall {wall_us / 1e3:.2f} ms, "
          f"device busy {busy_us / 1e3:.2f} ms "
          f"({100 * busy_us / wall_us:.1f}%), {launches} kernel launches")
    for name, (t, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0]
                               )[:top]:
        print(f"  {t / 1e3:8.3f} ms {n:6d}x {name[:90]}")
    own = [(k, t, n) for name, (t, n) in kernels.items()
           for k in OWN_KERNELS if k in name]
    print("  the port's kernels: " + (", ".join(
        f"{k} {t / 1e3:.3f} ms in {n}" for k, t, n in own) or "none"))
    return busy_us / wall_us, launches


def profile_ticks(srv, ys, us):
    """PROFILE_TICKS more ticks under the profiler."""
    def ticks():
        for t in range(TICKS, TICKS + PROFILE_TICKS):
            _stream(srv, ys, us, t)
    profiled(f"{PROFILE_TICKS} ticks", ticks)


# --------------------------------------------------------------------------- #
# offline model recovery
# --------------------------------------------------------------------------- #
def _finite_traces(system, seed, batch, dev, horizon=None, noise_std=0.0):
    """simulate_batch from seed, seed + 1000, ... until every trace is
    finite: F-8's open-loop cubic terms diverge from some initial states
    (benchmarks/table1_accuracy.py resamples the same way)."""
    from repro_torch.systems.simulate import simulate_batch
    for attempt in range(10):
        gen = torch.Generator().manual_seed(seed + 1000 * attempt)
        tr = simulate_batch(system, gen, batch, horizon=horizon,
                            noise_std=noise_std, device=dev)
        if bool(torch.isfinite(tr.ys).all()):
            return tr, gen
    raise RuntimeError(f"{system.spec.name}: no finite traces in 10 draws")


def simulate_systems(dev, paths):
    """Every registered system: 4 traces of its default horizon at 10 RK4
    substeps a sample, on the card (counted) and on the CPU from the same
    y0 and inputs."""
    from repro_torch.systems.simulate import register_systems, simulate_from
    for i, (name, cls) in enumerate(sorted(register_systems().items())):
        system = cls()
        gen = torch.Generator().manual_seed(20 + i)
        y0 = system.sample_y0(gen, (4,))
        us = system.sample_inputs(gen, system.spec.horizon,
                                  (4,)).movedim(0, 1)
        t0 = time.perf_counter()
        card = counted(paths, "simulate",
                       lambda: simulate_from(system, y0, us, device=dev),
                       quiet=True)
        card_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        cpu = simulate_from(system, y0, us, device="cpu")
        cpu_ms = (time.perf_counter() - t0) * 1e3
        rel = SIM_REL.get(name, SIM_REL_DEFAULT)
        err = _close_traces(f"simulate {name}", card.ys.cpu(), cpu.ys, rel)
        bad = int((~torch.isfinite(cpu.ys).flatten(1).all(dim=1)).sum())
        print(f"  {name:18s} {tuple(card.ys.shape)} card {card_ms:8.2f} ms, "
              f"CPU {cpu_ms:8.2f} ms, max|card - CPU| {err:.3e} (limit "
              f"{rel} of the envelope), diverged traces {bad}")
    print(f"kernel launches on the simulate path: {paths['simulate']}")


def _timed_path(paths, path, steps, fn):
    """Run `fn` as a counted path; returns (result, ms per step, this
    run's launches per step)."""
    before = dict(paths.get(path, {}))
    t0 = time.perf_counter()
    out = counted(paths, path, fn)
    ms = (time.perf_counter() - t0) * 1e3 / steps
    per = {k: (v - before.get(k, 0)) / steps
           for k, v in paths[path].items() if v - before.get(k, 0)}
    return out, ms, per


def table1(dev, paths):
    """Table I's quick protocol (benchmarks/table1_accuracy.py: 4 traces of
    250 samples, noise 0.01, windows of 24 at stride 8, hidden 64, one
    seed): MERINDA, EMILY and PINN+SR fit TABLE1_STEPS steps each, then
    all three are scored by the clamped reconstruction MSE."""
    from repro_torch.core.emily import Emily, EmilyConfig
    from repro_torch.core.merinda import Merinda, MerindaConfig
    from repro_torch.core.metrics import reconstruction_mse
    from repro_torch.core.pinn_sr import PinnSR, PinnSRConfig
    from repro_torch.core.trainer import fit
    from repro_torch.data.pipeline import WindowDataset
    from repro_torch.systems.simulate import register_systems
    steps = TABLE1_STEPS
    rows = {}
    for name in TABLE1_SYSTEMS:
        system = register_systems()[name]()
        spec = system.spec
        tr, gen = _finite_traces(system, 0, 4, dev, horizon=250,
                                 noise_std=0.01)
        ds = WindowDataset.from_trace(tr.ys_noisy, tr.us, tr.dt, window=24,
                                      stride=8)
        mer = Merinda(MerindaConfig(
            n=spec.n, m=spec.m, order=spec.order, dt=spec.dt, hidden=64,
            n_active=int((np.abs(system.true_theta()) > 0).sum())))
        p = mer.init(gen, mer.norm_stats(ds.y_win, ds.u_win), device=dev)
        res_m, ms_m, per_m = _timed_path(paths, "table1_merinda", steps,
                                         lambda: fit(mer, p, ds.batches(
                                             gen, 64, epochs=100_000),
                                             steps=steps, lr=3e-3))
        em = Emily(EmilyConfig(n=spec.n, m=spec.m, order=spec.order,
                               dt=spec.dt, hidden=64))
        p = em.init(gen, device=dev)
        res_e, ms_e, _ = _timed_path(paths, "table1_emily", steps,
                                     lambda: fit(em, p, ds.batches(
                                         gen, 64, epochs=100_000),
                                         steps=steps, lr=3e-3))
        pm = PinnSR(PinnSRConfig(n=spec.n, m=spec.m, order=spec.order,
                                 dt=spec.dt, horizon=tr.ys.shape[1] - 1))
        p = pm.init(gen, tr.ys[0], device=dev)
        batch = (tr.ys_noisy[0], tr.us[0])
        rounds = (int(steps * 0.6), int(steps * 0.8))   # the SR rounds
        post = lambda step, q: pm.apply_threshold(q) if step in rounds else q
        res_p, ms_p, _ = _timed_path(paths, "table1_pinn_sr", steps,
                                     lambda: fit(pm, p, iter(lambda: batch,
                                                             None),
                                                 steps=steps, lr=2e-3,
                                                 post_step=post))

        def score():
            thetas = {"merinda": mer.recover(res_m.params, ds.y_win,
                                             ds.u_win),
                      "emily": em.recover(res_e.params, ds.y_win, ds.u_win),
                      "pinn_sr": pm.recover(res_p.params)}
            return {k: reconstruction_mse(mer.lib, th, ds.y_win, ds.u_win,
                                          spec.dt)
                    for k, th in thetas.items()}
        mse = counted(paths, "table1_score", score)
        for method, res in (("merinda", res_m), ("emily", res_e),
                            ("pinn_sr", res_p)):
            if not np.isfinite(mse[method]) or not res.history:
                raise RuntimeError(f"table1 {name} {method}: MSE "
                                   f"{mse[method]}, {len(res.history)} "
                                   "finite steps")
        rows[name] = mse
        print(f"  {name}: {ds.n_windows} windows; MSE merinda "
              f"{mse['merinda']:.6g}, emily {mse['emily']:.6g}, pinn_sr "
              f"{mse['pinn_sr']:.6g}; ms per step merinda {ms_m:.2f}, "
              f"emily {ms_e:.2f}, pinn_sr {ms_p:.2f}; merinda launches per "
              f"step {per_m}; nan restarts "
              f"{res_m.nan_restarts}/{res_e.nan_restarts}/"
              f"{res_p.nan_restarts}")
    print(f"table1 MSE: {json.dumps(rows)}")


def train_f8(dev, paths):
    """examples/train_f8_crusader.py's shape: 8 traces, noise 0.005, windows
    of 24 at stride 6 (776), hidden 96, batches of 64, lr 2e-3, then
    recover (polished) and the reconstruction MSE over all 776 windows.
    The first F8_PARITY_STEPS steps are replayed on the CPU on the same
    batches from the same params: losses within rtol 1e-3 (the multi-step
    tolerance of tests/test_torch_model.py)."""
    from itertools import islice

    from repro_torch.core.merinda import Merinda, MerindaConfig
    from repro_torch.core.trainer import fit
    from repro_torch.data.pipeline import WindowDataset
    from repro_torch.systems.f8_crusader import F8Crusader
    system = F8Crusader()
    tr, gen = _finite_traces(system, 0, 8, dev, noise_std=0.005)
    ds = WindowDataset.from_trace(tr.ys_noisy, tr.us, tr.dt, window=24,
                                  stride=6)
    model = Merinda(MerindaConfig(
        n=3, m=1, order=3, dt=tr.dt, hidden=96,
        n_active=int((np.abs(system.true_theta()) > 0).sum())))
    params = model.init(gen, model.norm_stats(ds.y_win, ds.u_win),
                        device=dev)
    batches = list(islice(ds.batches(gen, 64, epochs=10_000), F8_STEPS))
    res, ms, per = _timed_path(paths, "train_f8", F8_STEPS, lambda: fit(
        model, params, iter(batches), steps=F8_STEPS, lr=2e-3))

    def recover():
        theta = model.recover(res.params, ds.y_win, ds.u_win)
        return theta, float(model.reconstruction_mse(theta, ds.y_win,
                                                     ds.u_win))
    t0 = time.perf_counter()
    theta, mse = counted(paths, "f8_recover", recover)
    rec_ms = (time.perf_counter() - t0) * 1e3
    if not (np.isfinite(mse) and torch.isfinite(theta).all()):
        raise RuntimeError(f"train_f8: MSE {mse}, theta {theta}")
    print(f"  {ds.n_windows} windows; {F8_STEPS} steps, "
          f"{res.nan_restarts} nan restarts, loss {res.history[0]:.5g} -> "
          f"{res.history[-1]:.5g}; {ms:.2f} ms per step, launches per step "
          f"{per}; recover (polished) + reconstruction MSE {rec_ms:.2f} ms, "
          f"MSE {mse:.6g}")
    print(f"  recovered: {model.lib.coeff_dict(theta)}")
    # the CPU replay switches the sparsify mask on at the card's step
    # (fit's default: half the steps), or never within its own steps
    switch = min(int(F8_STEPS * 0.5) + 0.5, F8_PARITY_STEPS)
    cpu = fit(model, _to(params, "cpu"),
              iter([(y.cpu(), u.cpu()) for y, u in
                    batches[:F8_PARITY_STEPS]]),
              steps=F8_PARITY_STEPS, lr=2e-3,
              sparsify_after=switch / F8_PARITY_STEPS)
    card = res.history[:F8_PARITY_STEPS]
    if cpu.nan_restarts or not np.allclose(card, cpu.history, rtol=1e-3,
                                           atol=0):
        raise RuntimeError(f"train_f8 losses: card {card}, CPU "
                           f"{cpu.history}")
    print(f"  first {F8_PARITY_STEPS} losses, card {card}, CPU "
          f"{cpu.history}: within rtol 1e-3")
    profiled("5 F-8 fit steps (hidden 96, 64 windows)",
             lambda: fit(model, res.params, iter(batches[:5]), steps=5,
                         lr=2e-3))


def fleet_offline(dev, paths):
    """examples/fleet_twinning.py's shape: 16 F-8 twins, 32 windows each
    (24 samples at stride 8), hidden 64, n_active 24, FLEET_STEPS fused
    steps, then recover_all."""
    from repro_torch.core.fleet import FleetConfig, FleetMerinda
    from repro_torch.core.merinda import MerindaConfig
    from repro_torch.data.pipeline import make_windows
    from repro_torch.systems.f8_crusader import F8Crusader
    F = 16
    system = F8Crusader()
    tr, gen = _finite_traces(system, 0, F, dev, noise_std=0.005)
    y_win, u_win = make_windows(tr.ys_noisy, tr.us, window=24, stride=8)
    y_win = y_win.unflatten(0, (F, -1))[:, :32].contiguous()
    u_win = u_win.unflatten(0, (F, -1))[:, :32].contiguous()
    fleet = FleetMerinda(FleetConfig(merinda=MerindaConfig(
        n=3, m=1, order=3, dt=system.spec.dt, hidden=64, n_active=24),
        fleet=F), device=dev)
    state = fleet.init(gen)

    def run(state, steps):
        for _ in range(steps):
            state, loss = fleet.train_step(state, y_win, u_win)
        return state, float(loss)
    (state, loss), ms, per = _timed_path(paths, "fleet_offline", FLEET_STEPS,
                                         lambda: run(state, FLEET_STEPS))
    thetas = counted(paths, "fleet_offline",
                     lambda: fleet.recover_all(state, y_win, u_win))
    if not (np.isfinite(loss) and torch.isfinite(thetas).all()):
        raise RuntimeError(f"fleet_offline: loss {loss}")
    print(f"  {F} twins x {y_win.shape[1]} windows: {FLEET_STEPS} fused "
          f"steps, {ms:.2f} ms per step ({ms / F:.3f} ms per twin), "
          f"launches per step {per}, last loss {loss:.5g}; recover_all "
          f"theta {tuple(thetas.shape)}, mean |theta| "
          f"{float(thetas.abs().mean()):.4f}")
    profiled("3 fused fleet steps (16 twins)", lambda: run(state, 3))


def offline(dev, paths):
    for what, fn in (("simulate: every registered system", simulate_systems),
                     ("table1: quick protocol", table1),
                     ("train_f8: F-8 training, hidden 96", train_f8),
                     ("fleet_offline: 16 F-8 twins", fleet_offline)):
        print(f"-- {what}")
        t0 = time.perf_counter()
        fn(dev, paths)
        print(f"   ({time.perf_counter() - t0:.1f} s)")


# --------------------------------------------------------------------------- #
# phase 9, the fleet: TwinService conformance, the sharded fleet, scale,
# federation
# --------------------------------------------------------------------------- #
def _nvidia_smi(*query) -> list[list[str]]:
    out = subprocess.run(["nvidia-smi", *query, "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout
    return [[x.strip() for x in line.split(",")]
            for line in out.splitlines() if line.strip()]


def _check_no_deaths(name, reports, allowed=()):
    """Fail on any shard or worker death the chaos schedule did not order:
    `allowed` holds the report indices where the planned one may show."""
    for k, r in enumerate(reports):
        if k in allowed:
            continue
        if r.dead_shards or r.restarted:
            raise RuntimeError(f"{name}: unplanned death at tick {r.tick} "
                               f"({r.dead_shards} down, restarted "
                               f"{r.restarted})")


def _fleet_summary(name, srv, paths, path, smi, workers=None):
    """One line a fleet run: tick p50/p99, violations, refreshes/s and the
    per-stage ms (registry histograms), the path's launches (a federated
    run's: its workers'), the card."""
    lat, st = srv.latency_summary(), srv.stage_summary()
    counts = paths[workers or path]
    print(f"  {name}: tick p50 {lat['p50_ms']:.2f} ms, p99 "
          f"{lat['p99_ms']:.2f} ms ({lat['ticks']} ticks), violations "
          f"{lat['violations']}, {lat['twin_refreshes_per_s']:.1f} twin "
          f"refreshes/s; stages " + ", ".join(
              f"{k} {v:.2f}" for k, v in st.items())
          + f"; launches gru_scan {counts['gru_scan']}, rk4_poly "
          f"{counts['rk4_poly']}{' (workers)' if workers else ''} [{smi}]")
    return lat, st


def _worker_launches(paths, path, before, after):
    """The kernels' launches the workers made between two
    `worker_processes()` reads, recorded as the path's; both kernels must
    have run in every worker."""
    total = paths.setdefault(path, dict(gru_scan=0, rk4_poly=0,
                                        linear_scan=0))
    for b, a in zip(before, after):
        d = {k: int(a[f"{k}_launches"] - b[f"{k}_launches"])
             for k in ("gru_scan", "rk4_poly")}
        if not a["device"].startswith("cuda") or min(d.values()) <= 0:
            raise RuntimeError(f"{path}: worker pid {int(a['pid'])} on "
                               f"{a['device']} launched {d}")
        for k, v in d.items():
            total[k] += v
    print(f"kernel launches on the {path} path: {total}")


def _workers_on_card(srv, name):
    """Each worker serves on the card: it reports a CUDA device, and
    nvidia-smi lists a compute process for it beside this one.  An
    nvidia-smi outside this process's pid namespace names every process
    pid 1; then the count of listed processes stands in for the pids.
    Returns what each worker reported."""
    procs = srv.worker_processes()
    apps = _nvidia_smi("--query-compute-apps=pid,used_memory")
    pids = [int(p["pid"]) for p in procs]
    seen = {int(a[0]) for a in apps if a[0].isdigit()}
    if set(pids) <= seen:
        how = "every worker pid listed"
    elif len(apps) >= len(pids) + 1:
        how = (f"pids not visible (nvidia-smi lists {sorted(seen)}); "
               f"{len(apps)} compute processes for {len(pids)} workers + "
               "this one")
    else:
        raise RuntimeError(f"{name}: nvidia-smi lists {apps} for worker "
                           f"pids {pids}")
    if not all(p["device"].startswith("cuda") for p in procs):
        raise RuntimeError(f"{name}: a worker is not on the card: {procs}")
    print(f"  {name}: workers {pids} on " + ", ".join(
        sorted({p['device'] for p in procs})) + f"; {how}; nvidia-smi used "
        f"memory {[a[1] for a in apps]}; torch allocated per worker "
        f"{[round(p['memory_allocated'] / 2**20, 1) for p in procs]} MiB "
        f"(peak {[round(p['max_memory_allocated'] / 2**20, 1) for p in procs]})")
    return procs


def _boot_line(srv) -> str:
    h = srv._m_boot
    return (f"worker boot {h.count} x mean {h.sum / max(h.count, 1):.2f} s, "
            f"max {h.max:.2f} s")


# -- 1. conformance ---------------------------------------------------------- #
def _conformance_cfg(dt):
    from repro_torch.core.merinda import MerindaConfig
    from repro_torch.twin.monitor import GuardConfig
    from repro_torch.twin.server import TwinServerConfig
    return TwinServerConfig(
        merinda=MerindaConfig(n=2, m=0, order=2, hidden=8, head_hidden=8,
                              n_active=4, dt=dt),
        max_twins=CONF_TWINS, refit_slots=2, capacity=128, window=16,
        stride=8, windows_per_twin=4, steps_per_tick=1, deploy_after=10 ** 6,
        min_residency=1, guard=GuardConfig(window=16))


def _conformance_run(srv, ys, true):
    """tests/test_service_conformance.py's scenario: healthy, damaged
    (negated theta on CONF_DAMAGED), repaired; per tick the events and the
    per-shard losses."""
    for tid in range(CONF_TWINS):
        srv.register(tid)
    srv.deploy_many(list(range(CONF_TWINS)), np.stack([true] * CONF_TWINS))
    damaged = list(CONF_DAMAGED)
    out, tick = [], 0
    for phase, n_ticks in enumerate(CONF_TICKS):
        if phase:
            theta = -true if phase == 1 else true
            srv.deploy_many(damaged, np.stack([theta] * len(damaged)))
        for _ in range(n_ticks):
            lo = tick * CONF_PER_TICK
            srv.ingest_many([(tid, ys[tid, lo:lo + CONF_PER_TICK])
                             for tid in range(CONF_TWINS)])
            out.append(srv.tick())
            tick += 1
    srv.drain()
    return out


def fleet_conformance(paths, smi):
    """The conformance scenario on the port's TwinServer, ShardedTwinServer
    (2 shards) and FederatedTwinServer (2 workers), all on the card: the
    three guard-event streams identical ((tick, twin, kind) exactly, scores
    within 1e-6), the sharded and federated losses too."""
    from repro_torch.systems.lotka_volterra import LotkaVolterra
    from repro_torch.systems.simulate import simulate_batch
    from repro_torch.twin import (FederatedTwinConfig, FederatedTwinServer,
                                  ShardedTwinConfig, ShardedTwinServer,
                                  TwinServer)
    system = LotkaVolterra()
    ys = simulate_batch(system, torch.Generator().manual_seed(0), CONF_TWINS,
                        horizon=400, noise_std=0.002,
                        device="cpu").ys_noisy.numpy()
    true = np.asarray(system.true_theta(system.library()), np.float32)
    cfg = _conformance_cfg(system.spec.dt)
    runs = {}
    for impl in ("single", "sharded", "federated"):
        srv = (TwinServer(cfg) if impl == "single" else
               ShardedTwinServer(ShardedTwinConfig.uniform(cfg, 2))
               if impl == "sharded" else
               FederatedTwinServer(FederatedTwinConfig.uniform(cfg, 2)))
        try:
            before = (srv.worker_processes() if impl == "federated"
                      else None)
            runs[impl] = counted(paths, f"conformance_{impl}",
                                 lambda: _conformance_run(srv, ys, true),
                                 quiet=True)
            if impl == "federated":
                _worker_launches(paths, "conformance_federated_workers",
                                 before, srv.worker_processes())
            if impl != "single":
                _check_no_deaths(f"conformance {impl}", runs[impl])
        finally:
            srv.close()
    keyed = {k: sorted((e.tick, e.twin_id, e.kind, e.score)
                       for r in v for e in r.events)
             for k, v in runs.items()}
    ref = keyed["single"]
    if {e[1] for e in ref if e[2] == "ALERT"} != set(CONF_DAMAGED):
        raise RuntimeError(f"conformance: ALERTs {ref}, damaged "
                           f"{CONF_DAMAGED}")
    for impl in ("sharded", "federated"):
        got = keyed[impl]
        if [e[:3] for e in got] != [e[:3] for e in ref] or not np.allclose(
                [e[3] for e in got], [e[3] for e in ref], rtol=1e-6,
                atol=0.0):
            raise RuntimeError(f"conformance: {impl} events {got} != "
                               f"single {ref}")
    for a, b in zip(runs["sharded"], runs["federated"]):
        la = [r.loss for r in a.reports]
        lb = [r.loss for r in b.reports]
        if [x is None for x in la] != [x is None for x in lb] or \
                not np.allclose([x for x in la if x is not None],
                                [x for x in lb if x is not None],
                                rtol=1e-6, atol=0.0):
            raise RuntimeError(f"conformance tick {a.tick}: sharded losses "
                               f"{la}, federated {lb}")
    n_loss = sum(r.loss is not None for t in runs["sharded"]
                 for r in t.reports)
    print(f"  conformance: {len(ref)} guard events identical across the "
          f"single, sharded and federated servers ((tick, twin, kind) "
          f"exact, scores within 1e-6); sharded and federated losses equal "
          f"at {n_loss} shard-ticks [{smi}]")


# -- 2. the sharded fleet (examples/sharded_fleet.py) ------------------------ #
def _families():
    from repro_torch.systems.lotka_volterra import LotkaVolterra
    from repro_torch.systems.van_der_pol import VanDerPol
    nominal, _ = _systems()
    return [("f8", nominal, 24), ("vdp", VanDerPol(), 12),
            ("lv", LotkaVolterra(), 6)]


def _family_cfg(system, n_active, seed, async_ingest=True):
    """examples/sharded_fleet.py's `family_cfg`, uncut."""
    from repro_torch.core.merinda import MerindaConfig
    from repro_torch.twin.monitor import GuardConfig
    from repro_torch.twin.server import TwinServerConfig
    s = system.spec
    return TwinServerConfig(
        merinda=MerindaConfig(n=s.n, m=s.m, order=s.order, dt=s.dt,
                              hidden=16, head_hidden=16, n_active=n_active),
        max_twins=4096, refit_slots=8, capacity=64, window=16, stride=8,
        windows_per_twin=4, steps_per_tick=1, sparsify_after=30,
        deploy_after=8, min_residency=4, max_residency=16,
        guard=GuardConfig(window=24), guard_budget=96,
        async_ingest=async_ingest, seed=seed)


def _fleet_telemetry(dev):
    """One simulated batch of FLEET_PER_FAMILY a family; the first
    FLEET_DAMAGED F-8s fly DamagedF8 dynamics."""
    from repro_torch.systems.simulate import simulate_batch
    _, damaged = _systems()
    horizon = CHUNK * FLEET_TICKS + 1
    out = []
    for i, (_, system, _) in enumerate(_families()):
        tr = simulate_batch(system, torch.Generator().manual_seed(i),
                            FLEET_PER_FAMILY, horizon=horizon,
                            noise_std=0.002, device=dev)
        out.append([tr.ys_noisy.cpu().numpy(), tr.us.cpu().numpy()])
    tr = simulate_batch(damaged, torch.Generator().manual_seed(100),
                        FLEET_DAMAGED, horizon=horizon, noise_std=0.002,
                        device=dev)
    out[0][0][:FLEET_DAMAGED] = tr.ys_noisy.cpu().numpy()
    out[0][1][:FLEET_DAMAGED] = tr.us.cpu().numpy()
    for ys, us in out:
        if not (np.isfinite(ys).all() and np.isfinite(us).all()):
            raise RuntimeError("fleet telemetry is not finite")
    return out


def _fleet_server(device, async_ingest=True):
    """examples/sharded_fleet.py's server: one shard a family, a global
    budget of 12 slots, every twin warm-started with its family's true
    theta."""
    from repro_torch.twin import ShardedTwinConfig, ShardedTwinServer
    fams = _families()
    srv = ShardedTwinServer(ShardedTwinConfig(
        servers=tuple(_family_cfg(system, n_active, i, async_ingest)
                      for i, (_, system, n_active) in enumerate(fams)),
        total_slots=12, min_shard_slots=1, rebalance_every=4,
        pressure_smooth=0.5), device=device)
    nf = FLEET_PER_FAMILY
    for i, (_, system, _) in enumerate(fams):
        ids = [i * nf + k for k in range(nf)]
        for tid in ids:
            srv.register(tid, shard=i)
        srv.deploy_many(ids, system.true_theta(srv.shards[i].fleet.model.lib))
    return srv


def _fleet_tick(srv, telemetry, t):
    lo, nf = t * CHUNK, FLEET_PER_FAMILY
    for i, (ys, us) in enumerate(telemetry):
        srv.ingest_many([(i * nf + k, ys[k, lo:lo + CHUNK],
                          us[k, lo:lo + CHUNK]) for k in range(nf)])
    return srv.tick()


def fleet_sharded(dev, paths, smi):
    """examples/sharded_fleet.py at its default width, uncut, on the card:
    the flagged set must hold every damaged F-8.  Then its first
    FLEET_PARITY_TICKS ticks again with synchronous ingest on the card and
    on the CPU: grants and admissions equal tick by tick, losses within
    rtol 1e-3 / atol 1e-4."""
    telemetry = _fleet_telemetry(dev)

    def run():
        srv = _fleet_server(None)
        reports = []
        try:
            for t in range(FLEET_TICKS):
                reports.append(_fleet_tick(srv, telemetry, t))
                if reports[-1].tick == FLEET_WARMUP:
                    srv.reset_latency_stats()
            srv.drain()
        finally:
            srv.close()
        return srv, reports

    srv, reports = counted(paths, "fleet_sharded", run, quiet=True)
    _check_no_deaths("sharded fleet", reports)
    path = [(r.tick, r.grants) for k, r in enumerate(reports)
            if k == 0 or r.grants != reports[k - 1].grants]
    print(f"  sharded fleet: grants (f8/vdp/lv) by tick {path}; final "
          f"pressures {[round(p, 2) for p in srv.federation.pressures]}")
    flagged = {e.twin_id for r in reports for e in r.events}
    caught = sorted(flagged & set(range(FLEET_DAMAGED)))
    print(f"  sharded fleet: flagged {len(flagged)} twins, {len(caught)}/"
          f"{FLEET_DAMAGED} true damaged among them")
    if len(caught) != FLEET_DAMAGED:
        raise RuntimeError(f"sharded fleet: damaged F-8s flagged {caught}")
    losses = [r.loss for t in reports for r in t.reports
              if r.loss is not None]
    if not losses or not np.all(np.isfinite(losses)):
        raise RuntimeError(f"sharded fleet: refit losses {losses[:8]}")
    pred = srv.predict(0, 50)
    if pred.shape != (51, 3) or not torch.isfinite(pred).all():
        raise RuntimeError(f"sharded fleet: prediction {tuple(pred.shape)}")
    lat, _ = _fleet_summary(f"sharded fleet, {3 * FLEET_PER_FAMILY} twins "
                            f"on 3 shards, ticks {FLEET_WARMUP + 1}-"
                            f"{FLEET_TICKS}", srv, paths, "fleet_sharded",
                            smi)

    def parity(device):
        s = _fleet_server(device, async_ingest=False)
        try:
            return [_fleet_tick(s, telemetry, t)
                    for t in range(FLEET_PARITY_TICKS)]
        finally:
            s.close()

    card = counted(paths, "fleet_parity", lambda: parity(None), quiet=True)
    cpu = parity("cpu")
    n_loss = 0
    for a, b in zip(card, cpu):
        if a.grants != b.grants:
            raise RuntimeError(f"fleet parity tick {a.tick}: grants card "
                               f"{a.grants}, CPU {b.grants}")
        for ra, rb in zip(a.reports, b.reports):
            if (ra.admitted, ra.evicted, ra.released) != \
                    (rb.admitted, rb.evicted, rb.released):
                raise RuntimeError(f"fleet parity tick {a.tick}: plans "
                                   f"differ")
            if (ra.loss is None) != (rb.loss is None) or (
                    ra.loss is not None and not np.isclose(
                        ra.loss, rb.loss, rtol=1e-3, atol=1e-4)):
                raise RuntimeError(f"fleet parity tick {a.tick}: loss card "
                                   f"{ra.loss}, CPU {rb.loss}")
            n_loss += ra.loss is not None
    print(f"  fleet parity: {FLEET_PARITY_TICKS} ticks card against CPU, "
          f"grants {card[-1].grants} and plans equal, {n_loss} shard losses "
          f"within rtol 1e-3 / atol 1e-4")
    return lat


# -- 3. scale (benchmarks/online_scale.py) ----------------------------------- #
def _scale_cfg(system, n_twins, shards, async_ingest=True):
    """benchmarks/online_scale.py's per-shard config (and, with sync
    ingest, online_federated.py's `_shard_cfg`)."""
    from repro_torch.core.merinda import MerindaConfig
    from repro_torch.twin.monitor import GuardConfig
    from repro_torch.twin.server import TwinServerConfig
    per_shard = -(-n_twins // shards)
    s = system.spec
    return TwinServerConfig(
        merinda=MerindaConfig(n=s.n, m=s.m, order=3, dt=s.dt, hidden=16,
                              head_hidden=16, n_active=24),
        max_twins=per_shard, refit_slots=8, capacity=64, window=16,
        stride=8, windows_per_twin=4, steps_per_tick=1, deploy_after=8,
        min_residency=4, max_residency=16, guard=GuardConfig(window=24),
        guard_budget=min(SCALE_GUARD_BUDGET, per_shard),
        async_ingest=async_ingest, seed=0)


def _f8_fleet(dev, n_twins, ticks):
    """The benchmarks' telemetry, plain F8Crusader from seed 0, with every
    trace that diverged (open-loop F-8 leaves controlled flight from some
    initial states: about 1 in 200 over these ticks) drawn again from seed
    1000, 2000, ..., as benchmarks/table1_accuracy.py resamples."""
    from repro_torch.systems.f8_crusader import F8Crusader
    from repro_torch.systems.simulate import simulate_batch
    system = F8Crusader()
    horizon = CHUNK * ticks + 1
    tr = simulate_batch(system, torch.Generator().manual_seed(0), n_twins,
                        horizon=horizon, noise_std=0.002, device=dev)
    ys, us = tr.ys_noisy.cpu().numpy(), tr.us.cpu().numpy()
    for attempt in range(1, 11):
        bad = np.flatnonzero(~np.isfinite(ys).all(axis=(1, 2)))
        if not len(bad):
            return system, ys, us
        tr = simulate_batch(system, torch.Generator().manual_seed(
            1000 * attempt), len(bad), horizon=horizon, noise_std=0.002,
            device=dev)
        ys[bad], us[bad] = tr.ys_noisy.cpu().numpy(), tr.us.cpu().numpy()
    raise RuntimeError("F-8 fleet telemetry: traces still diverge")


def _drive(srv, ys, us, n_twins, ticks, warmup, sink=None,
           on_tick=None):
    """The benchmarks' loop: every twin's CHUNK a tick (through `sink`, a
    front-door client, when given), drained during warm-up, stats reset
    after it."""
    sink = srv if sink is None else sink
    reports = []
    for t in range(ticks):
        lo = t * CHUNK
        sink.ingest_many([(i, ys[i, lo:lo + CHUNK], us[i, lo:lo + CHUNK])
                          for i in range(n_twins)])
        if t < warmup:
            srv.drain()
        reports.append(srv.tick())
        if on_tick is not None:
            on_tick(t, reports[-1])
        if t == warmup - 1:
            srv.reset_latency_stats()
    srv.drain()
    return reports


def fleet_scale(dev, paths, smi) -> dict:
    """benchmarks/online_scale.py's quick headline points: 1,000 and 10,000
    F-8 twins on 4 in-process shards, SCALE_WARMUP + SCALE_TICKS ticks.
    Returns each point's latency summary."""
    from repro_torch.twin import ShardedTwinConfig, ShardedTwinServer
    ticks = SCALE_WARMUP + SCALE_TICKS
    out = {}
    for n_twins in SCALE_TWINS:
        system, ys, us = _f8_fleet(dev, n_twins, ticks)
        path = f"scale_{n_twins // 1000}k"

        def run():
            srv = ShardedTwinServer(ShardedTwinConfig.uniform(
                _scale_cfg(system, n_twins, SCALE_SHARDS), SCALE_SHARDS,
                rebalance_every=4))
            try:
                srv.deploy_many(list(range(n_twins)), system.true_theta(
                    srv.shards[0].fleet.model.lib))
                reports = _drive(srv, ys, us, n_twins, ticks, SCALE_WARMUP)
            finally:
                srv.close()
            return srv, reports

        srv, reports = counted(paths, path, run, quiet=True)
        _check_no_deaths(path, reports)
        if reports[-1].n_twins != n_twins:
            raise RuntimeError(f"{path}: {reports[-1].n_twins} twins")
        lat, st = _fleet_summary(f"scale {n_twins} twins / {SCALE_SHARDS} "
                                 "shards", srv, paths, path, smi)
        if lat["dropped_samples"]:
            raise RuntimeError(f"{path}: {lat['dropped_samples']} dropped")
        out[n_twins] = dict(lat, **st)
    lo, hi = (out[n] for n in SCALE_TWINS)
    print(f"  scale: guard {lo['guard_ms']:.3f} -> {hi['guard_ms']:.3f} ms a "
          f"tick from {SCALE_TWINS[0]} to {SCALE_TWINS[1]} twins "
          f"({hi['guard_ms'] / max(lo['guard_ms'], 1e-9):.2f}x; the JAX "
          f"benchmark's contract is at most 2x, not gated here) [{smi}]")
    return out


# -- 4. federation (benchmarks/online_federated.py) -------------------------- #
def fleet_federated(dev, paths, smi, inproc: dict):
    """online_federated.py's quick preset on the one card: 10,000 twins in
    4 worker processes; 1,000 in 2 with every sample through the TCP front
    door; the kill row (1,000 twins, 4 workers, the last one killed a third
    into the measured ticks, restarted after 1 tick from its checkpoint and
    the journal)."""
    import os
    import shutil
    from repro_torch.twin import (ChaosConfig, FederatedTwinConfig,
                                  FederatedTwinServer, FrontDoorClient,
                                  RecoveryConfig)
    ticks = SCALE_WARMUP + SCALE_TICKS

    def serve(path, n_twins, workers, tcp=False):
        system, ys, us = _f8_fleet(dev, n_twins, ticks)
        scfg = _scale_cfg(system, n_twins, workers, async_ingest=False)
        srv = FederatedTwinServer(FederatedTwinConfig.uniform(
            scfg, workers, rebalance_every=4, front_door=tcp))
        door = FrontDoorClient(srv.front_address) if tcp else None
        seen = {}
        try:
            before = srv.worker_processes()
            srv.deploy_many(list(range(n_twins)),
                            system.true_theta(scfg.merinda.library))

            def probe(t, rep):
                if t == SCALE_WARMUP:
                    seen["procs"] = _workers_on_card(srv, path)

            reports = counted(paths, path, lambda: _drive(
                srv, ys, us, n_twins, ticks, SCALE_WARMUP, sink=door,
                on_tick=probe), quiet=True)
            _worker_launches(paths, f"{path}_workers", before,
                             srv.worker_processes())
            _check_no_deaths(path, reports)
            if reports[-1].n_twins != n_twins:
                raise RuntimeError(f"{path}: {reports[-1].n_twins} twins")
            lat, _ = _fleet_summary(
                f"federated {n_twins} twins / {workers} workers"
                f"{' through the TCP front door' if tcp else ''}", srv,
                paths, path, smi, workers=f"{path}_workers")
            print(f"  {path}: {_boot_line(srv)}")
            return lat
        finally:
            if door is not None:
                door.close()
            srv.close()

    lat = serve("federated_10k", FED_TWINS, FED_WORKERS)
    base = inproc[FED_TWINS]["twin_refreshes_per_s"]
    cores = os.cpu_count() or 1
    note = ("" if cores >= FED_WORKERS + 1 else
            f"; HOST-LIMITED: {cores} cores < {FED_WORKERS + 1}")
    print(f"  federation: {FED_TWINS} twins, {FED_WORKERS} workers "
          f"{lat['twin_refreshes_per_s']:.1f} refreshes/s against "
          f"{base:.1f} in one process (step 3, async ingest): "
          f"{lat['twin_refreshes_per_s'] / max(base, 1e-9):.2f}x, "
          f"{cores} host cores{note} [{smi}]")
    serve("federated_tcp", *FED_TCP, tcp=True)

    # the kill row
    n_twins, workers, measured = KILL_TWINS, KILL_WORKERS, KILL_TICKS
    system, ys, us = _f8_fleet(dev, n_twins, SCALE_WARMUP + measured)
    scfg = dataclasses.replace(_scale_cfg(system, n_twins, workers,
                                          async_ingest=False),
                               deadline_s=5.0)
    victim = workers - 1
    kill_tick = SCALE_WARMUP + max(2, measured // 3)
    total_slots = max(workers, workers * scfg.refit_slots // 2)
    shutil.rmtree(FLEET_CKPT_DIR, ignore_errors=True)
    srv = FederatedTwinServer(FederatedTwinConfig.uniform(
        scfg, workers, rebalance_every=4, total_slots=total_slots,
        recovery=RecoveryConfig(ckpt_dir=str(FLEET_CKPT_DIR), ckpt_every=4,
                                restart_delay_ticks=1),
        chaos=ChaosConfig(kill_shard=victim, kill_at_tick=kill_tick)))
    ema = []
    try:
        before = srv.worker_processes()
        srv.deploy_many(list(range(n_twins)),
                        system.true_theta(scfg.merinda.library))
        reports = counted(paths, "federated_kill", lambda: _drive(
            srv, ys, us, n_twins, SCALE_WARMUP + measured, SCALE_WARMUP,
            on_tick=lambda t, r: ema.append(srv.federation.pressures[
                victim])), quiet=True)
        # the restarted worker's counters start from 0: count its own
        after = srv.worker_processes()
        after[victim] = dict(after[victim], **{
            f"{k}_launches": after[victim][f"{k}_launches"]
            + before[victim][f"{k}_launches"]
            for k in ("gru_scan", "rk4_poly")})
        _worker_launches(paths, "federated_kill_workers", before, after)
        down = [k for k, r in enumerate(reports) if r.dead_shards]
        restarted = [x for r in reports for x in r.restarted]
        if [x["shard"] for x in restarted] != [victim] or not down:
            raise RuntimeError(f"kill row: restarts {restarted}, down at "
                               f"{down}")
        back = next(k for k, r in enumerate(reports) if r.restarted)
        _check_no_deaths("kill row", reports, allowed=set(down) | {back})
        rec = restarted[0]
        if rec["lost"] != 0:
            raise RuntimeError(f"kill row: {rec['lost']} samples lost")
        pre = reports[down[0] - 1].grants
        migrated = [reports[k].grants for k in down
                    if reports[k].grants[victim] == 0
                    and sum(reports[k].grants) == total_slots
                    and any(g > p for i, (g, p) in enumerate(
                        zip(reports[k].grants, pre)) if i != victim)]
        if len(migrated) != len(down):
            raise RuntimeError(f"kill row: grants while down "
                               f"{[reports[k].grants for k in down]}, before "
                               f"{pre}")
        held = {ema[k] for k in down} | {ema[down[0] - 1]}
        if len(held) != 1:
            raise RuntimeError(f"kill row: the victim's pressure EMA moved "
                               f"while it was down: {sorted(held)}")
        lat, _ = _fleet_summary(
            f"kill row {n_twins} twins / {workers} workers", srv, paths,
            "federated_kill", smi, workers="federated_kill_workers")
        print(f"  kill row: worker {victim} killed at tick "
              f"{reports[down[0]].tick}, down {rec['down_ticks']} tick(s), "
              f"restored from its tick-{rec['ckpt_tick']} checkpoint, "
              f"{rec['replayed']} samples replayed, {rec['lost']} lost; "
              f"grants before {pre}, while down {migrated}, after "
              f"{reports[back].grants}; its pressure EMA held at "
              f"{held.pop():.3f}; {_boot_line(srv)} [{smi}]")
    finally:
        srv.close()
        shutil.rmtree(FLEET_CKPT_DIR, ignore_errors=True)


def fleet(dev, paths, smi):
    def step(what, fn):
        print(f"-- {what}")
        t0 = time.perf_counter()
        out = fn()
        print(f"   ({time.perf_counter() - t0:.1f} s)")
        return out

    step("conformance: one scenario, three servers",
         lambda: fleet_conformance(paths, smi))
    step(f"sharded: examples/sharded_fleet.py, {3 * FLEET_PER_FAMILY} twins",
         lambda: fleet_sharded(dev, paths, smi))
    scale = step(f"scale: {SCALE_TWINS} F-8 twins on {SCALE_SHARDS} shards",
                 lambda: fleet_scale(dev, paths, smi))
    step("federated: worker processes on the card",
         lambda: fleet_federated(dev, paths, smi, scale))


# --------------------------------------------------------------------------- #
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    t_script = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    from repro_torch.kernels import backend

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    print("== 1. build")
    t0 = time.perf_counter()
    lib_path = backend.build_library(verbose=True)
    backend.load_library()
    print(f"built {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    from repro_torch.launch.mesh import HW
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"device memory: {total} bytes ({total / 2**30:.2f} GiB) by "
          f"torch.cuda.get_device_properties(0).total_memory; the planner's "
          f"HW.HBM_BYTES {HW.HBM_BYTES} ({HW.HBM_BYTES / 2**30:.2f} GiB)")

    print("== 2. kernels against their plain versions")
    worst = check_kernels(dev)

    print("== 3. serving: 64 F-8 twins on the card")
    ys, us = telemetry(dev)
    paths = {}
    srv, reports = counted(paths, "tick", lambda: serve(None, ys, us, TICKS))
    check_ticks(srv, reports)
    preds = counted(paths, "predict", lambda: [
        srv.predict(tid, 50) for tid in (0, DAMAGED, TWINS - 1)])
    what_if = (0.03 * np.random.default_rng(5).normal(size=(8, 50, 1))
               ).astype(np.float32)
    scn = counted(paths, "scenario", lambda: srv.scenario(0, 50, what_if))
    check_answers(srv, preds, scn, ys)
    lat, stages = srv.latency_summary(), srv.stage_summary()
    print(f"steady-state ticks {lat['ticks']}: p50 {lat['p50_ms']:.2f} ms, "
          f"p99 {lat['p99_ms']:.2f} ms, max {lat['max_ms']:.2f} ms, "
          f"violations {lat['violations']}")
    print("per-stage mean ms: " + ", ".join(
        f"{k} {v:.2f}" for k, v in stages.items()))
    profile_ticks(srv, ys, us)

    print(f"== 4. card against CPU, first {PARITY_TICKS} ticks")
    _, cpu_reports = serve("cpu", ys, us, PARITY_TICKS)
    check_parity(reports, cpu_reports)

    print("== 4b. crash safety at the serving width")
    t0 = time.perf_counter()
    crash_safety(ys, us, reports, paths, smi)
    print(f"crash-safety phase: {time.perf_counter() - t0:.1f} s")

    print("== 5. LM serving: rwkv6-3b at full width on the card")
    serve_lm(paths)

    print(f"== 6. LM card against CPU: {LM_PARITY_LAYERS} layers, f32")
    lm_parity(dev)

    print("== 7. offline model recovery on the card")
    t0 = time.perf_counter()
    offline(dev, paths)
    print(f"offline phase: {time.perf_counter() - t0:.1f} s")

    print("== 9. the fleet: sharded and federated serving on the card")
    t0 = time.perf_counter()
    fleet(dev, paths, smi)
    print(f"fleet phase: {time.perf_counter() - t0:.1f} s")

    print("== 10. the LM zoo: zamba2-7b and qwen3-8b served at full size, "
          "six architectures card against CPU")
    t0 = time.perf_counter()
    lm_zoo(dev, paths, worst)
    print(f"LM zoo phase: {time.perf_counter() - t0:.1f} s")

    print("== 11. the MoE LMs and the encoder-decoder: mixtral-8x22b, "
          "arctic-480b and whisper-large-v3 served at full width, card "
          "against CPU")
    t0 = time.perf_counter()
    moe_encdec(dev, paths)
    print(f"MoE and encoder-decoder phase: {time.perf_counter() - t0:.1f} s")

    print("== 12. LM training: the scan's gradient, rwkv6-3b whole through "
          "launch/train.py, kill and resume, card against CPU")
    t0 = time.perf_counter()
    lm_train(dev, paths, worst)
    print(f"LM training phase: {time.perf_counter() - t0:.1f} s")

    print("== 8. kernel times at the serving and offline shapes")
    t0 = time.perf_counter()
    lines = kernel_lines(dev, paths, worst)
    print(f"kernel timing phase: {time.perf_counter() - t0:.1f} s; the "
          f"script so far: {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": lines}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
