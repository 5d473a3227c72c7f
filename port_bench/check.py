"""What decides `correct`: the program's timed path, observed on ticks and
queries of the run's loop once the window has closed, held to the plain
reference (reference.py).

`Recorder` wraps four public methods of the modules every shard of the
server shares -- the refit model step (`fleet.train_step_per_slot`), the
promote's candidate extraction (`fleet.recover_all`), the guard's rollout
score (`guard.score`, the guard stage and the promote's shadow-evaluation)
and the ring read that feeds the guard (`ring.latest`) -- and each shard's
`tick`, to know whose calls they are.  On a recorded tick it keeps a copy
of every argument and result on the device, and the parts of the server's
`snapshot_state()` the tick reads and writes, before and after the tick.
The recorded ticks follow one another, a number drawn from the seed after
the window (and the traced segment), so that nothing the check does runs
inside the window.

`evaluate` runs once the servers are freed.  The reference follows the
program step by step: it starts each observed call from the program's own
state (parameters, optimizer moments, the theta store), because whether a
twin is admitted, flagged or promoted turns on differences at rounding
level, so a replay of many ticks from the seed alone would part from the
program.  The links between the calls are checked apart, byte for byte:
each refit step starts from the last one's output, and a tick's first from
what the tick before left, but for the slots admitted since
(`chain_mismatch`).  Everything else is worked out again from the
benchmark's own telemetry: every window and ring read is compared byte for
byte with the samples the benchmark fed.  The stages that following skips
are checked on their own: the theta store after deploy against the F-8
coefficients, each admitted slot's reset (zero moments, fresh norm
statistics), the thetas the guard scores against the store, the promoted
rows against the candidates, a queried twin's served models against those
the benchmark deployed, and every ring at the end against the telemetry.
The numbers a limits file lists under `every_checked_tick` and
`every_checked_query` have to be read on each (`unread`): a refit or guard
routed past the observed entries reads nothing and is not correct.

A federated server's shards are worker processes, which inherit no
wrapper from this one: each worker runs a `Recorder` of its own on its
`TwinServer` (workers.py installs it through the worker entry), records
every tick from the barrier the parent sends before the check's ticks,
and writes the records to a file once those ticks are over; `merged`
lays the workers' records out as one recorder over every shard keeps
them, so `evaluate` and the reference run unchanged.  `check_deploy` and `check_ring` read a worker's state through
`snapshot_state()` on the wire.

With `control=True` the reference itself, in TF32, stands in the
program's place: the readings then say how far the nearest lower
precision lands from float32.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench import reference as ref

KINDS = {0: "OK", 1: "REFIT", 2: "ALERT"}
# a slot whose reference loss exceeds this has a decoded trajectory that
# left the data by orders of magnitude (sound losses are 1e-3 to 1); its
# gradient and step are moved by rounding alone and are not compared
DIVERGED_LOSS = 1e3
# a sparsify mask is judged clear where its k-th largest coefficient
# magnitude exceeds the next by more than this, relative to it
MASK_BAND = 1e-4


def clone_tree(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if hasattr(x, "_asdict"):
        return {k: clone_tree(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [clone_tree(v) for v in x]
    return x


def _state_view(server) -> dict:
    """The parts of a shard's `snapshot_state()` the check reads."""
    s = server.snapshot_state()
    p, rows = s["packed"], s["rows"]
    return {"theta": s["theta"].detach().clone(),
            "hist_count": np.asarray(s["hist_count"]).copy(),
            "div": np.asarray(p["divergence"]).copy(),
            "deployed": np.asarray(p["deployed"]).copy(),
            "twin_id": np.asarray(p["twin_id"]).copy(),
            "guard_code": np.asarray(rows["guard_code"]).copy(),
            "guard_live": np.asarray(rows["guard_live"]).copy(),
            "steps_in_slot": np.asarray(rows["steps_in_slot"]).copy(),
            "slot_twin": np.asarray(s["slot_twin_ids"]).copy()}


class Recorder:
    def __init__(self, shards: list):
        self.shards = shards
        self.active = False
        self.shard = 0
        self.calls: list = []
        self.records: list = []
        self.recovers = 0          # promote passes, for the tick's work
        first = shards[0]
        for s in shards[1:]:
            if (s.fleet is not first.fleet or s.guard is not first.guard
                    or s.ring is not first.ring):
                raise RuntimeError("the check expects shards that share "
                                   "their fleet, guard and ring modules")
        self._wrap(first.fleet, "train_step_per_slot", self._train)
        self._wrap(first.fleet, "recover_all", self._recover)
        self._wrap(first.guard, "score", self._score)
        self._wrap(first.ring, "latest", self._latest)
        for i, s in enumerate(shards):
            self._wrap(s, "tick", self._tick_of(i))

    @staticmethod
    def _wrap(obj, name, make):
        setattr(obj, name, make(getattr(obj, name)))

    def _tick_of(self, i):
        def make(fn):
            def tick(*a, **k):
                self.shard = i
                return fn(*a, **k)
            return tick
        return make

    def _keep(self, kind, **payload):
        self.calls.append((self.shard, kind, payload))

    def _train(self, fn):
        def train_step_per_slot(state, y_win, u_win):
            if self.active:
                keep = clone_tree((state, y_win, u_win))
            out = fn(state, y_win, u_win)
            if self.active:
                self._keep("train", state=keep[0], y=keep[1], u=keep[2],
                           out=clone_tree(out[0]), loss=out[1].clone())
            return out
        return train_step_per_slot

    def _recover(self, fn):
        def recover_all(state, y_win, u_win):
            self.recovers += 1
            out = fn(state, y_win, u_win)
            if self.active:
                self._keep("recover", params=clone_tree(state["params"]),
                           y=y_win.clone(), u=u_win.clone(), out=out.clone())
            return out
        return recover_all

    def _score(self, fn):
        def score(theta, ys, us):
            if self.active:
                keep = clone_tree((theta, ys, us))
            out = fn(theta, ys, us)
            if self.active:
                self._keep("score", theta=keep[0], ys=keep[1], us=keep[2],
                           out=out.clone())
            return out
        return score

    def _latest(self, fn):
        def latest(state, slots, length):
            if self.active:
                self._keep("latest", rows=slots.clone(), length=length)
            return fn(state, slots, length)
        return latest

    # ------------------------------------------------------------------ #
    def begin(self):
        self.calls = []
        self._pre = [_state_view(s) for s in self.shards]
        self.active = True

    def end(self, tick: int, reports: list):
        self.active = False
        self.records.append({
            "tick": tick, "pre": self._pre,
            "post": [_state_view(s) for s in self.shards],
            "calls": self.calls,
            "events": [[(e.twin_id, e.kind) for e in r.events]
                       for r in reports]})
        self.calls = []


def merged(per_shard: list) -> list:
    """The records of recorders that each watched one shard (shard i's at
    i, each shard its own index 0) as one recorder over every shard keeps
    them: the ticks every shard recorded, each call under its shard."""
    ticks = set.intersection(*({r["tick"] for r in recs}
                               for recs in per_shard))
    out = []
    for t in sorted(ticks):
        recs = [next(r for r in recs if r["tick"] == t) for recs in per_shard]
        out.append({"tick": t,
                    "pre": [r["pre"][0] for r in recs],
                    "post": [r["post"][0] for r in recs],
                    "calls": [(i, kind, c) for i, r in enumerate(recs)
                              for _, kind, c in r["calls"]],
                    "events": [r["events"][0] for r in recs]})
    return out


def query_state(server, row: int) -> dict:
    """What a what-if query of ring row `row` reads: its served models."""
    s = server.snapshot_state()
    return {"theta_hist": s["theta_hist"][row].detach().clone(),
            "count": int(np.asarray(s["hist_count"])[row]),
            "theta": s["theta"][row].detach().clone()}


# -------------------------------------------------------------------------- #
class Telemetry:
    """The samples the benchmark fed, as the reference reads them."""

    def __init__(self, ys: np.ndarray, us: np.ndarray, cfg: dict,
                 traffic: dict, device):
        self.ys, self.us, self.cfg = ys, us, cfg
        self.history, self.chunk = traffic["history"], traffic["chunk"]
        self.device = device

    def fed(self, tick: int) -> int:
        """Samples each twin has streamed once tick `tick` (from 0) has
        ingested."""
        return self.history + (tick + 1) * self.chunk

    def latest(self, twin: int, fed: int, length: int):
        """The newest length+1 samples: (ys [length+1, n], us [length, m])."""
        lo = fed - length - 1
        return (torch.as_tensor(self.ys[twin, lo:fed], device=self.device),
                torch.as_tensor(self.us[twin, lo:fed - 1],
                                device=self.device))

    def windows(self, twin: int, fed: int):
        s = self.cfg["server"]
        span = s["stride"] * (s["windows_per_twin"] - 1) + s["window"]
        ys, us = self.latest(twin, fed, span)
        k, st = s["window"], s["stride"]
        y = torch.stack([ys[i:i + k + 1] for i in range(0, span - k + 1, st)])
        u = torch.stack([us[i:i + k] for i in range(0, span - k + 1, st)])
        return y, u


class Readings:
    """The worst reading of each compared number, and the names read since
    `seen` was last emptied."""

    def __init__(self):
        self.v: dict[str, float] = {}
        self.seen: set = set()

    def add(self, name: str, value: float):
        self.v[name] = max(self.v.get(name, 0.0), float(value))
        self.seen.add(name)


def trees_equal(a, b) -> bool:
    """Two cloned trees hold the same tensors byte for byte."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(trees_equal(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(trees_equal(x, y) for x, y in zip(a, b)))
    return a == b


def _per_slot_leaves(st: dict) -> list:
    return [leaf for tree in (st["params"], st["opt"]["mu"], st["opt"]["nu"])
            for leaves in tree.values() for leaf in leaves.values()]


def carried_over(prev: dict, st: dict) -> bool:
    """The state a tick's first refit step starts from carries the previous
    tick's last output over: every slot not admitted since (steps != 0)
    holds its parameters, moments and step count unchanged, and the shared
    step counters are the same."""
    keep = st["steps"] != 0
    if not torch.equal(prev["steps"][keep], st["steps"][keep]):
        return False
    if not (torch.equal(prev["step"], st["step"])
            and torch.equal(prev["opt"]["step"], st["opt"]["step"])):
        return False
    return all(torch.equal(a[keep], b[keep]) for a, b in
               zip(_per_slot_leaves(prev), _per_slot_leaves(st)))


def _leaf_keys(params: dict) -> list:
    return [(g, k) for g in params for k in params[g]]


def _grad_from_moments(mu_out, mu_in):
    """The gradient the optimizer took, worked out from its first moment."""
    return (mu_out - ref.Refit.B1 * mu_in) / (1 - ref.Refit.B1)


def _refit(rd: Readings, model: ref.Refit, call: dict, slots: list,
           sparsify_after: int, control: bool, pool: list):
    """Each slot-step of one refit call held to the reference: its gaps
    join the shard's `pool`, which `_pooled` reads once every checked tick
    is in."""
    st = call["state"]
    params, opt = st["params"], st["opt"]
    keys = _leaf_keys(params)
    state = {"params": params, "opt_step": opt["step"], "steps": st["steps"],
             "mu": {gk: opt["mu"][gk[0]][gk[1]] for gk in keys},
             "nu": {gk: opt["nu"][gk[0]][gk[1]] for gk in keys}}
    loss_r, grad_r, p_r, _, _ = model.step(state, call["y"], call["u"],
                                           sparsify_after)
    if control:
        model.tf32 = True
        loss_g, grad_g, p_g, _, _ = model.step(state, call["y"], call["u"],
                                               sparsify_after)
        model.tf32 = False
    else:
        out = call["out"]
        loss_g = call["loss"]
        grad_g = {gk: _grad_from_moments(out["opt"]["mu"][gk[0]][gk[1]],
                                         state["mu"][gk]) for gk in keys}
        p_g = {gk: out["params"][gk[0]][gk[1]] for gk in keys}
    # a coefficient at the sparsify mask's threshold may fall on either
    # side, and the gradient of the slot with it: such slots are judged by
    # their loss alone
    clear = model.mask_margin(params, call["y"], call["u"],
                              st["steps"] > sparsify_after) > MASK_BAND
    for f in slots:
        loss = float(loss_r[f])
        # live: a step the reference takes (it zeroes the loss of one it
        # skips, its loss or gradient not finite) on a rollout within the
        # data's envelope
        entry = {"live": 0.0 < loss <= DIVERGED_LOSS,
                 "loss": ref.relative_gap(loss_g[f], loss_r[f])}
        rd.seen.add("refit_loss_rel")
        if loss <= DIVERGED_LOSS and bool(clear[f]):
            # the slot's worst leaf
            gnorm = {gk: float(grad_r[gk][f].double().norm()) for gk in keys}
            med = float(np.median(list(gnorm.values())))
            moved = [gk for gk in keys if gnorm[gk] >= 1e-3 * med]
            dnorm = {gk: float((p_r[gk][f] - params[gk[0]][gk[1]][f])
                               .double().norm()) for gk in moved}
            dmed = float(np.median(list(dnorm.values())))
            p0 = {gk: params[gk[0]][gk[1]][f] for gk in moved}
            entry["grad"] = max(ref.norm_gap(grad_g[gk][f], grad_r[gk][f],
                                             med) for gk in moved)
            entry["step"] = max(ref.norm_gap(p_g[gk][f] - p0[gk],
                                             p_r[gk][f] - p0[gk], dmed)
                                for gk in moved)
            rd.seen.update(("refit_grad_rel", "refit_step_rel"))
        pool.append(entry)


def _pooled(rd: Readings, pool: list) -> None:
    """A shard's refit numbers: the median over its live slot-steps of
    every checked tick (over all of them where none is live), since a
    skipped step compares zeroes on both sides, a diverged rollout has a
    loss that rounding moves by any amount, and a kink met at rounding
    level (a ReLU at zero, the mask) moves one slot-step's gradient by any
    amount."""
    judged = [e for e in pool if e["live"]] or pool
    if judged:
        rd.add("refit_loss_rel", float(np.median([e["loss"]
                                                  for e in judged])))
    graded = [e for e in judged if "grad" in e]
    if graded:
        rd.add("refit_grad_rel", float(np.median([e["grad"]
                                                  for e in graded])))
        rd.add("refit_step_rel", float(np.median([e["step"]
                                                  for e in graded])))


SCORE_FLOOR = 1e-9     # guard scores are relative gaps down to this


def evaluate(recorder: Recorder, queries: list, tele: Telemetry, cfg: dict,
             device, control: bool = False) -> tuple[dict, int]:
    """(worst reading of each compared number, count of exact-comparison
    failures) over every observed tick and query."""
    rd = Readings()
    exact = 0
    mer = dict(cfg["merinda"], lr=cfg["server"]["lr"])
    model = ref.Refit(mer, device)
    terms = model.terms
    g, s = cfg["guard"], cfg["server"]
    dt, gw = mer["dt"], g["window"]
    band = 1e-3        # decisions are judged where the reference is clear
    nS = cfg["shards"]
    last_out: dict = {}            # shard -> the previous tick's last output
    pools: dict = {}               # shard -> its refit slot-steps' gaps
    prev_tick = None
    for rec in recorder.records:
        rd.seen = set()
        fed = tele.fed(rec["tick"])
        follows = prev_tick is not None and rec["tick"] == prev_tick + 1
        for sh in range(nS):
            pre, post = rec["pre"][sh], rec["post"][sh]
            calls = [(k, c) for i, k, c in rec["calls"] if i == sh]
            max_twins = s["max_twins"]
            slot_twin = post["slot_twin"]
            slots = [f for f in range(len(slot_twin)) if slot_twin[f] >= 0]
            twin_row = {int(pre["twin_id"][r]): r for r in range(max_twins)}
            rows_now = None
            promote_thetas = None
            shadow = []
            trains = [c for k, c in calls if k == "train"]
            # the refit runs steps_per_tick steps whenever a slot is
            # assigned, each from the last one's output, the first from
            # what the previous tick left
            want_calls = s["steps_per_tick"] if slots else 0
            rd.add("chain_mismatch", int(len(trains) != want_calls))
            for a, b in zip(trains, trains[1:]):
                rd.add("chain_mismatch", int(not trees_equal(a["out"],
                                                             b["state"])))
            if trains and follows and sh in last_out:
                rd.add("chain_mismatch", int(not carried_over(
                    last_out[sh], trains[0]["state"])))
            if trains:
                last_out[sh] = trains[-1]["out"]
            else:
                last_out.pop(sh, None)
            train_seen = 0
            for kind, c in calls:
                if kind == "latest":
                    rows_now = c["rows"].cpu().numpy()
                elif kind == "train":
                    if not control:
                        for f in range(len(slot_twin)):
                            tw = int(slot_twin[f])
                            if tw < 0:
                                exact += int(bool(c["y"][f].abs().sum() > 0))
                                continue
                            y, u = tele.windows(tw, fed)
                            exact += int(not (torch.equal(c["y"][f], y)
                                              and torch.equal(c["u"][f], u)))
                    if train_seen == 0:
                        exact += _check_resets(rd, model, c, slots, control)
                    _refit(rd, model, c, slots, s["sparsify_after"], control,
                           pools.setdefault(sh, []))
                    train_seen += 1
                elif kind == "recover":
                    th_r, pooled, margin = model.recover(
                        c["params"], c["y"], c["u"], margins=True)
                    if control:
                        model.tf32 = True
                        th_g = model.recover(c["params"], c["y"], c["u"])
                        model.tf32 = False
                    else:
                        th_g = c["out"]
                    promote_thetas = (th_g, th_r)
                    # a coefficient at the selection threshold may fall on
                    # either side: kept, it must be the pooled value
                    edge = margin <= band
                    want = torch.where(edge & (th_g != 0), pooled, th_r)
                    want = torch.where(edge & (th_g == 0), 0.0, want)
                    for f in slots:
                        rd.add("recover_rel", float(
                            (th_g[f] - want[f]).double().norm()
                            / th_r[f].double().norm().clamp(min=1e-30)))
                elif kind == "score":
                    exact += _score_call(rd, c, rows_now, control, tele, fed,
                                         pre, max_twins, terms, dt, gw)
                    if promote_thetas is None:       # the guard stage
                        exact += _guard(rd, c, rows_now, pre, max_twins,
                                        rec["events"][sh], g, band, control)
                        continue
                    shadow.append(c)                 # candidate, incumbent
                    if len(shadow) == 2:
                        exact += _promote(rd, *shadow, promote_thetas, slots,
                                          slot_twin, pre, post, twin_row,
                                          cfg, band, control)
        rec["read"] = set(rd.seen)
        prev_tick = rec["tick"]
    for pool in pools.values():
        _pooled(rd, pool)
    for q in queries:
        rd.seen = set()
        st = q["state"]
        if not control:
            exact += _history_mismatch(st, q["deployed"])
        y0 = torch.as_tensor(tele.ys[q["twin"], q["fed"] - 1], device=device)
        us = torch.as_tensor(q["us"], device=device)
        want = ref.scenario(st["theta_hist"], st["count"], y0, us, dt, terms)
        got = (ref.scenario(st["theta_hist"], st["count"], y0, us, dt,
                            terms, tf32=True) if control else
               [torch.as_tensor(a, device=device) for a in q["answer"]])
        scale = float(want[0].abs().max().clamp(min=1e-30))
        rd.add("scenario_center_rel",
               float((got[0] - want[0]).abs().max()) / scale)
        # the envelope's edges, over the width of the envelope
        width = float((want[2] - want[1]).abs().max().clamp(min=1e-30))
        rd.add("scenario_envelope_rel", max(
            float((a - b).abs().max()) for a, b in
            zip(got[1:3], want[1:3])) / width)
        rd.add("scenario_confidence_rel", ref.relative_gap(got[3], want[3]))
        q["read"] = set(rd.seen)
    return rd.v, exact


def _history_mismatch(st: dict, deployed) -> int:
    """A queried twin's served models: the live one is the stored theta, and
    each ring entry not yet overwritten by a promotion is the model the
    benchmark deployed (deployed [D, n, L], oldest first)."""
    E = st["theta_hist"].shape[0]
    count = st["count"]
    bad = int(not torch.equal(st["theta_hist"][(count - 1) % E], st["theta"]))
    D = deployed.shape[0]
    for p in range(E):
        idx = count - 1 - ((count - 1 - p) % E)     # newest entry at p
        if 0 <= idx < D:
            want = torch.as_tensor(deployed[idx],
                                   device=st["theta_hist"].device)
            bad += int(not torch.equal(st["theta_hist"][p], want))
    return bad


def unread(recorder: Recorder, queries: list, cell, cfg: dict) -> int:
    """Numbers the cell must read on every checked tick and query that were
    not read (a route past the observed entry points reads nothing), with
    checked ticks or queries that never came counted in full."""
    lim, c = cell.limits, cell.traffic["check"]
    tick_names = set(lim.get("every_checked_tick", ()))
    query_names = set(lim.get("every_checked_query", ()))
    miss = sum(len(tick_names - r.get("read", set()))
               for r in recorder.records)
    miss += len(tick_names) * max(0, c["ticks"] - len(recorder.records))
    q = cell.traffic.get("queries")
    if q:
        miss += sum(len(query_names - k.get("read", set())) for k in queries)
        miss += len(query_names) * max(
            0, q["per_tick"] * c["ticks"] - len(queries))
    return miss


def _score_call(rd, c, rows, control, tele, fed, pre, max_twins, terms, dt,
                gw) -> int:
    """Scores against the reference; the rows read against the telemetry."""
    bad = 0
    valid = [i for i, r in enumerate(rows) if r < max_twins]
    if not control:
        for i in valid:
            y, u = tele.latest(int(pre["twin_id"][rows[i]]), fed, gw)
            bad += int(not (torch.equal(c["ys"][i], y)
                            and torch.equal(c["us"][i], u)))
    want = ref.guard_score(c["theta"], c["ys"], c["us"], dt, terms)
    got = (ref.guard_score(c["theta"], c["ys"], c["us"], dt, terms,
                           tf32=True) if control else c["out"])
    c["want"], c["got"] = want, got
    idx = torch.as_tensor(valid, dtype=torch.long, device=want.device)
    rd.add("guard_score_rel", ref.relative_gap(got[idx], want[idx],
                                                SCORE_FLOOR))
    return bad


def _guard(rd, c, rows, pre, max_twins, events, g, band, control) -> int:
    """The guard stage: thetas scored are the store's; events as the
    reference's EMA and thresholds give them."""
    bad = 0
    if not control:
        th = pre["theta"][torch.as_tensor(rows, device=pre["theta"].device)]
        bad += int(not torch.equal(th, c["theta"]))
    got_ev = dict(events)
    for i, r in enumerate(rows):
        if r >= max_twins or not pre["guard_live"][r]:
            continue
        div = ref.ema(pre["div"][r], float(c["want"][i]), g["ema"])
        if any(abs(div - t) <= band * t for t in (g["refit_threshold"],
                                                  g["alert_threshold"])):
            continue
        kind = ref.judge(div, g["refit_threshold"], g["alert_threshold"])
        tw = int(pre["twin_id"][r])
        expect = kind if kind != KINDS[int(pre["guard_code"][r])] \
            and kind != "OK" else None
        div_g = ref.ema(pre["div"][r], float(c["got"][i]), g["ema"])
        kind_g = ref.judge(div_g, g["refit_threshold"], g["alert_threshold"])
        got = (kind_g if kind_g != KINDS[int(pre["guard_code"][r])]
               and kind_g != "OK" else None) if control else got_ev.get(tw)
        rd.add("decision_mismatch", int(expect != got))
    return bad


def _promote(rd, cand, inc, thetas, slots, slot_twin, pre, post, twin_row,
             cfg, band, control) -> int:
    """Promote decisions from the reference's shadow scores; promoted rows
    hold the candidate the program extracted."""
    s, thresh = cfg["server"], cfg["guard"]["refit_threshold"]
    margin = s["promote_margin"]
    bad = 0
    if not control:
        bad += int(not torch.equal(cand["theta"], thetas[0]))
    for f in slots:
        r = twin_row[int(slot_twin[f])]
        if post["steps_in_slot"][r] < s["deploy_after"]:
            continue
        c, i = float(cand["want"][f]), float(inc["want"][f])
        if (abs(c - margin * i) <= band * max(c, margin * i)
                or abs(c - thresh) <= band * thresh
                or abs(i - thresh) <= band * thresh):
            continue

        def decide(c, i):
            healthy = bool(pre["deployed"][r]) and i < thresh
            return c < margin * i or (not healthy and c < thresh)
        want = decide(c, i)
        got = (decide(float(cand["got"][f]), float(inc["got"][f]))
               if control else
               bool(post["hist_count"][r] - pre["hist_count"][r]))
        rd.add("decision_mismatch", int(want != got))
        if got and not control:
            bad += int(not torch.equal(post["theta"][r], thetas[0][f]))
    return bad


def _check_resets(rd, model, c, slots, control) -> int:
    """Slots admitted this tick start from zero moments and a zero step
    count, with norm statistics of their own windows.  The control works
    the statistics out in bfloat16, the precision below float32 for
    arithmetic outside the products."""
    bad = 0
    st = c["state"]
    for f in slots:
        if int(st["steps"][f]) != 0:
            continue
        if not control:
            for tree in (st["opt"]["mu"], st["opt"]["nu"]):
                for leaves in tree.values():
                    for leaf in leaves.values():
                        bad += int(bool(leaf[f].abs().sum() > 0))
        want = model.norm_stats(c["y"][f], c["u"][f])
        got = ({k: v.float() for k, v in model.norm_stats(
                    c["y"][f].bfloat16(), c["u"][f].bfloat16()).items()}
               if control else
               {k: st["params"]["norm"][k][f] for k in want})
        for k, v in want.items():
            rd.add("reset_norm_rel", ref.relative_gap(got[k], v))
    return bad


def check_ring(server, cfg: dict, tele: Telemetry, shard: int, fed: int
               ) -> int:
    """Ring rows that do not hold the newest samples fed (count and data)."""
    s = server.snapshot_state()["rstate"]
    cap = cfg["server"]["capacity"]
    count = s["count"].cpu().numpy()
    ry, ru = s["y"].cpu().numpy(), s["u"].cpu().numpy()
    bad = 0
    nS = cfg["shards"]
    for row in range(cfg["server"]["max_twins"]):
        twin = row * nS + shard
        if twin >= cfg["twins"]:
            break
        lo = max(0, fed - cap)
        cols = np.arange(lo, fed) % cap
        bad += int(count[row] != fed
                   or not np.array_equal(ry[row, cols], tele.ys[twin, lo:fed])
                   or not np.array_equal(ru[row, cols], tele.us[twin, lo:fed]))
    return bad


def check_deploy(servers: list, cfg: dict) -> int:
    """Twins whose stored model after deploy is not the F-8's."""
    mer = cfg["merinda"]
    want = torch.as_tensor(ref.f8_theta(mer["order"]), dtype=torch.float32)
    bad = 0
    for i, srv in enumerate(servers):
        rows = len(range(i, cfg["twins"], cfg["shards"]))
        th = srv.snapshot_state()["theta"][:rows]
        bad += int((th.cpu() != want).any(dim=(1, 2)).sum())
    return bad
