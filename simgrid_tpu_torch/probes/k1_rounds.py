"""K1's rounds on the card: time per round and where it goes, by case.

    python simgrid_tpu_torch/probes/k1_rounds.py [--root DIR] [--out PATH]
        [--cases solo,fleet8,a2a_bounds,a2a_fat,glob48] [--profile]

Each K1 case builds one system of the port's main paths, solves it once
from init to convergence with K1 (``kernels/lmm_round.py``) and then
times its rounds three ways:

* ``paced_ms``: CUDA events around the host's loop of wrapper calls
  (init plus the rounds, less the init), the host-clock figure
  ``chip_smoke.py`` keeps beside the card's: where the host's enqueue
  is slower than the card, this is the host's time;
* ``ms``: the card's own time per round.  The rounds are queued in
  windows of ``ROUND_WINDOW`` behind ``torch.cuda._sleep`` (held longer than
  the host takes to enqueue a window), so they run back to back;
  ``queued`` says that the stream was still busy after every window's
  last enqueue;
* with ``--profile``, the card's time per kernel name over one solve
  (``torch.profiler``), and the row-length classes of the system.

The timing is ``probes/timing.py``'s ``time_rounds``, which
``chip_smoke.py`` uses for K1's rows too; it is always this checkout's,
whichever package ``--root`` imports.

``--root`` imports ``simgrid_tpu_torch`` from another checkout (a
parent commit unpacked under ``build/``), so two versions of K1 can be
timed on one card in one call.  The cases:

* ``solo``: config #4's random drain system (100,000 flows on the
  dragonfly, unit penalties), the local bound-free round;
* ``fleet8``: the same system as a fleet of 8 replicas (bounds scaled
  1.0-1.3, per-replica weights), K1's replica arm;
* ``a2a_bounds``: the 320-rank LV08 alltoall, the bound-first rule;
* ``a2a_5b``: the same with its bounds redrawn as its rates times
  U(0.5, 1.5) (``chip_smoke.py``'s phase 5(b): about half of them bind,
  and the solve takes tens of thousands of rounds);
* ``a2a_fat``: the same with a seeded 10% of its links FATPIPE;
* ``glob48``: the 48-rank alltoall in the global order with bounds,
  the bounds redrawn as its rates times U(0.5, 1.5) so that they bind;
* ``arms128`` and ``arms128_global``: ``chip_smoke.py``'s phase-17 fleet
  of 8 over a random 128 x 1,000 system (degree 3, bounds scaled
  U(0.8, 1.2) per replica, half the flows bounded, 10% FATPIPE), the
  local bound-first and the global arm, both with FATPIPE;
* ``stage8``: ``bench.py``'s sweep system (96 x 400, degree 3) as a
  fleet of 8 (bounds scaled 1.0-1.7), the local bound-free round;
* ``sweep`` and ``sweep8`` (not in the default list): ``bench.py``'s
  sweep stage (``workloads/fleet_run.run_sweep``) at widths 1, 8 and 64,
  or at width 8 alone, its wall by width (host clock, ending in a sync)
  in place of the round times;
* ``coll1024`` (not in the default list): ``chip_smoke.py``'s main path
  11 without its admission, the 1,024-rank recursive-doubling allreduce
  as a collective fleet of 32 (``workloads/collective_fleet.py``), its
  wall and K1's launches;
* ``wall1``, ``wall8`` and ``wall10`` (not in the default list):
  ``chip_smoke.py``'s main paths 1 (the config-#4 random drain), 8 (the
  same under phase 13's fault tape) and 10 (the fleet of 8 over it,
  without its admission), their walls (host clock, ending in a sync),
  with K1's rounds: the host's wrapper calls, the card's rounds inside
  K16's graphs, the working rounds (``loop_counts``).  With
  ``--profile`` these cases and ``coll1024`` run under
  ``torch.profiler`` instead (``timing.busy_profile``: the card's busy
  time, the profiled wall and their ratio);
* ``headline`` (not in the default list): ``chip_smoke.py``'s main path
  6, ``bench.py``'s headline solve through the chain, its first and
  median ms and K8's rounds (host calls, rounds inside K16's graphs).

The K2 and K3 cases (``K23_CASES``, not in the default list) time one
wrapper call of ``drain_advance``, ``drain_forced_advance`` or
``superstep_commit`` at a main path's shape, each call from the same
restored state (``probes/timing.py`` ``time_call``: ``ms`` queued behind
a sleep, ``paced_ms`` as the host paces it), in an active advance slot
and in a gated no-op one (K2 with ``SS_ACTIVE`` 0, K3 with ``ADV_GO``
0; the forced mode has no gate), with the CUDA kernels one call launches
(``torch.profiler``) and the bytes bound.  The state is one advance of
seeded flows (90% live, rates U(1e3, 1e5), eight flows ending together
on the planned dt), with a tape date or pending activation dates inside
the advance where the arm is on:

* ``k2``, ``k3``, ``k2_forced``: the solo drain at 100,000 flows (main
  path 1; main path 3 for the forced mode);
* ``k2_event``, ``k3_tape``: the same with a fault tape (main path 8);
* ``k3_coll``: the 1,024-rank recursive doubling's 10,240 flows, a
  quarter of the dormant ones due (main path 9);
* ``k2_fleet``, ``k3_fleet``: 8 replicas of 100,000 flows with tapes
  (main path 10);
* ``k2_fleet_ready``, ``k3_coll_fleet``: 32 replicas of the 10,240
  collective flows with tapes and pending dates (main path 11).
"""

from __future__ import annotations

import argparse
import json
import importlib.util
import os
import sys
import time

CASES = ("solo", "fleet8", "a2a_bounds", "a2a_5b", "a2a_fat", "glob48",
         "arms128", "arms128_global", "stage8")
#: row-length thresholds the class counts are reported at
LENGTHS = (0, 1, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)


def kernel_profile(fn) -> dict:
    """Card ms per kernel name over one fn() (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        name = (ev.key or "").replace("void ", "").replace(
            "(anonymous namespace)::", "").split("(")[0]
        if t and name and not name.startswith(("cuda", "aten", "Memcpy")):
            out[name] = out.get(name, 0.0) + t / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def length_classes(c_ptr) -> dict:
    """Rows of each length class: ``{"<=n": count}`` at ``LENGTHS`` and
    the longest row."""
    import numpy as np
    n = np.diff(c_ptr.cpu().numpy())
    out = {f"<={t}": int((n <= t).sum()) for t in LENGTHS}
    out["rows"] = int(n.size)
    out["max"] = int(n.max()) if n.size else 0
    return out


def build_case(name: str, device):
    """(sys, work, pen, vb, arms, eps) of one case on ``device``."""
    import numpy as np
    import torch
    from simgrid_tpu_torch.kernels.common import LmmSystem, Work
    from simgrid_tpu_torch.ops.lmm_arrays import to2d
    from simgrid_tpu_torch.ops.lmm_torch import to_device_system
    from simgrid_tpu_torch.workloads import dragonfly
    from simgrid_tpu_torch.workloads.drain_run import EPS, solve_inputs
    f64 = torch.float64
    if name in ("solo", "fleet8"):
        dsys = dragonfly.build_system(100_000)
        flat = [to2d(a).reshape(-1) for a in (dsys.e_var, dsys.e_cnst,
                                              dsys.e_w)]
        V = len(dsys.sizes)
        s = to_device_system(flat[0], flat[1], flat[2], dsys.c_bound, V,
                             f64, device)
        if name == "solo":
            return (s, Work(V, s.n_c, f64, device),
                    torch.ones(V, dtype=f64, device=device), None, {}, EPS)
        B = 8
        scale = torch.linspace(1.0, 1.3, B, dtype=f64, device=device)
        s = s._replace(c_bound=s.c_bound[None, :] * scale[:, None],
                       e_w=s.e_w[None, :].repeat(B, 1).contiguous())
        return (s, Work(V, s.n_c, f64, device, B=B),
                torch.ones((B, V), dtype=f64, device=device), None, {}, EPS)
    if name == "stage8":
        from simgrid_tpu_torch.workloads import fleet_run
        ev, ec, ew, cb, _ = fleet_run.stage_system(**fleet_run.STAGE)
        n_v = fleet_run.STAGE["n_v"]
        s = to_device_system(ev, ec, ew, cb, n_v, f64, device)
        B = 8
        scale = torch.linspace(1.0, 1.7, B, dtype=f64, device=device)
        s = s._replace(c_bound=s.c_bound[None, :] * scale[:, None])
        return (s, Work(n_v, s.n_c, f64, device, B=B),
                torch.ones((B, n_v), dtype=f64, device=device), None, {},
                fleet_run.EPS)
    if name.startswith("arms128"):
        from simgrid_tpu_torch.ops.csr import build_csr
        from simgrid_tpu_torch.workloads.bench_solve import build_arrays
        rng = np.random.default_rng(5)
        B, n_c, n_v = 8, 128, 1000
        arr = build_arrays(rng, n_c, n_v, 3, np.float64)
        E = arr.n_elem
        cb = arr.c_bound[:n_c] * rng.uniform(0.8, 1.2, (B, n_c))
        vb = np.where(rng.random((B, n_v)) < 0.5,
                      rng.uniform(1e-3, 1e-2, (B, n_v)), -1.0)
        fat = np.zeros(n_c, bool)
        fat[rng.choice(n_c, n_c // 10, replace=False)] = True
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
        ev, ec, ew = t(arr.e_var[:E]), t(arr.e_cnst[:E]), t(arr.e_w[:E])
        s = LmmSystem(ev, ec, ew, t(cb), build_csr(ev, ec, ew, n_c, n_v),
                      n_v, t(fat))
        arms = dict(has_bounds=True, has_fatpipe=True,
                    global_rounds=name.endswith("global"))
        return (s, Work(n_v, n_c, f64, device, B=B),
                torch.ones((B, n_v), dtype=f64, device=device), t(vb), arms,
                1e-9)
    ranks = 48 if name == "glob48" else 320
    arr = solve_inputs(dragonfly.build_alltoall(ranks))
    fat = None
    if name == "a2a_fat":
        fat = np.random.default_rng(12).random(arr.n_cnst) < 0.10
    s = to_device_system(arr.e_var, arr.e_cnst, arr.e_w, arr.c_bound,
                         arr.n_var, f64, device, fat)
    pen = torch.from_numpy(arr.v_penalty.copy()).to(device)
    vb = torch.from_numpy(arr.v_bound.copy()).to(device)
    w = Work(arr.n_var, arr.n_cnst, f64, device)
    arms = dict(has_bounds=True, has_fatpipe=fat is not None)
    if name in ("glob48", "a2a_5b"):
        _solve(s, w, pen, vb, arms, EPS)
        rates = w.v_value.cpu().numpy()
        vb = torch.from_numpy(rates * np.random.default_rng(11).uniform(
            0.5, 1.5, arr.n_var)).to(device)
    if name == "glob48":
        arms = dict(has_bounds=True, global_rounds=True)
    assert isinstance(s, LmmSystem)
    return s, w, pen, vb, arms, EPS


def _solve(s, w, pen, vb, arms, eps, limit=200_000) -> int:
    """Init and rounds to convergence; the round count (the most of any
    replica)."""
    from simgrid_tpu_torch.kernels.common import IT, LIGHT
    from simgrid_tpu_torch.kernels.lmm_round import lmm_init, lmm_round
    lmm_init(s, w, pen, eps, has_fatpipe=arms.get("has_fatpipe", False))
    while True:
        for _ in range(16):
            lmm_round(s, w, pen, eps, vb, **arms)
        ctrl = w.ctrl.reshape(-1, w.ctrl.shape[-1])
        it = int(ctrl[:, IT].max())
        if int(ctrl[:, LIGHT].max()) == 0:
            return it
        if it > limit:
            raise RuntimeError("K1 did not converge")


def run_sweep_walls(batches=(1, 8, 64)) -> dict:
    """``bench.py``'s sweep stage on the card: the wall by width."""
    from simgrid_tpu_torch.workloads import fleet_run
    rows = fleet_run.run_sweep(device="cuda", batches=batches)
    return {"walls_s": {r["batch"]: r["wall_s"] for r in rows},
            "dispatches": {r["batch"]: r["dispatches"] for r in rows}}


def main_paths():
    """This checkout's ``chip_smoke.py``, loaded from its file: its
    ``FLOWS``, ``K``, ``FLEET_B``, ``FLEET_K``, ``FAULT`` and ``COLL_B``
    define the main paths the walls and the K2 and K3 cases run."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("k1_rounds_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_coll_fleet(profile: bool = False) -> dict:
    """The 1,024-rank collective fleet of ``chip_smoke.py``'s width on
    the card: its wall and its launches of K1 and of the row plan (with
    ``profile``, the fleet's run under ``torch.profiler``)."""
    from simgrid_tpu_torch.workloads import collective_fleet as cf
    from simgrid_tpu_torch.workloads import collective_run, fleet_run
    import torch
    cs = collective_run.CASES[2]
    _, legs, _ = collective_run.run_case(cs, device=torch.device("cuda"))
    t_end = legs["tape"]["events"][-1][0]
    camp = cf.fleet_campaign(
        cs, cf.fleet_specs(cs, t_end, main_paths().COLL_B), "cuda")
    with _Busy(profile) as busy:
        _, row = fleet_run.run_fleet_full(camp)
    keep = ("lmm_plan", "lmm_init_fleet", "lmm_round_fleet")
    return {"wall_s": row["wall_s"], "supersteps": row["supersteps"],
            "dispatches": row["dispatches"], "rounds": row["rounds"],
            "launches": {k: row["launches"].get(k, 0) for k in keep},
            **loop_counts(row), **busy.rec}


#: the K2 and K3 cases: (wrapper, replicas, shape, tape, ready dates);
#: the replicas of ``fleet`` and ``coll`` are ``chip_smoke.py``'s
#: ``FLEET_B`` and ``COLL_B``
K23_CASES = {
    "k2": ("advance", None, "drain", False, False),
    "k2_event": ("advance", None, "drain", True, False),
    "k2_fleet": ("advance", "fleet", "drain", True, False),
    "k2_fleet_ready": ("advance", "coll", "coll", True, True),
    "k2_forced": ("forced", None, "drain", False, False),
    "k3": ("commit", None, "drain", False, False),
    "k3_tape": ("commit", None, "drain", True, False),
    "k3_coll": ("commit", None, "coll", False, True),
    "k3_fleet": ("commit", "fleet", "drain", True, False),
    "k3_coll_fleet": ("commit", "coll", "coll", True, True),
}
_SHAPES: dict = {}


def k23_shape(kind: str):
    """(V, C) of the config-#4 drain or of the 1,024-rank collective."""
    if kind not in _SHAPES:
        if kind == "drain":
            from simgrid_tpu_torch.workloads import dragonfly
            s = dragonfly.build_system(main_paths().FLOWS)
            _SHAPES[kind] = (len(s.sizes), s.n_cnst)
        else:
            from simgrid_tpu_torch.workloads import collective_run
            dc = collective_run.CASES[2].build()
            _SHAPES[kind] = (dc.n_v, dc.n_c)
    return _SHAPES[kind]


def run_k23(name: str) -> dict:
    """One K2 or K3 case (module docstring): the card's ms of one call,
    active and gated off, beside the host-paced ms and the bound."""
    t = _timing()
    rec, fn, on, off = k23_call(name)
    for label, setup in (("active", on), ("noop", off)):
        if setup is None:
            continue
        q = t.time_call(fn, setup)
        rec[label] = {"ms": q["ms"], "queued": q["queued"],
                      "paced_ms": t.events_ms(fn, 20, setup)}
    rec["cuda_launches"] = t.kernel_counts(fn, on)
    return rec


def k23_call(name: str, shape=None):
    """One K2 or K3 case's state on the card (module docstring), at its
    main path's (V, C) or at ``shape``: ``(rec, fn, on, off)``, with
    ``fn`` one wrapper call, ``on`` and ``off`` the setups of an active
    and of a gated no-op slot (``off`` None for the forced mode), and
    ``rec`` the case, its counts and its bound."""
    import numpy as np
    import torch
    from simgrid_tpu_torch.kernels import common as kc
    from simgrid_tpu_torch.kernels.drain_advance import (
        drain_advance, drain_forced_advance)
    from simgrid_tpu_torch.kernels.superstep_commit import (
        packed_size, superstep_commit)
    t = _timing()
    smoke = main_paths()
    what, B, kind, tape, ready = K23_CASES[name]
    B = {"fleet": smoke.FLEET_B, "coll": smoke.COLL_B}.get(B, B)
    V, C = shape or k23_shape(kind)
    k_max = smoke.K
    dev, f64 = torch.device("cuda"), torch.float64
    rng = np.random.default_rng(3)
    lead = () if B is None else (B,)
    pen = np.where(rng.random(lead + (V,)) < 0.9, 1.0, 0.0)
    rate = rng.uniform(1e3, 1e5, lead + (V,))
    rem = rate * rng.uniform(2.0, 50.0, lead + (V,))
    end = rng.choice(V, 8, replace=False)
    pen[..., end] = 1.0
    rem[..., end] = rate[..., end]
    T = lambda a: torch.from_numpy(np.array(a)).to(dev)  # noqa: E731
    pen0, rem0, thr = T(pen), T(rem), T(1e-4 * rem)
    tt = tap = rd0 = None
    if tape:
        tt = T(np.sort(rng.uniform(0.5, 40.0, lead + (64,)), axis=-1))
        tap = (T(rng.integers(0, C, lead + (64,)).astype(np.int32)),
               T(rng.uniform(1e8, 1e10, lead + (64,))))
    if ready:
        r = np.full(lead + (V,), np.inf)
        due = np.where(pen == 0.0, rng.random(lead + (V,)) < 0.25, False)
        r[due] = 0.25
        rd0 = T(r)
    w = kc.Work(V, C, f64, dev, B=B)
    w.v_value.copy_(T(rate))
    c = w.ctrl.reshape(-1, kc.N_CTRL)
    c[:, kc.LIMIT] = 100
    c[:, kc.IT] = 5
    c[:, kc.SS_ACTIVE] = 1
    if ready:
        c[:, kc.PENDING] = torch.isfinite(rd0).reshape(-1, V).sum(1).to(
            torch.int32)
    pen, rem = pen0.clone(), rem0.clone()
    rd = None if rd0 is None else rd0.clone()
    snap = [w.ctrl.clone(), w.fctrl.clone(), w.evf.clone()]

    def restore(go=1):
        pen.copy_(pen0)
        rem.copy_(rem0)
        for x, y in zip((w.ctrl, w.fctrl, w.evf), snap):
            x.copy_(y)
        w.ctrl.reshape(-1, kc.N_CTRL)[:, kc.SS_ACTIVE] = go

    def k2():
        drain_advance(pen, rem, thr, w, gated=1, tape_t=tt, ready=rd)
    rec = {"case": name, "B": w.nb, "V": V, "C": C}
    nbytes = lambda *xs: sum(x.numel() * x.element_size()  # noqa: E731
                             for x in xs if x is not None)
    # K2: each input read once (flow state, rates, thresholds, dates,
    # one tape date a replica), pen, rem and the mask written once
    k2_bytes = (nbytes(pen0, rem0, thr, w.v_value, rd0) + 8 * w.nb * bool(
        tape) + nbytes(pen0, rem0) + w.done.numel())
    if what == "forced":
        fn, on, off = (lambda: drain_forced_advance(pen, rem, thr, w, 1.0),
                       restore, None)
        rec["bound_ms"] = t.bound_ms(k2_bytes)
    elif what == "advance":
        fn, on, off = k2, restore, (lambda: restore(0))
        rec["bound_ms"] = t.bound_ms(k2_bytes)
    else:
        restore()
        k2()
        torch.cuda.synchronize()
        ring_n = V + 64
        packed = torch.zeros(lead + (packed_size(k_max, ring_n),),
                             dtype=f64, device=dev)
        cb0 = T(rng.uniform(1e8, 1e10, lead + (C,)))
        cb = cb0.clone()
        ids = torch.arange(V, dtype=torch.int32, device=dev)
        pen1 = pen.clone()
        snap3 = [w.ctrl.clone(), w.fctrl.clone(), w.evf.clone()]
        n_done = int(w.done.sum())
        due = None if rd0 is None else rd0 <= w.evf.reshape(
            -1, kc.N_EVF)[:, kc.EV_NEXT_T:].to(rd0)
        n_act = 0 if due is None else int(due.sum())
        # the flows whose id the commit reads, an id read once for all
        # replicas
        hit = w.done.reshape(-1, V).bool()
        if due is not None:
            hit = hit | due.reshape(-1, V)
        n_ids = int(hit.any(0).sum())
        n_fire = int(c[:, kc.FFIRE].sum()) if tape else 0

        def restore3(go=1):
            for x, y in zip((w.ctrl, w.fctrl, w.evf), snap3):
                x.copy_(y)
            pen.copy_(pen1)
            cb.copy_(cb0)
            if rd is not None:
                rd.copy_(rd0)
            w.ctrl.reshape(-1, kc.N_CTRL)[:, kc.ADV_GO] = go

        def fn():
            superstep_commit(w, ids, packed, k_max, ring_n, tape=tap,
                             c_bound=cb, n_c=C, ready=rd, pen=pen)
        on, off = restore3, (lambda: restore3(0))
        rec.update(n_done=n_done, n_act=n_act, n_fire=n_fire)
        # the mask and the ids of completing or activating flows read, a
        # ring entry (date, id) written per event; with dates, the dates
        # read and a pen and a date written per activation; per fire a
        # tape entry read and a bound written
        rec["bound_ms"] = t.bound_ms(
            w.done.numel() + 4 * n_ids + 16 * (n_done + n_act + n_fire)
            + nbytes(rd0) + 16 * n_act + 20 * n_fire)
    rec["bound_by"] = "bytes"
    return rec, fn, on, off


class _Busy:
    """With ``on``, every executor ``run`` (solo and fleet) inside the
    block runs under ``timing.busy_profile``; ``rec`` holds the last
    one's busy time, profiled wall and share."""

    def __init__(self, on: bool):
        self.on = on
        self.rec: dict = {}
        self.saved = []

    def __enter__(self):
        if not self.on:
            return self
        from simgrid_tpu_torch.ops.lmm_batch import BatchDrainSim
        from simgrid_tpu_torch.ops.lmm_drain import DrainSim
        busy = _timing().busy_profile
        for cls in (DrainSim, BatchDrainSim):
            orig = cls.run

            def run(sim, *a, _orig=orig, **kw):
                r = busy(lambda: _orig(sim, *a, **kw))
                r.pop("result")
                self.rec = r
            self.saved.append((cls, orig))
            cls.run = run
        return self

    def __exit__(self, *exc):
        for cls, orig in self.saved:
            cls.run = orig
        return False


def loop_counts(row: dict) -> dict:
    """K1's rounds on a path: the wrapper calls the host queued, the
    rounds the card ran inside K16's graphs (None before K16) and the
    rounds the control words report (the working rounds), with K16's
    graph launches."""
    loop = row.get("loop")
    if loop is None:      # a tree before K16: every round a host call
        queued = sum(v for k, v in row.get("launches", {}).items()
                     if k.startswith("lmm_round"))
        return {"k1_host_calls": queued, "k1_device_rounds": None,
                "graph_launches": 0, "working_rounds": row["rounds"]}
    tally = loop["device_tally"]
    return {"k1_host_calls": sum(loop["host_round_calls"].values()),
            "k1_device_rounds": tally.get("lmm_round", 0)
            + tally.get("lmm_round_fleet", 0),
            "device_slots": tally.get("slots", 0),
            "graph_launches": sum(loop["graph_launches"].values()),
            "working_rounds": row["rounds"]}


def run_walls(name: str, profile: bool = False) -> dict:
    """Main path 1, 8 or 10's wall on the card (module docstring); with
    ``profile`` its run under ``torch.profiler`` (the card's busy
    share) in place of the plain wall."""
    import torch
    from simgrid_tpu_torch.workloads import dragonfly, fault_drain, fleet_run
    from simgrid_tpu_torch.workloads.drain_run import EPS, run_drain
    smoke = main_paths()
    dsys = dragonfly.build_system(smoke.FLOWS)
    cuda = torch.device("cuda")
    with _Busy(profile) as busy:
        if name == "wall1":
            _, row = run_drain(dsys, device=cuda, superstep=smoke.K)
        elif name == "wall8":
            tape = fault_drain.tape_for(
                dsys.e_cnst, dsys.e_w, dsys.c_bound,
                link_names=dragonfly.link_names(dsys), **smoke.FAULT)
            _, row = fault_drain.run_fault_drain(dsys, tape, device=cuda,
                                                 superstep=smoke.K)
        else:
            specs = fleet_run.fleet_specs(smoke.FLOWS, len(dsys.e_var),
                                          smoke.FAULT)
            camp = fleet_run.fleet_campaign(dsys, specs, cuda,
                                            smoke.FLEET_K,
                                            dragonfly.link_names(dsys), EPS)
            _, row = fleet_run.run_fleet_full(camp)
    keep = ("wall_s", "executor_s", "advances", "supersteps", "rounds",
            "fires")
    return {**{k: row[k] for k in keep if k in row}, **loop_counts(row),
            **busy.rec}


def run_headline() -> dict:
    """``bench.py``'s headline solve (``chip_smoke.py``'s ``HEADLINE``,
    main path 6) on the card through its default path, the chain: the
    first solve's ms and the median of 9 more (host clock, each ending
    in its fetch), with K8's rounds as ``loop_counts`` reads them."""
    import torch
    from simgrid_tpu_torch.workloads import bench_solve
    smoke = main_paths()
    _, row = bench_solve.run_bench_solve(device=torch.device("cuda"),
                                         reps=9, eps=smoke.HL_EPS,
                                         **smoke.HEADLINE)
    loop = row.get("loop")
    launches = row["launches"]
    return {"path": row["path"], "rounds": row["rounds"],
            "first_ms": row["first_ms"], "ms": row["ms"],
            "reps_ms": row["reps_ms"],
            "k8_host_calls": (launches.get("vc_round", 0) if loop is None
                              else loop["host_round_calls"].get("vc_round",
                                                                0)),
            "k8_device_rounds": (None if loop is None else
                                 loop["device_tally"].get("vc_round", 0)),
            "graph_launches": (0 if loop is None else
                               sum(loop["graph_launches"].values()))}


def _timing():
    """This checkout's ``probes/timing.py``, loaded from its file: the
    package that ``--root`` imports may predate ``time_rounds``."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "timing.py")
    spec = importlib.util.spec_from_file_location("k1_rounds_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_case(name: str, profile: bool = False) -> dict:
    import torch
    from simgrid_tpu_torch.kernels.lmm_round import lmm_init, lmm_round
    if name in ("sweep", "sweep8"):
        return {"case": name, **run_sweep_walls(
            (8,) if name == "sweep8" else (1, 8, 64))}
    if name == "coll1024":
        return {"case": name, **run_coll_fleet(profile)}
    if name in K23_CASES:
        return run_k23(name)
    if name in ("wall1", "wall8", "wall10"):
        return {"case": name, **run_walls(name, profile)}
    if name == "headline":
        return {"case": name, **run_headline()}
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    s, w, pen, vb, arms, eps = build_case(name, dev)
    build_s = time.perf_counter() - t0
    rounds = _solve(s, w, pen, vb, arms, eps)
    fat = arms.get("has_fatpipe", False)

    def init():
        lmm_init(s, w, pen, eps, has_fatpipe=fat)

    def rnd():
        lmm_round(s, w, pen, eps, vb, **arms)
    rec = {"case": name, "V": s.n_v, "C": s.n_c, "nnz": s.csr.nnz,
           "B": w.nb, "build_s": build_s,
           **_timing().time_rounds(init, rnd, rounds)}
    if profile:
        rec["classes"] = length_classes(s.csr.c_ptr)
        prof = kernel_profile(lambda: (init(), [rnd() for _ in
                                                range(rounds)]))
        rec["profile_ms_per_round"] = {k: v / max(rounds, 1)
                                       for k, v in prof.items()}
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="import simgrid_tpu_torch from this checkout")
    ap.add_argument("--out", default=None, help="append JSON lines here")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("k1_rounds: no CUDA device", file=sys.stderr)
        return 2
    from simgrid_tpu_torch.kernels import build
    build.build_all()
    kind = torch.cuda.get_device_name(0)
    for name in args.cases.split(","):
        rec = {"label": args.label, "root": root, "kind": kind,
               **run_case(name, args.profile)}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
