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
* ``loop_<case>`` (not in the default list; ``loop_solo``,
  ``loop_a2a_bounds``, ...): K1 inside K16's loop, the way the drains
  run it.  The case's rounds from its init as the body of one capped
  ``Loop(PRED_ROUND, ...)`` (cap: the solve's rounds) in a
  ``DeviceLoop``, one graph launch; ``ms`` is the card's time of that
  launch (CUDA events around it, the init queued before the first)
  over its rounds, the median of ``LOOP_REPS`` launches after one that
  builds the graph, with the body's nodes (``superstep_loop.bodies``,
  where the checkout has it).  The loop is built with ``ends=True``
  where the checkout's ``Loop`` has the field: a round that does not
  end its loop's iteration itself gets its ``loop_cond`` node all the
  same;
* ``k10`` and ``k10_fleet`` (not in the default list): K10's walk of
  the 1,024-rank recursive-doubling allreduce when its roots complete
  (``chip_smoke.py``'s K10 rows: one advance, at clock 1e-3; the fleet
  ``COLL_B`` replicas at clocks 1e-3 apart), one wrapper call from the
  same restored state (``time_call``), over the out-edge CSR where the
  checkout builds one, with the flows it freed;
* ``k16_first`` (not in the default list): ``chip_smoke.py``'s K16 row,
  the config-#4 drain's first superstep of ``k=4`` advances as one
  graph launch, timed from its saved start after a warm-up launch
  (``chip_smoke.replayed_graph``, ``K16_REPS`` launches): the median,
  the spread and the rounds and advances it ran;
* ``wall1``, ``wall3``, ``wall8`` and ``wall10`` (not in the default
  list): ``chip_smoke.py``'s main paths 1 (the config-#4 random drain),
  3 (the engine-plan drain of the 320-rank LV08 alltoall, cut after
  ``PLAN_ADVANCES`` advances), 8 (the config-#4 drain under phase 13's
  fault tape) and 10 (the fleet of 8 over it, without its admission),
  their walls (host clock, ending in a sync),
  with K1's rounds: the host's wrapper calls, the card's rounds inside
  K16's graphs, the working rounds (``loop_counts``).  With
  ``--profile`` these cases and ``coll1024`` run under
  ``torch.profiler`` instead (``timing.busy_profile``: the card's busy
  time, the profiled wall and their ratio);
* ``headline`` (not in the default list): ``chip_smoke.py``'s main path
  6, ``bench.py``'s headline solve through the chain, its first and
  median ms and K8's rounds (host calls, rounds inside K16's graphs).

* ``k4`` and ``k4_vbound`` (not in the default list): K4's repack at
  main path 1's shape (``chip_smoke.py``'s phase-2 row: config #4's
  100,000 flows, 45% of them live, seed 7) and with the rate bounds at
  the 320-rank alltoall's (its phase-8 row): the card's ms of one call
  (``time_call``), the host-paced ms (``events_ms``), the CUDA kernels
  one call launches (``kernel_counts``) and the bytes bound; with
  ``--profile`` also the card's ms by kernel a call and the host's us
  a call by function (``cProfile``);
* ``repack_cost`` (not in the default list): the whole cost of a repack
  on main path 1 (the config-#4 drain): for each repack, K4's card ms
  (events around its call), the host ms of the drain's device repack
  (K4 and the halved ``Work``, ending in a sync) and the host ms of the
  K16 graph builds that follow it before the next repack (each build
  timed to a sync), with the drain's wall;
* ``k7_bounds``, ``k7_fatpipe`` and ``k7_global`` (not in the default
  list): K7's round arms at ``chip_smoke.py``'s phase-11(d) shapes (the
  headline's full width with 30% of its flows bounded at their rates
  times U(0.5, 1.5), the same with 10% FATPIPE constraints, and
  ``bench.py``'s big class in global order): the first ``K7_ROUNDS``
  rounds of the solve from its init, timed as K1's cases are
  (``time_rounds``: ``ms``, ``paced_ms``) and inside K16's loop
  (``loop_ms``: the solve's chunk loop capped at those rounds, one graph
  launch after its init, the median of ``LOOP_REPS`` after one that
  builds it), with the round body's nodes (``superstep_loop.bodies``);
  with ``--profile`` also the card's ms a round by kernel.

* ``k5``, ``k5_delta``, ``k5_ell``, ``k6`` and ``k6_ell`` (not in the
  default list): K5's three arms and K6's two at ``chip_smoke.py``'s
  phase-8, -9 and -12 shapes: the transition batch of the 320-rank
  alltoall (1% of its flows' bounds, constraints' bounds and penalties,
  seed 5), and, from the resident state of the warm-selective 100k churn
  (``CHURN``; COO as main path 4, the card's default ELL as main path
  7), the delta batch of six padded runs and the ELL element batch of
  999 entries a table (seed 9), and K6's restart of the chain plus up
  to 999 random clusters (the index sorted and padded with its last
  entry, which every tree's K6 takes; ``k6_one`` and ``k6_ell_one``: a
  single modified cluster, a fault's bound restart) the card's ms of one call
  (``time_call``), the paced ms (``events_ms``), the plain version's
  paced ms, the CUDA launches a call (the kernel nodes of one captured
  call, ``superstep_loop.kernel_nodes``), the bytes bound and, for K5,
  ``index_put_`` (one call a run) timed the same ways; with
  ``--profile`` also the card's ms by kernel a call.  The churns run
  once a process and are kept for the later cases;
* ``k11_birth``, ``k11_admit``, ``k11_coll_birth`` and
  ``k11_coll_admit`` (not in the default list): K11 at ``chip_smoke.py``'s
  phase-16 shapes (the config-#4 fleet of ``FLEET_B``: state, weights;
  an admission adds its tape row) and phase-18's (the 1,024-rank
  collective fleet of ``COLL_B``: state, tape, DAG-walk rows), one
  birth or one admission of the fresh spec into row 1 from the host's
  payload arrays: the card's ms (``time_call``), the paced ms, the
  bytes bound, the kernels a call by ``torch.profiler``
  (``kernel_counts``) and, on a tree with the fused entries, the kernel
  nodes of one captured call; an admission also times the whole
  ``admit_lane`` as the host paces it (with ``--profile``, the host's
  us a call by function, ``cProfile``).  A parent tree's entries run
  with the uploads its fleet made (its card ms with the payload
  uploaded beforehand, since a pageable upload stalls the queue);
* ``floor`` (not in the default list): what one launch of a trivial
  hand-written kernel reads the same ways (K15's ``probe_double`` over
  256 float64): the floor under a one-launch call's ``ms``;
* ``wall4``, ``wall5`` and ``wall7`` (not in the default list):
  ``chip_smoke.py``'s main paths 4 (the warm-selective 100k churn in
  COO), 5 (the Lazy 320-rank alltoall through the System) and 7 (the
  churn in the card's default layout, ELL): each step's solve ms (host
  clock, as ``run_churn`` and ``run_lazy`` time them), their sum and
  median, the first solve and the build; with ``--profile`` instead the
  churn's steps (mutation and solve) or the alltoall's solve sequence
  under ``torch.profiler`` (``timing.busy_profile``).

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
#: timed graph launches of a ``loop_<case>``
LOOP_REPS = 5
#: rounds of a K7 case that are timed (at most: the solve's own)
K7_ROUNDS = 64


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


def run_coll_fleet(profile: bool = False, pipeline: int = 0) -> dict:
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
        _, row = fleet_run.run_fleet_full(camp, **_depth(pipeline))
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


class _Split:
    """Host clocks around the parts of every fleet superstep inside the
    block (``split10``, ``split11``): the issue (``_reset``'s uploads, the
    graph launch, ``superstep_finish``'s enqueue), the wait in the ``[B,
    ·]`` fetch (a sync ahead of the copy), the copy, and the Python demux
    (``_collect``, its rescues apart).  Wraps the methods of whichever
    executor the checkout has: the issue/collect split where it exists,
    else ``_superstep``/``_finish``/``_collect``."""

    PARTS = ("issue", "wait", "copy", "demux", "rescue")

    def __init__(self):
        self.ms = {p: 0.0 for p in self.PARTS}
        self.n = 0
        self.saved = []

    def _wrap(self, owner, name, fn):
        orig = getattr(owner, name)
        self.saved.append((owner, name, orig))
        setattr(owner, name, fn(orig))

    def __enter__(self):
        import torch
        from simgrid_tpu_torch.ops import lmm_batch, opstats
        cls = lmm_batch.BatchDrainSim
        ms = self.ms

        def clocked(part):
            def wrap(orig):
                def run(*a, **kw):
                    t0 = time.perf_counter()
                    try:
                        return orig(*a, **kw)
                    finally:
                        ms[part] += (time.perf_counter() - t0) * 1e3
                return run
            return wrap

        def fetch(orig):
            def run(t, *a, **kw):
                t0 = time.perf_counter()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out = orig(t, *a, **kw)
                ms["wait"] += (t1 - t0) * 1e3
                ms["copy"] += (time.perf_counter() - t1) * 1e3
                return out
            return run

        def pinned(orig):
            # the copy ran on the stream: the whole call is the wait
            return clocked("wait")(orig)

        def counted(orig):
            def run(*a, **kw):
                self.n += 1
                return orig(*a, **kw)
            return run

        # the split executor's collect holds the wait on the pinned copy
        self.wait_in_collect = hasattr(cls, "_issue")
        if self.wait_in_collect:
            self._wrap(cls, "_issue", clocked("issue"))
            self._wrap(cls, "_issue", counted)
        else:
            # the issue is _reset + the launch + the finish's enqueue: time
            # _superstep whole and take the fetch and the collect out below
            self._wrap(cls, "_superstep", counted)
            self._wrap(cls, "_reset", clocked("issue"))
            from simgrid_tpu_torch.kernels import superstep_loop as k16
            self._wrap(k16.DeviceLoop, "run", clocked("issue"))
            self._wrap(lmm_batch, "superstep_finish", clocked("issue"))
        self._wrap(cls, "_collect", clocked("demux"))
        for name in ("_rescue_superstep", "_rescue_fused"):
            self._wrap(cls, name, clocked("rescue"))
        self._wrap(opstats, "timed_fetch", fetch)
        if hasattr(opstats, "pinned_fetch"):
            self._wrap(opstats, "pinned_fetch", pinned)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self.saved):
            setattr(owner, name, orig)
        return False

    def rec(self) -> dict:
        """Totals and per-superstep means; the demux excludes its
        rescues (whose own supersteps count in their parts)."""
        ms = dict(self.ms)
        ms["demux"] -= ms["rescue"]
        if self.wait_in_collect:
            ms["demux"] -= ms["wait"]
        n = max(self.n, 1)
        return {"split_supersteps": self.n,
                "split_ms": ms,
                "split_ms_per_superstep": {k: v / n for k, v in ms.items()}}


def _depth(pipeline: int) -> dict:
    """The executors' ``pipeline`` argument, left out at depth 0 (a tree
    before the pipelined drains has none)."""
    return {"pipeline": pipeline} if pipeline else {}


def run_split(name: str, pipeline: int = 0) -> dict:
    """Main path 10 or 11's fleet with its supersteps split on the host
    (``split10``, ``split11``; ``_Split``), at ``pipeline`` depth (where
    the fleet's collect waits on the event after its pinned copy, the
    wait is the whole fetch)."""
    import torch
    from simgrid_tpu_torch.workloads import dragonfly, fleet_run
    from simgrid_tpu_torch.workloads.drain_run import EPS
    smoke = main_paths()
    cuda = torch.device("cuda")
    if name == "split11":
        from simgrid_tpu_torch.workloads import collective_fleet as cf
        from simgrid_tpu_torch.workloads import collective_run
        cs = collective_run.CASES[2]
        _, legs, _ = collective_run.run_case(cs, device=cuda)
        t_end = legs["tape"]["events"][-1][0]
        camp = cf.fleet_campaign(cs, cf.fleet_specs(cs, t_end,
                                                    smoke.COLL_B), cuda)
    else:
        dsys = dragonfly.build_system(smoke.FLOWS)
        specs = fleet_run.fleet_specs(smoke.FLOWS, len(dsys.e_var),
                                      smoke.FAULT)
        camp = fleet_run.fleet_campaign(dsys, specs, cuda, smoke.FLEET_K,
                                        dragonfly.link_names(dsys), EPS)
    with _Split() as split:
        _, row = fleet_run.run_fleet_full(camp, **_depth(pipeline))
    keep = ("wall_s", "executor_s", "supersteps", "rescues", "rounds")
    return {**{k: row[k] for k in keep}, **split.rec(),
            "run_s": row["wall_s"] - row["executor_s"]}


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


def run_walls(name: str, profile: bool = False, pipeline: int = 0) -> dict:
    """Main path 1, 3, 8 or 10's wall on the card (module docstring);
    with ``profile`` its run under ``torch.profiler`` (the card's busy
    share) in place of the plain wall."""
    import torch
    from simgrid_tpu_torch.workloads import dragonfly, fault_drain, fleet_run
    from simgrid_tpu_torch.workloads.drain_run import EPS, run_drain
    smoke = main_paths()
    cuda = torch.device("cuda")
    if name == "wall3":
        from simgrid_tpu_torch.workloads.drain_run import run_engine_plan
        a2a = dragonfly.build_alltoall(smoke.RANKS)
        with _Busy(profile) as busy:
            _, row, _ = run_engine_plan(a2a, device=cuda,
                                        max_advances=smoke.PLAN_ADVANCES)
        keep = ("wall_s", "advances", "supersteps", "rounds", "completed")
        return {**{k: row[k] for k in keep if k in row},
                "ranks": smoke.RANKS, "max_advances": smoke.PLAN_ADVANCES,
                **loop_counts(row), **busy.rec}
    dsys = dragonfly.build_system(smoke.FLOWS)
    with _Busy(profile) as busy:
        if name == "wall1":
            _, row = run_drain(dsys, device=cuda, superstep=smoke.K,
                               **_depth(pipeline))
        elif name == "wall8":
            tape = fault_drain.tape_for(
                dsys.e_cnst, dsys.e_w, dsys.c_bound,
                link_names=dragonfly.link_names(dsys), **smoke.FAULT)
            _, row = fault_drain.run_fault_drain(dsys, tape, device=cuda,
                                                 superstep=smoke.K,
                                                 **_depth(pipeline))
        else:
            specs = fleet_run.fleet_specs(smoke.FLOWS, len(dsys.e_var),
                                          smoke.FAULT)
            camp = fleet_run.fleet_campaign(dsys, specs, cuda,
                                            smoke.FLEET_K,
                                            dragonfly.link_names(dsys), EPS)
            _, row = fleet_run.run_fleet_full(camp, **_depth(pipeline))
    keep = ("wall_s", "executor_s", "advances", "supersteps", "rounds",
            "fires", "loop_builds", "spec_issued", "spec_committed",
            "spec_rolled_back")
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


def run_loop_case(name: str) -> dict:
    """K1 inside K16's loop (``loop_<case>``, module docstring)."""
    import torch
    from simgrid_tpu_torch.kernels import superstep_loop as k16
    from simgrid_tpu_torch.kernels.lmm_round import (lmm_init, lmm_round,
                                                     plan_of)
    case = name[len("loop_"):]
    dev = torch.device("cuda")
    s, w, pen, vb, arms, eps = build_case(case, dev)
    rounds = _solve(s, w, pen, vb, arms, eps)
    fat = arms.get("has_fatpipe", False)
    tally = "lmm_round" if w.B is None else "lmm_round_fleet"
    ends = {"ends": True} if "ends" in k16.Loop._fields else {}
    if hasattr(k16, "reset_tally"):
        k16.reset_tally()
    loop = k16.DeviceLoop(
        [k16.Loop(k16.PRED_ROUND, w.ctrl, (lambda: lmm_round(
            s, w, pen, eps, vb, **arms),), cap=rounds, tally=tally,
            **ends)], "chunk" if w.B is None else "chunk_fleet", dev,
        prepare=lambda: plan_of(s, w))
    ms = []
    for rep in range(LOOP_REPS + 1):
        lmm_init(s, w, pen, eps, has_fatpipe=fat)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loop.run()
        b.record()
        torch.cuda.synchronize()
        if rep:                      # the first launch builds the graph
            ms.append(a.elapsed_time(b))
    ctrl = w.ctrl.reshape(-1, w.ctrl.shape[-1]).cpu()
    from simgrid_tpu_torch.kernels.common import IT, LIGHT
    if int(ctrl[:, LIGHT].max()) or int(ctrl[:, IT].max()) != rounds:
        raise AssertionError(f"{name}: the loop did not run the solve's "
                             f"{rounds} rounds")
    ms.sort()
    bodies = k16.bodies() if hasattr(k16, "bodies") else None
    return {"case": name, "V": s.n_v, "C": s.n_c, "B": w.nb,
            "rounds": rounds, "launch_ms": ms,
            "ms": ms[len(ms) // 2] / rounds,
            "ms_spread": [ms[0] / rounds, ms[-1] / rounds],
            "bodies": bodies}


def run_k10(fleet: bool) -> dict:
    """K10's walk when the 1,024-rank schedule's roots complete
    (``k10``, ``k10_fleet``)."""
    import torch
    from simgrid_tpu_torch.kernels import dag_walk as k10
    from simgrid_tpu_torch.kernels.common import ADV_OK, PENDING, T_SUM, Work
    from simgrid_tpu_torch.workloads import collective_run
    t = _timing()
    dev, f64 = torch.device("cuda"), torch.float64
    dc = collective_run.CASES[2].build()
    V = dc.n_v
    B = main_paths().COLL_B if fleet else None
    lead = () if B is None else (B,)
    es, ed, cost = (torch.from_numpy(a.copy()).to(dev) for a in (
        dc.edge_src, dc.edge_dst, dc.exec_cost))
    kw = ({"csr": k10.dag_csr(es, ed, V)} if hasattr(k10, "dag_csr")
          else {})
    pred0 = torch.from_numpy(dc.pred0.copy()).to(dev)
    roots = torch.from_numpy(dc.penalty0 > 0).to(dev)
    w = Work(V, dc.n_c, f64, dev, B=B)
    pred = torch.empty(lead + (V,), dtype=torch.int32, device=dev)
    ready = torch.empty(lead + (V,), dtype=f64, device=dev)
    clock = torch.arange(1, (B or 1) + 1, dtype=f64, device=dev) * 1e-3

    def setup():
        c = w.ctrl.reshape(-1, w.ctrl.shape[-1])
        c[:, ADV_OK] = 1
        c[:, PENDING] = 0
        w.fctrl.reshape(-1, w.fctrl.shape[-1])[:, T_SUM] = clock
        w.done.copy_(roots.expand(lead + (V,)))
        pred.copy_(pred0.expand(lead + (V,)))
        ready.fill_(float("inf"))

    def fn():
        k10.dag_walk(w, es, ed, pred, ready, cost, **kw)
    q = t.time_call(fn, setup)
    setup()
    fn()
    freed = int(w.ctrl.reshape(-1, w.ctrl.shape[-1])[:, PENDING].sum())
    return {"B": w.nb, "V": V, "edges": dc.n_edges, "ms": q["ms"],
            "queued": q["queued"], "paced_ms": t.events_ms(fn, 20, setup),
            "freed": freed, "csr": bool(kw),
            "cuda_launches": t.kernel_counts(fn, setup)}


def host_profile(fn, n: int = 50, top: int = 12) -> dict:
    """The host's seconds a call by function, ``cProfile`` over ``n``
    calls of ``fn`` (then a sync): the ``top`` functions by own time."""
    import cProfile
    import pstats
    import torch
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:top]
    return {f"{os.path.basename(k[0])}:{k[1]}({k[2]})": v[2] / n * 1e6
            for k, v in rows}


def run_k4(vbound: bool, profile: bool = False) -> dict:
    """K4's repack at main path 1's shape, or with the rate bounds at the
    alltoall's (``k4``, ``k4_vbound``); with ``profile``, the card's ms
    per kernel a call and the host's us a call by function."""
    import numpy as np
    import torch
    from simgrid_tpu_torch.kernels.livefirst_repack import livefirst_repack
    from simgrid_tpu_torch.ops.lmm_arrays import to2d
    from simgrid_tpu_torch.ops.lmm_torch import to_device_system
    from simgrid_tpu_torch.workloads import dragonfly
    from simgrid_tpu_torch.workloads.drain_run import (ENGINE_DONE_EPS,
                                                       solve_inputs)
    t = _timing()
    smoke = main_paths()
    dev, f64 = torch.device("cuda"), torch.float64
    if vbound:
        a2a = dragonfly.build_alltoall(smoke.RANKS)
        arr = solve_inputs(a2a)
        V = arr.n_var
        flat = [to2d(x).reshape(-1) for x in (a2a.e_var, a2a.e_cnst,
                                              a2a.e_w)]
        s = to_device_system(flat[0], flat[1], flat[2], arr.c_bound, V,
                             f64, dev)
        live = np.random.default_rng(7).random(V) < 0.45
        args = [torch.from_numpy(live * arr.v_penalty),
                torch.from_numpy(a2a.sizes.copy()),
                torch.full((V,), ENGINE_DONE_EPS, dtype=f64),
                torch.arange(V, dtype=torch.int32),
                torch.from_numpy(arr.v_bound.copy())]
    else:
        dsys = dragonfly.build_system(smoke.FLOWS)
        V = smoke.FLOWS
        flat = [to2d(a).reshape(-1) for a in (dsys.e_var, dsys.e_cnst,
                                              dsys.e_w)]
        s = to_device_system(flat[0], flat[1], flat[2], dsys.c_bound, V,
                             f64, dev)
        rng = np.random.default_rng(7)
        live = rng.random(V) < 0.45
        rem = torch.from_numpy(rng.uniform(1e4, 1e6, V))
        args = [torch.from_numpy(live.astype(np.float64)), rem, 1e-4 * rem,
                torch.arange(V, dtype=torch.int32)]
    args = [a.to(dev) for a in args]
    vb = args[4] if vbound else None
    ev = s.e_var.long()
    live_elems = int(((s.e_w > 0) & (args[0][ev] > 0)).sum())
    vh, eh = V // 2, -(-(s.n_e // 2) // 8) * 8

    def fn():
        return livefirst_repack(s, *args[:4], vh, eh, live_elems, vb)
    out = fn()
    nb = lambda *ts: sum(x.numel() * x.element_size() for x in ts)  # noqa
    n_bytes = (nb(s.e_var, s.e_cnst, s.e_w, *args)
               + nb(*out.sys[:3], *[x for x in out[1:] if x is not None]))
    q = t.time_call(fn)
    kc = t.kernel_counts(fn)
    rec = {"V": V, "E": s.n_e, "nnz": s.csr.nnz, "vh": vh, "eh": eh,
           "live_flows": int(live.sum()), "live_elems": live_elems,
           "ms": q["ms"], "queued": q["queued"],
           "paced_ms": t.events_ms(fn, 10), "cuda_kernels": kc,
           "cuda_launches": sum(kc.values()),
           "bound_ms": t.bound_ms(n_bytes)}
    if profile:
        rec["profile_ms"] = {k: v / 10 for k, v in kernel_profile(
            lambda: [fn() for _ in range(10)]).items()}
        rec["host_us"] = host_profile(fn)
    return rec


def run_repack_cost() -> dict:
    """The whole cost of each repack on main path 1 (``repack_cost``):
    the drain's device repack on the host's clock, split into K4's
    wrapper (host, and card between events around it) and the halved
    ``Work``, and the K16 graph builds that follow it."""
    import torch
    from simgrid_tpu_torch.kernels import superstep_loop as k16
    from simgrid_tpu_torch.ops import lmm_drain
    from simgrid_tpu_torch.workloads import dragonfly
    from simgrid_tpu_torch.workloads.drain_run import run_drain
    smoke = main_paths()
    dsys = dragonfly.build_system(smoke.FLOWS)
    rows: list = []
    builds_before: list = []
    k4_real = lmm_drain.livefirst_repack
    repack_real = lmm_drain.DrainSim._repack_device
    build_real = k16.DeviceLoop._build
    work_real = lmm_drain.Work

    def k4(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        out = k4_real(*a, **kw)
        e1.record()
        e1.synchronize()
        rows[-1]["k4_host_ms"] = (time.perf_counter() - t0) * 1e3
        rows[-1]["k4_card_ms"] = e0.elapsed_time(e1)
        return out

    def work(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = work_real(*a, **kw)
        torch.cuda.synchronize()
        if rows and "work_ms" not in rows[-1]:
            rows[-1]["work_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    def repack(sim, *a, **kw):
        torch.cuda.synchronize()
        rows.append({"n_v": sim.n_v, "builds_ms": []})
        t0 = time.perf_counter()
        ok = repack_real(sim, *a, **kw)
        torch.cuda.synchronize()
        rows[-1]["repack_host_ms"] = (time.perf_counter() - t0) * 1e3
        if not ok:
            rows.pop()
        return ok

    def build(loop):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        build_real(loop)
        torch.cuda.synchronize()
        (rows[-1]["builds_ms"] if rows else builds_before).append(
            (time.perf_counter() - t0) * 1e3)

    lmm_drain.livefirst_repack = k4
    lmm_drain.DrainSim._repack_device = repack
    k16.DeviceLoop._build = build
    lmm_drain.Work = work
    try:
        _, row = run_drain(dsys, device=torch.device("cuda"),
                           superstep=smoke.K)
    finally:
        lmm_drain.livefirst_repack = k4_real
        lmm_drain.DrainSim._repack_device = repack_real
        k16.DeviceLoop._build = build_real
        lmm_drain.Work = work_real
    for r in rows:
        r["total_ms"] = r["repack_host_ms"] + sum(r["builds_ms"])
        r["rest_ms"] = (r["repack_host_ms"] - r.get("k4_host_ms", 0.0)
                        - r.get("work_ms", 0.0))
    return {"wall_s": row["wall_s"], "repacks": len(rows),
            "first_builds_ms": builds_before, "per_repack": rows,
            "repacks_total_ms": sum(r["total_ms"] for r in rows),
            "split_total_ms": {k: sum(r.get(k, 0.0) for r in rows)
                               for k in ("k4_host_ms", "work_ms",
                                         "rest_ms")}
            | {"builds_ms": sum(sum(r["builds_ms"]) for r in rows)}}


#: K7's cases: (FATPIPE share, global order)
K7_CASES = {"k7_bounds": (0.0, False), "k7_fatpipe": (0.10, False),
            "k7_global": (0.0, True)}


def run_k7(name: str, profile: bool = False) -> dict:
    """K7's round arm ``name`` at phase 11(d)'s full shape (module
    docstring); with ``profile``, the card's ms a round by kernel over
    the timed rounds."""
    import numpy as np
    import torch
    from simgrid_tpu_torch.kernels import ell_round as k7
    from simgrid_tpu_torch.kernels import superstep_loop as k16
    from simgrid_tpu_torch.kernels.common import EllWork
    from simgrid_tpu_torch.ops import lmm_ell, lmm_torch
    from simgrid_tpu_torch.workloads import bench_solve
    t = _timing()
    smoke = main_paths()
    dev, f64 = torch.device("cuda"), torch.float64
    eps = smoke.HL_EPS
    fat_share, glob = K7_CASES[name]
    if glob:
        a = bench_solve.build_arrays(np.random.default_rng(42), 2000, 2000,
                                     3, np.float64)
    else:
        hl = smoke.HEADLINE
        a = bench_solve.build_arrays(np.random.default_rng(hl["seed"]),
                                     hl["n_c"], hl["n_v"], hl["deg"],
                                     np.float64)
        rates = lmm_torch.solve_arrays(a, eps, device=dev)[0]
        rng = np.random.default_rng(11)
        vb = a.v_bound.copy()
        sel = np.zeros(len(vb), bool)
        sel[:a.n_var] = rng.random(a.n_var) < 0.3
        vb[sel] = rates[sel] * rng.uniform(0.5, 1.5, int(sel.sum()))
        a = a._replace(v_bound=vb)
    if fat_share:
        f = a.c_fatpipe.copy()
        f[:a.n_cnst] = np.random.default_rng(12).random(a.n_cnst) \
            < fat_share
        a = a._replace(c_fatpipe=f)
    full_r = lmm_torch.solve_arrays(a, eps, device=dev,
                                    parallel_rounds=not glob, layout="ell",
                                    chain="off")[3]
    rounds = min(full_r, K7_ROUNDS)
    s, pen, vb = lmm_ell.dense_system(lmm_ell.ell_from_arrays(a), dev)
    w = EllWork(s.n_v, s.n_c, s.wc, f64, dev)
    fat = bool(a.c_fatpipe.any())
    prep = getattr(k7, "ell_prep", None)

    def init():
        k7.ell_init(s, w, pen, eps, vb)
        if prep is not None:
            prep(s, w, pen, vb)

    def rnd():
        k7.ell_round(s, w, pen, eps, vb, fat, glob)
    rec = {"case": name, "V": s.n_v, "C": s.n_c, "Wc": s.wc, "Wv": s.wv,
           "full_rounds": full_r, **t.time_rounds(init, rnd, rounds)}
    # inside K16's loop: the solve's chunk loop, capped at the rounds
    k16.reset_tally()
    loop = lmm_torch.chunk_loop(s, w, pen, eps, vb, True, fat, glob,
                                rounds)
    ms = []
    for rep in range(LOOP_REPS + 1):
        k7.ell_init(s, w, pen, eps, vb)
        a_ = torch.cuda.Event(enable_timing=True)
        b_ = torch.cuda.Event(enable_timing=True)
        a_.record()
        loop.run()
        b_.record()
        torch.cuda.synchronize()
        if rep:
            ms.append(a_.elapsed_time(b_))
    ms.sort()
    rec.update(loop_launch_ms=ms, loop_ms=ms[len(ms) // 2] / rounds,
               loop_ms_spread=[ms[0] / rounds, ms[-1] / rounds],
               bodies=[b for b in k16.bodies()
                       if b["tally"] == "ell_round"])
    if profile:
        init()
        rec["profile_ms_per_round"] = {
            k: v / rounds for k, v in kernel_profile(
                lambda: [rnd() for _ in range(rounds)]).items()}
    return rec


def run_k16_first() -> dict:
    """K16's first superstep on the card (``k16_first``)."""
    import torch
    from simgrid_tpu_torch.workloads import dragonfly, drain_run
    smoke = main_paths()
    dsys = dragonfly.build_system(smoke.FLOWS)
    sim = drain_run.make_sim(dsys, device=torch.device("cuda"),
                             superstep=smoke.K)
    spans = []
    with smoke.replayed_graph("superstep", smoke.K16_REPS, spans):
        sim.superstep_batch(k=4)
    ms = sorted(a.elapsed_time(b) for a, b in spans)
    return {"ms": ms[len(ms) // 2], "ms_spread": [ms[0], ms[-1]],
            "rounds": sim.rounds, "advances": sim.advances}


#: K5's and K6's cases (module docstring)
K56_CASES = ("k5", "k5_delta", "k5_ell", "k6", "k6_ell", "k6_one",
             "k6_ell_one")
#: the warm-selective churn's System by layout, kept across cases
_CHURN: dict = {}


def churn_system(layout: str, profile: bool = False):
    """Main path 4 (``layout="coo"``) or 7 (``"auto"``: ELL on the card):
    ``chip_smoke.py``'s warm-selective churn on the card, strict.
    Returns ``(system, row)``; with ``profile`` the row is the steps'
    ``busy_profile``.  The System is kept for K5's and K6's cases."""
    import numpy as np
    import torch
    from simgrid_tpu_torch.ops.lmm_host import LmmFlags, make_new_maxmin_system
    from simgrid_tpu_torch.ops.lmm_torch import install
    from simgrid_tpu_torch.workloads import churn
    cfg = main_paths().CHURN
    cuda = torch.device("cuda")
    if not profile:
        s, row = churn.run_churn("warm-selective", device=cuda, strict=True,
                                 layout=layout, **cfg)
        _CHURN[layout] = s
        return s, row
    warm_start, delta_upload = churn.MODES["warm-selective"]
    s = make_new_maxmin_system(True, LmmFlags(
        backend="torch", warm_start=warm_start, delta_upload=delta_upload,
        strict=True, layout=layout))
    install(s, device=cuda)
    rng = np.random.default_rng(cfg["seed"])
    cs, flows = churn.build(s, rng, cfg["n_v"], cfg["clusters"],
                            cfg["chain"])
    s.solve()
    n = max(1, int((cfg["n_v"] - (cfg["chain"] - 1)) * cfg["churn"]))

    def steps():
        for _ in range(cfg["steps"]):
            churn.churn_step(s, rng, cs, flows, n)
            s.solve()
    row = _timing().busy_profile(steps)
    row.pop("result")
    _CHURN[layout] = s
    return s, row


def run_wall_warm(name: str, profile: bool = False) -> dict:
    """Main path 4, 5 or 7's wall (``wall4``, ``wall5``, ``wall7``)."""
    import numpy as np
    import torch
    from simgrid_tpu_torch.ops.lmm_host import LmmFlags, make_new_maxmin_system
    from simgrid_tpu_torch.ops.lmm_torch import install
    from simgrid_tpu_torch.workloads import lazy_alltoall as lz
    ranks = main_paths().RANKS
    strict = LmmFlags(backend="torch", strict=True)
    if name == "wall5" and profile:
        a2a = lz.alltoall(ranks)
        s = make_new_maxmin_system(True, strict)
        install(s, device=torch.device("cuda"))
        cnsts, variables = lz.build(s, a2a)
        rec = _timing().busy_profile(
            lambda: list(lz.solve_sequence(s, a2a, cnsts, variables, 0)))
        rec.pop("result")
        return {"ranks": ranks, **rec}
    if name == "wall5":
        _, row = lz.run_lazy(ranks, device=torch.device("cuda"),
                             flags=strict)
        ms = [r["ms"] for r in row["solves"]]
        modes = [r["mode"] for r in row["solves"]]
        return {"ranks": ranks, "build_s": row["build_s"],
                "solves": len(ms), "warm_solves": modes.count("warm"),
                "solve_ms_sum": float(np.sum(ms)),
                "solve_ms_med": float(np.median(ms)),
                "solver_fallbacks": row["solver_fallbacks"],
                "launches": {k: row["launches"].get(k, 0) for k in (
                    "delta_scatter", "warm_init", "lmm_round_bounds")}}
    layout = "coo" if name == "wall4" else "auto"
    _, row = churn_system(layout, profile)
    if profile:
        return {"layout": layout, **row}
    keep = ("build_s", "first_solve_ms", "solve_ms", "solve_ms_med",
            "rounds", "warm_solves", "last_layout", "warm_ell_fallbacks",
            "solver_fallbacks")
    return {"layout": layout, **{k: row[k] for k in keep if k in row},
            "solve_ms_sum": float(sum(row["solve_ms"])),
            "launches": {k: v for k, v in row["launches"].items()
                         if k.startswith(("delta_scatter", "warm_init"))}}


def sorted_index(mc):
    """A modified-constraint index, sorted and padded to
    ``bucket(n, floor=8)`` by repeating its last entry."""
    import numpy as np
    from simgrid_tpu_torch.ops.lmm_arrays import bucket
    mc = np.sort(np.asarray(mc, np.int64))
    out = np.full(bucket(len(mc), floor=8), mc[-1], np.int32)
    out[:len(mc)] = mc
    return out


def k6_index(mc_g):
    """K6's index as the tree's wrapper takes it: on the host where the
    wrapper checks its order there (``warm_init.host_index``), else the
    device copy."""
    from simgrid_tpu_torch.kernels import warm_init
    return mc_g.cpu().numpy() if hasattr(warm_init, "host_index") else mc_g


def padded(ix, vals, floor=8):
    """One run padded as the warm solver pads it (the first pair)."""
    import numpy as np
    from simgrid_tpu_torch.ops.lmm_arrays import bucket
    n = bucket(len(ix), floor=floor)
    pi, pv = np.full(n, float(ix[0])), np.full(n, float(vals[0]))
    pi[:len(ix)], pv[:len(ix)] = ix, vals
    return pi, pv


def run_k56(name: str, profile: bool = False) -> dict:
    """One of K5's or K6's cases (module docstring)."""
    import numpy as np
    import torch
    from simgrid_tpu_torch.kernels import superstep_loop as k16
    from simgrid_tpu_torch.kernels.common import EllWork, Work
    from simgrid_tpu_torch.kernels.transition_scatter import (
        ELL_POSITIVE, delta_scatter, ell_delta_scatter, transition_scatter,
        transition_scatter_plain)
    from simgrid_tpu_torch.kernels.warm_init import (
        warm_init, warm_init_ell, warm_init_ell_plain, warm_init_plain)
    from simgrid_tpu_torch.workloads.drain_run import EPS
    t = _timing()
    smoke = main_paths()
    cuda, f64 = torch.device("cuda"), torch.float64
    nb = lambda *ts: sum(x.numel() * x.element_size()  # noqa: E731
                         for x in ts)
    rec = {"case": name}
    setup = plain = library = None
    if name == "k5":
        from simgrid_tpu_torch.ops.lmm_arrays import to2d
        from simgrid_tpu_torch.workloads import dragonfly
        from simgrid_tpu_torch.workloads.drain_run import (ENGINE_DONE_EPS,
                                                           solve_inputs)
        a2a = dragonfly.build_alltoall(smoke.RANKS)
        arr = solve_inputs(a2a)
        V2, C2 = arr.n_var, arr.n_cnst
        rng = np.random.default_rng(5)
        bsl = np.sort(rng.choice(V2, V2 // 100, replace=False))
        csl = np.sort(rng.choice(C2, C2 // 100, replace=False))
        lsl = np.sort(rng.choice(V2, V2 // 100, replace=False))
        runs = [(7, bsl, arr.v_bound[bsl] * rng.uniform(0.5, 1.5, len(bsl))),
                (3, csl, arr.c_bound[csl] * rng.uniform(0.5, 1.0, len(csl))),
                (4, lsl, arr.v_penalty[lsl])]
        layout, chunks, off = [], [], 0
        for ti, ix, vals in runs:
            layout.append((ti, off, len(ix)))
            chunks += [ix.astype(np.float64), vals]
            off += 2 * len(ix)
        flat = [to2d(x).reshape(-1) for x in (a2a.e_var, a2a.e_cnst,
                                              a2a.e_w)]
        base = [flat[0], flat[1], flat[2], arr.c_bound, arr.v_penalty,
                a2a.sizes, np.full(V2, ENGINE_DONE_EPS), arr.v_bound]
        targets = [torch.from_numpy(np.array(b)).to(cuda) for b in base]
        payload = torch.from_numpy(np.concatenate(chunks)).to(cuda)
        slots = sum(n for _, _, n in layout)
        n_bytes = 24 * slots

        def fn():
            transition_scatter(payload, layout, targets)

        def plain():
            transition_scatter_plain(payload, layout, targets)
        positive = ()
    elif name in ("k5_delta", "k6", "k6_one"):
        s = _CHURN.get("coo") or churn_system("coo")[0]
        st = s.warm_solver._states[np.dtype(np.float64)]
        E9, C9, V9 = st.shapes
        rng = np.random.default_rng(9)
        if name == "k5_delta":
            host = [m.cpu().numpy() for m in st.masters]
            layout, chunks, off = [], [], 0
            for ti, hi, n in ((0, E9, 3000), (1, E9, 3000), (2, E9, 3000),
                              (4, C9, 600), (5, V9, 2000), (6, V9, 1000)):
                n = min(n, hi // 2)
                ix = np.sort(rng.choice(hi, n, replace=False))
                vals = host[ti][ix].astype(np.float64)
                if ti == 4:
                    vals = np.where(rng.random(n) < 0.5, 1.0 - vals, vals)
                pi, pv = padded(ix, vals)
                layout.append((ti, off, len(pi)))
                chunks += [pi, pv]
                off += 2 * len(pi)
            targets = [m.clone() for m in st.masters]
            payload = torch.from_numpy(np.concatenate(chunks)).to(cuda)
            slots = sum(n for _, _, n in layout)
            n_bytes = 16 * slots + sum(n * targets[ti].element_size()
                                       for ti, _, n in layout)

            def fn():
                delta_scatter(payload, layout, targets)

            def plain():
                transition_scatter_plain(payload, layout, targets)
            positive = ()
        else:
            mc = np.unique(smoke.CHURN["chain"] + rng.integers(
                0, smoke.CHURN["clusters"], 999 if name == "k6" else 1))
            mc_g = torch.from_numpy(sorted_index(mc)).to(cuda)
            mc_arg = k6_index(mc_g)
            carry = {n: getattr(st.work, n).clone()
                     for n in ("v_value", "remaining", "usage")}
            w = Work(V9, C9, f64, cuda)
            pen = st.masters[5]

            def setup():
                for n, x in carry.items():
                    getattr(w, n).copy_(x)

            def fn():
                warm_init(st.sys, w, pen, mc_arg, EPS)

            def plain():
                warm_init_plain(st.sys, w, pen, mc_g, EPS)
            sy = st.sys
            n_bytes = (nb(sy.e_var, sy.e_cnst, sy.e_w, sy.c_bound,
                          sy.c_fatpipe, pen, mc_g)
                       + 2 * nb(*carry.values()) + nb(w.v_fixed, w.light))
            rec["modified_constraints"] = len(mc)
    else:
        s = _CHURN.get("auto") or churn_system("auto")[0]
        st = s.warm_solver._states[np.dtype(np.float64)]
        e, pen = st.ell, st.masters[5]
        n_c, wc, n_v, wv = st.ell_shape
        rng = np.random.default_rng(9)
        mc = np.unique(smoke.CHURN["chain"] + rng.integers(
            0, smoke.CHURN["clusters"], 1 if name == "k6_ell_one" else 999))
        if name.startswith("k6"):
            mc_g = torch.from_numpy(sorted_index(mc)).to(cuda)
            mc_arg = k6_index(mc_g)
            carry = {n: getattr(st.ell_work, n).clone()
                     for n in ("v_value", "remaining", "usage", "cv_live")}
            w = EllWork(n_v, n_c, wc, f64, cuda)

            def setup():
                for n, x in carry.items():
                    getattr(w, n).copy_(x)

            def fn():
                warm_init_ell(e, w, pen, mc_arg, EPS)

            def plain():
                warm_init_ell_plain(e, w, pen, mc_g, EPS)
            n_bytes = (nb(e.cv_var, e.cv_w, e.cv_valid, e.c_bound,
                          e.c_fatpipe, pen, mc_g)
                       + 2 * nb(*carry.values()) + nb(w.v_fixed, w.light))
            rec["modified_constraints"] = len(mc)
        else:
            tabs = (e.cv_var, e.cv_w, e.cv_valid, e.vc_cnst, e.vc_valid,
                    e.vc_w)
            host = [x.cpu().numpy() for x in tabs]
            k = 999
            cv_ix = np.sort(rng.choice(n_c * wc, k, replace=False))
            vc_ix = np.sort(rng.choice(n_v * wv, k, replace=False))
            chunks = []
            for ti, ix in ((0, cv_ix), (1, cv_ix), (2, cv_ix), (3, vc_ix),
                           (4, vc_ix), (5, vc_ix)):
                src = host[{2: 1, 4: 5}.get(ti, ti)].reshape(-1)[ix]
                chunks += list(padded(ix, src.astype(np.float64)))
            n12 = len(chunks[0])
            layout = [(ti, 2 * n12 * ti, n12) for ti in range(6)]
            targets = [x.clone() for x in tabs]
            payload = torch.from_numpy(np.concatenate(chunks)).to(cuda)
            slots = 6 * n12
            n_bytes = 16 * slots + sum(n12 * x.element_size()
                                       for x in targets)

            def fn():
                ell_delta_scatter(payload, layout, targets)

            def plain():
                transition_scatter_plain(payload, layout, targets,
                                         ELL_POSITIVE)
            positive = ELL_POSITIVE
    if name.startswith("k5"):
        def library():
            for ti, o, n in layout:
                v = payload[o + n:o + 2 * n]
                targets[ti].view(-1).index_put_(
                    (payload[o:o + n].long(),),
                    v > 0 if ti in positive else v.to(targets[ti].dtype))
        rec["slots"] = slots
    if setup is not None:
        setup()
    fn()
    torch.cuda.synchronize()
    q = t.time_call(fn, setup)
    rec.update(ms=q["ms"], queued=q["queued"],
               paced_ms=t.events_ms(fn, 20, setup),
               plain_ms=t.events_ms(plain, 5, setup),
               cuda_launches=k16.kernel_nodes(fn),
               bound_ms=t.bound_ms(n_bytes))
    if library is not None:
        ql = t.time_call(library)
        rec.update(library_ms=ql["ms"], library_queued=ql["queued"],
                   library_paced_ms=t.events_ms(library, 20))
    if profile:
        rec["profile_ms"] = {k: v / 10 for k, v in kernel_profile(
            lambda: [(setup and setup(), fn()) for _ in range(10)]).items()}
    return rec


K11_CASES = ("k11_birth", "k11_admit", "k11_coll_birth", "k11_coll_admit")


def run_k11(name: str, profile: bool = False) -> dict:
    """One of K11's cases (module docstring), on this tree's entries or
    on a parent's (``materialize`` with ``materialize_ew`` and
    ``materialize_coll``, ``admit_state`` with ``admit_tape``,
    ``admit_coll`` and ``admit_ew``, each payload array uploaded as the
    parent's fleet uploaded it)."""
    import numpy as np
    import torch
    from simgrid_tpu_torch.kernels import fleet_materialize as k11
    from simgrid_tpu_torch.kernels import superstep_loop as k16
    from simgrid_tpu_torch.ops.lmm_batch import (_pack_elem_w,
                                                 _pack_overrides,
                                                 _pow2_bucket)
    from simgrid_tpu_torch.parallel.campaign import ScenarioSpec
    t = _timing()
    smoke = main_paths()
    cuda = torch.device("cuda")
    fused = hasattr(k11, "admit")
    coll = name.startswith("k11_coll")
    if coll:
        from simgrid_tpu_torch.workloads import collective_fleet as cf
        from simgrid_tpu_torch.workloads import collective_run
        cs = collective_run.CASES[2]
        _, legs, _ = collective_run.run_case(cs, device=cuda)
        specs = cf.fleet_specs(cs, legs["tape"]["events"][-1][0],
                               smoke.COLL_B)
        plan = cf.fleet_campaign(cs, specs, cuda).plan
        extra = dict(collective=cs)
    else:
        from simgrid_tpu_torch.workloads import dragonfly, fleet_run
        from simgrid_tpu_torch.workloads.drain_run import EPS
        dsys = dragonfly.build_system(smoke.FLOWS)
        specs = fleet_run.fleet_specs(smoke.FLOWS, len(dsys.e_var),
                                      smoke.FAULT)
        plan = fleet_run.fleet_campaign(dsys, specs, cuda, smoke.FLEET_K,
                                        dragonfly.link_names(dsys),
                                        EPS).plan
        extra = {}
    fresh = ScenarioSpec(seed=50, bw_scale=1.15, size_scale=0.95,
                         label="admitted", **extra)
    g = plan.executor(specs)
    rel = g.done_mode == "rel"
    nb = lambda *ts: sum(x.numel() * x.element_size()  # noqa: E731
                         for x in ts)
    put = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(cuda)
    outs = [torch.empty_like(x) for x in (g.sys.c_bound, g._pen, g._rem,
                                          g._thresh)]
    ew_out = torch.empty_like(g.sys.e_w) if g.batch_w else None
    cl = [torch.empty_like(x) for x in g._coll] if coll else None
    ovs = list(g.overrides)
    pay = _pack_overrides(ovs, g.n_c, g.n_v)
    ei, ewv = _pack_elem_w(ovs, g.sys.n_e, g.dtype)
    ov = plan.overrides_for(fresh)
    tape = plan.tape_for(fresh)
    pay1 = _pack_overrides([ov], g.n_c, g.n_v, tuple(_pow2_bucket(len(x))
                           for x in (ov.link_scale, ov.flow_scale,
                                     ov.dead_flows)))
    ei1, ewv1 = _pack_elem_w([ov], g.sys.n_e, g.dtype,
                             _pow2_bucket(len(ov.elem_w)))
    # the admitted tape: its entries (this tree pads them on the card),
    # or the padded row (a parent tree's upload)
    rows = ()
    if g.has_tape:
        n = 0 if tape is None else len(tape[0])
        entries = (np.asarray(tape[0], np.float64) if n else np.zeros(0),
                   np.asarray(tape[1], np.int32) if n else np.zeros(
                       0, np.int32),
                   (np.asarray(tape[2], np.float64) if n else np.zeros(0)
                    ).astype(g.dtype))
        T = g._tape_width
        rows = entries if fused else tuple(
            np.concatenate([x, np.full(T - n, pad, x.dtype)])
            for x, pad in zip(entries, (np.inf, g.n_c, 0)))
    if fused:
        def birth():
            k11.materialize(g._base_dev, pay, outs, g.done_eps, rel,
                            ew=(g._base_ew, ew_out, ei, ewv)
                            if g.batch_w else None,
                            coll=(cl, g._coll_base) if coll else None)

        def admit():
            k11.admit(g._base_dev, pay1, outs, 1, g.done_eps, rel,
                      ew=(g._base_ew, ew_out, ei1, ewv1)
                      if g.batch_w else None,
                      tape=(g._tape, rows) if g.has_tape else None,
                      coll=(cl, g._coll_base) if coll else None)
        card = {}
    else:
        def birth(up=put):
            if g.batch_w:
                k11.materialize_ew(g._base_ew, ew_out, up(ei), up(ewv))
            k11.materialize(g._base_dev, [up(a) for a in pay], outs,
                            g.done_eps, rel)
            if coll:
                k11.materialize_coll(cl, g._coll_base)

        def admit(up=put):
            k11.admit_state(g._base_dev, [up(a) for a in pay1], outs, 1,
                            g.done_eps, rel)
            if g.has_tape:
                k11.admit_tape(g._tape, 1, [up(a) for a in rows])
            if coll:
                k11.admit_coll(cl, 1, g._coll_base)
            if g.batch_w:
                k11.admit_ew(g._base_ew, ew_out, up(ei1), up(ewv1), 1)
        # the card's time with the payload already on the card (each
        # pageable upload would stall the queue behind the sleep)
        kept = {id(a): put(a) for a in (*pay, ei, ewv, *pay1, ei1, ewv1,
                                        *rows)}
        card = {birth: lambda: birth(lambda a: kept[id(a)]),
                admit: lambda: admit(lambda a: kept[id(a)])}
    is_birth = name.endswith("birth")
    fn = birth if is_birth else admit
    base_b = nb(*g._base_dev) + (nb(g._base_ew) if g.batch_w else 0)
    if is_birth:
        n_bytes = (base_b + sum(a.nbytes for a in pay)
                   + (ei.nbytes + ewv.nbytes if g.batch_w else 0)
                   + nb(*outs) + (nb(ew_out) if g.batch_w else 0)
                   + (nb(*g._coll_base, *cl) if coll else 0))
    else:
        n_bytes = (base_b + sum(a.nbytes for a in pay1)
                   + (ei1.nbytes + ewv1.nbytes if g.batch_w else 0)
                   + sum(nb(x[1]) for x in outs)
                   + (nb(ew_out[1]) if g.batch_w else 0)
                   + sum(a.nbytes for a in rows)
                   + (nb(*(x[1] for x in g._tape)) if g.has_tape else 0)
                   + (2 * nb(*g._coll_base) + 16 if coll else 0))
    birth()
    admit()
    torch.cuda.synchronize()
    q = t.time_call(card.get(fn, fn))
    rec = {"case": name, "tree": "fused" if fused else "parent",
           "B": g.B, "C": g.n_c, "V": g.n_v, "E": g.sys.n_e,
           "batch_w": g.batch_w, "tape_width": g._tape_width,
           "ms": q["ms"], "queued": q["queued"],
           "paced_ms": t.events_ms(fn, 20), "bound_ms": t.bound_ms(n_bytes),
           "bytes": n_bytes}
    try:
        rec["kernels_profiled"] = t.kernel_counts(fn)
    except Exception as e:  # noqa: BLE001 (recorded, not fatal)
        rec["kernels_profiled"] = repr(e)
    if fused:
        rec["cuda_launches"] = k16.kernel_nodes(fn)
    if not is_birth:
        def lane_setup():
            if g._alive[1]:
                g.retire(1)

        def lane():
            g.admit_lane(1, ov, tape)
        rec["admit_lane_paced_ms"] = t.events_ms(lane, 20, lane_setup)
        if profile:
            rec["admit_lane_host_us"] = host_profile(
                lambda: (lane_setup(), lane()))
    if profile:
        rec["host_us"] = host_profile(fn)
    return rec


def _timing():
    """This checkout's ``probes/timing.py``, loaded from its file: the
    package that ``--root`` imports may predate ``time_rounds``."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "timing.py")
    spec = importlib.util.spec_from_file_location("k1_rounds_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_case(name: str, profile: bool = False, pipeline: int = 0) -> dict:
    import torch
    from simgrid_tpu_torch.kernels.lmm_round import lmm_init, lmm_round
    if name in ("sweep", "sweep8"):
        return {"case": name, **run_sweep_walls(
            (8,) if name == "sweep8" else (1, 8, 64))}
    if name == "coll1024":
        return {"case": name, "pipeline": pipeline,
                **run_coll_fleet(profile, pipeline)}
    if name in ("split10", "split11"):
        return {"case": name, "pipeline": pipeline,
                **run_split(name, pipeline)}
    if name in K23_CASES:
        return run_k23(name)
    if name in ("k10", "k10_fleet"):
        return {"case": name, **run_k10(name == "k10_fleet")}
    if name == "k16_first":
        return {"case": name, **run_k16_first()}
    if name in K56_CASES:
        return run_k56(name, profile)
    if name in K11_CASES:
        return run_k11(name, profile)
    if name == "floor":
        from simgrid_tpu_torch.kernels import superstep_loop as k16
        from simgrid_tpu_torch.kernels.probe_loop import probe_double
        x = torch.ones(256, dtype=torch.float64, device="cuda")
        t = _timing()
        q = t.time_call(lambda: probe_double(x))
        return {"case": name, "ms": q["ms"], "queued": q["queued"],
                "paced_ms": t.events_ms(lambda: probe_double(x), 20),
                "cuda_launches": k16.kernel_nodes(lambda: probe_double(x))}
    if name in ("wall4", "wall5", "wall7"):
        return {"case": name, **run_wall_warm(name, profile)}
    if name in ("k4", "k4_vbound"):
        return {"case": name, **run_k4(name == "k4_vbound", profile)}
    if name == "repack_cost":
        return {"case": name, **run_repack_cost()}
    if name in K7_CASES:
        return run_k7(name, profile)
    if name.startswith("loop_"):
        return run_loop_case(name)
    if name in ("wall1", "wall3", "wall8", "wall10"):
        return {"case": name, "pipeline": pipeline,
                **run_walls(name, profile, pipeline)}
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
    ap.add_argument("--pipeline", type=int, default=0,
                    help="pipeline depth of the wall and split cases")
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
               **run_case(name, args.profile, args.pipeline)}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
