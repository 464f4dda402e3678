"""K8's rounds and K9's stages on the card, and the walls around them.

    python simgrid_tpu_torch/probes/vc_chain.py [--root DIR] [--out PATH]
        [--cases k8_stage,k8_dense,k9,headline,headline_busy,churn,
                 churn_profile]

``bench.py``'s headline system (``chip_smoke.py``'s ``HEADLINE``, main
path 6) and its ELL churn (main path 7), on the checkout ``--root``
imports (a parent commit unpacked under ``build/`` times the parent's
kernels in the same call; the timing helpers are always this
checkout's ``probes/timing.py``).  The cases:

* ``k8_stage``: K8's rounds over the chain's first stage (131,072 rows
  x 4, 16,384 constraints) from its init, as many as the stage's guard
  lets run; ``k8_dense``: the same over the dense path's table from
  K7's init to convergence.  Each gives the card's ms a round with the
  rounds queued behind a sleep (``ms``, ``time_rounds``), as the host
  paces them (``paced_ms``), inside K16's loop as the chain runs them
  (``graph_ms``: one graph launch of the stage's loop, queued behind a
  sleep, over its rounds), and ``torch.profiler``'s ms a round by
  kernel name over one graph launch (the passes, and ``loop_cond``
  where the loop still has one);
* ``k9``: one stage, 131,072 rows to 65,536, from the state the
  stage's rounds leave, each call from the same restored state
  (``time_call``: card-queued ``ms``), with the CUDA kernels one call
  launches; on a tree whose stage does not arm the next loop itself,
  ``with_arm`` times the stage and that arm together;
* ``headline``: the first solve's ms and the median of 9 more (host
  clock, each ending in its fetch), the graphs built and the host calls
  of K8's and K9's wrappers per solve after the first where the tree
  reports them;
* ``headline_busy``: 10 solves after one under ``timing.busy_profile``:
  the card's busy ms a solve, the profiled wall a solve and the share;
* ``churn``: main path 7, ``bench.py``'s churn at 100,000 flows under
  the card's default layout (ELL) in its four modes: each mode's build,
  first solve, per-step solves and their median (host clock), the
  seconds Python's garbage collector took in the build (everything
  before the first solve), the first solve and the steps, by
  generation, and the graphs K16 built in the first solve;
* ``churn_profile``: the first solve of cold-delta and warm-selective
  under ``cProfile`` (the functions with the most cumulative time).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

CASES = ("k8_stage", "k8_dense", "k9", "headline", "headline_busy",
         "churn", "churn_profile")
#: per-stage round cap of the chain (``ops/lmm_ell._CHAIN_STAGE_CAP``)
CAP = 64


def _timing():
    """This checkout's ``probes/timing.py``, loaded from its file."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "timing.py")
    spec = importlib.util.spec_from_file_location("vc_chain_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke():
    """The checkout's ``chip_smoke.py`` constants (HEADLINE, HL_EPS,
    CHURN)."""
    import chip_smoke
    return chip_smoke


def _profile_ms(fn, setup, per: int) -> dict:
    """``torch.profiler``'s card ms by kernel name over one ``fn()``
    after ``setup()``, divided by ``per``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    setup()
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
            "(anonymous namespace)::", "").split("(")[0].split("<")[0]
        if t and name and not name.startswith(
                ("cuda", "aten", "at::", "Memcpy", "Memset")):
            out[name] = out.get(name, 0.0) + t / 1e3 / max(per, 1)
    return out


class Chain:
    """The headline's chain at its first stage on the card, on either
    tree's API (``new``: K8's prep and K9's arming stage)."""

    def __init__(self):
        import numpy as np
        import torch
        from simgrid_tpu_torch.kernels import ell_chain as k9
        from simgrid_tpu_torch.kernels import vc_round as k8
        from simgrid_tpu_torch.kernels.common import Work
        from simgrid_tpu_torch.ops import lmm_ell
        from simgrid_tpu_torch.workloads import bench_solve
        sm = _smoke()
        self.np, self.torch, self.k8, self.k9 = np, torch, k8, k9
        self.lmm_ell, self.eps = lmm_ell, sm.HL_EPS
        self.new = hasattr(k8, "vc_prep")
        self.dev = torch.device("cuda")
        hl = bench_solve.build_arrays(np.random.default_rng(
            sm.HEADLINE["seed"]), sm.HEADLINE["n_c"], sm.HEADLINE["n_v"],
            sm.HEADLINE["deg"], np.float64)
        self.arrays = hl
        self.ell = lmm_ell.ell_from_arrays(hl)
        e = self.ell
        self.sys, self.pen = lmm_ell.device_args(
            "vc_chain", [e.vc_cnst, e.vc_w, e.vc_valid, e.v_penalty,
                         e.c_bound, e.c_fatpipe], self.dev,
            make=lmm_ell._chain_tables)
        self.init_t = lmm_ell.device_args(
            "vc_chain_init", lmm_ell.chain_init(e, self.eps, False),
            self.dev)
        self.half = self.sys.n_v // 2
        self.w = Work(self.sys.n_v, self.sys.n_c, torch.float64, self.dev)
        self.vv0, self.vf0 = self.w.v_value, self.w.v_fixed
        self.cs = k9.ChainState(self.sys, self.pen, self.init_t[5], self.w)

    def rnd(self):
        self.k8.vc_round(self.cs.sys, self.w, self.cs.pen, self.eps, False)

    def _fresh(self):
        w = self.w
        w.v_value, w.v_fixed = self.vv0, self.vf0
        if self.new:
            self.cs.reset(self.sys, self.pen, self.init_t[5])
        else:
            self.cs = self.k9.ChainState(self.sys, self.pen,
                                         self.init_t[5], w)

    def init(self):
        """The chain's start, armed for its first stage."""
        self._fresh()
        w = self.w
        for t, src in zip((w.v_value, w.v_fixed, w.remaining, w.usage,
                           w.light), self.init_t[:5]):
            t.copy_(src)
        if self.new:
            self.k8.vc_prep(self.cs.sys, w, self.cs.pen)
            self.k9.chain_arm(self.cs, CAP, self.half, True)
        else:
            self.k9.chain_arm(self.cs, -1, -1, first=True)
            self.k9.chain_arm(self.cs, CAP, self.half)

    def stage_rounds(self) -> int:
        """The rounds the first stage's guard lets run."""
        from simgrid_tpu_torch.kernels.common import IT
        self.init()
        for _ in range(CAP):
            self.rnd()
        return int(self.w.ctrl[IT])

    def snapshot(self) -> dict:
        w = self.w
        return {n: getattr(w, n).clone() for n in (
            "v_value", "v_fixed", "remaining", "usage", "light", "ctrl",
            "rou")}

    def restore(self, snap: dict) -> None:
        self._fresh()
        for n, t in snap.items():
            getattr(self.w, n).copy_(t)

    def stage(self, arm: bool = True):
        if self.new:
            self.k9.chain_stage(self.cs, self.half,
                                (CAP, self.half // 2) if arm else None)
        else:
            self.k9.chain_stage(self.cs, self.half)
            if arm:
                self.k9.chain_arm(self.cs, CAP, self.half // 2)


def _loop(new: bool, ctrl, body, cap: int = 0):
    """K16's loop of ``body`` rounds as the tree's chain builds it."""
    from simgrid_tpu_torch.kernels.superstep_loop import (PRED_VC_ROUND,
                                                          Loop)
    kw = {"ends": True} if "ends" in Loop._fields and new else {}
    return Loop(PRED_VC_ROUND, ctrl, (body,), cap=cap, tally="vc_round",
                **kw)


def round_case(name: str) -> dict:
    import torch
    from simgrid_tpu_torch.kernels.superstep_loop import DeviceLoop
    tm = _timing()
    ch = Chain()
    if name == "k8_stage":
        rounds = ch.stage_rounds()
        init, rnd, new = ch.init, ch.rnd, ch.new
        ctrl, shape = ch.w.ctrl, (ch.sys.n_v, ch.sys.wv, ch.sys.n_c)
    else:
        from simgrid_tpu_torch.kernels.common import IT, EllWork
        from simgrid_tpu_torch.kernels.ell_round import ell_init
        sys_, pen, vb = ch.lmm_ell.dense_system(ch.ell, ch.dev)
        w = EllWork(sys_.n_v, sys_.n_c, sys_.wc, torch.float64, ch.dev)
        new = ch.new

        def init():
            ell_init(sys_, w, pen, ch.eps, vb)
            if new:
                ch.k8.vc_prep(sys_, w, pen)

        def rnd():
            ch.k8.vc_round(sys_, w, pen, ch.eps, False)
        init()
        for _ in range(4096):
            rnd()
            if _ % 64 == 63 and int(w.ctrl[1]) == 0:
                break
        rounds = int(w.ctrl[IT])
        ctrl, shape = w.ctrl, (sys_.n_v, sys_.wv, sys_.n_c)
    rec = {"case": name, "shape": shape, "rounds": rounds,
           **tm.time_rounds(init, rnd, rounds)}
    loop = DeviceLoop([_loop(new, ctrl, rnd)], "chain", torch.device("cuda"))
    init()
    loop.run()            # builds the graph
    torch.cuda.synchronize()
    g = tm.time_call(loop.run, setup=init)
    rec["graph_ms"] = g["ms"] / max(rounds, 1)
    rec["graph_queued"] = g["queued"]
    rec["profile_ms_per_round"] = _profile_ms(loop.run, init, rounds)
    return rec


def k9_case() -> dict:
    import torch
    tm = _timing()
    ch = Chain()
    ch.stage_rounds()
    snap = ch.snapshot()

    def setup():
        ch.restore(snap)
    rec = {"case": "k9", "rows": [ch.sys.n_v, ch.half],
           "nnz": int(ch.sys.vcx_ptr[-1]), "new": ch.new}
    t = tm.time_call(lambda: ch.stage(arm=ch.new), setup)
    rec.update(ms=t["ms"], queued=t["queued"],
               kernels=tm.kernel_counts(lambda: ch.stage(arm=ch.new),
                                        setup))
    rec["paced_ms"] = tm.events_ms(lambda: ch.stage(arm=ch.new), 10, setup)
    if not ch.new:
        ta = tm.time_call(lambda: ch.stage(arm=True), setup)
        rec["with_arm"] = {"ms": ta["ms"], "queued": ta["queued"],
                           "kernels": tm.kernel_counts(
                               lambda: ch.stage(arm=True), setup)}
    torch.cuda.synchronize()
    return rec


def headline_case() -> dict:
    import torch
    from simgrid_tpu_torch.workloads import bench_solve
    sm = _smoke()
    _, row = bench_solve.run_bench_solve(device=torch.device("cuda"),
                                         reps=9, eps=sm.HL_EPS,
                                         **sm.HEADLINE)
    loop = row.get("loop") or {}
    return {"case": "headline", "path": row["path"],
            "rounds": row["rounds"], "first_ms": row["first_ms"],
            "ms": row["ms"], "reps_ms": row["reps_ms"],
            "after_first": row.get("after_first"),
            "graph_launches": sum(loop.get("graph_launches", {}).values()),
            "graph_builds": loop.get("graph_builds"),
            "k8_device_rounds": loop.get("device_tally", {}).get("vc_round")}


def headline_busy_case() -> dict:
    import numpy as np
    import torch
    from simgrid_tpu_torch.ops.lmm_torch import solve_arrays
    from simgrid_tpu_torch.workloads import bench_solve
    sm = _smoke()
    hl = bench_solve.build_arrays(np.random.default_rng(
        sm.HEADLINE["seed"]), sm.HEADLINE["n_c"], sm.HEADLINE["n_v"],
        sm.HEADLINE["deg"], np.float64)
    cuda = torch.device("cuda")
    solve_arrays(hl, sm.HL_EPS, cuda, parallel_rounds=True)
    n = 10
    b = _timing().busy_profile(lambda: [solve_arrays(
        hl, sm.HL_EPS, cuda, parallel_rounds=True) for _ in range(n)])
    t0 = time.perf_counter()
    for _ in range(n):
        solve_arrays(hl, sm.HL_EPS, cuda, parallel_rounds=True)
    wall = (time.perf_counter() - t0) / n
    return {"case": "headline_busy", "solves": n,
            "busy_ms": None if b["busy_ms"] is None else b["busy_ms"] / n,
            "profiled_wall_ms": b["profiled_wall_s"] * 1e3 / n,
            "wall_ms": wall * 1e3,
            "busy_share": None if b["busy_ms"] is None
            else b["busy_ms"] / n / (wall * 1e3),
            "device_records": b["device_records"]}


class _FirstSolve:
    """Wraps ``churn.make_new_maxmin_system`` so the system's first
    ``solve()`` is marked (its start and end on the host clock, the
    graphs K16 built in it) and, with ``profile``, run under
    ``cProfile``; records Python's garbage collections meanwhile."""

    def __init__(self, churn, profile: bool = False):
        import gc
        self.churn, self.gc = churn, gc
        self.make0 = churn.make_new_maxmin_system
        self.profile, self.marks, self.collections = profile, {}, []
        self._t = 0.0
        churn.make_new_maxmin_system = self._make
        gc.callbacks.append(self._on_gc)

    def close(self):
        self.churn.make_new_maxmin_system = self.make0
        self.gc.callbacks.remove(self._on_gc)

    def _on_gc(self, phase, info):
        now = time.perf_counter()
        if phase == "start":
            self._t = now
        else:
            self.collections.append((self._t, now - self._t,
                                     info["generation"]))

    def _make(self, *a, **kw):
        from simgrid_tpu_torch.kernels import superstep_loop as k16
        s = self.make0(*a, **kw)
        solve0 = s.solve

        def solve():
            if "start" in self.marks:
                return solve0()
            b0 = k16.BUILDS["graphs"]
            self.marks["start"] = time.perf_counter()
            if self.profile:
                import cProfile
                self.prof = cProfile.Profile()
                self.prof.runcall(solve0)
            else:
                solve0()
            self.marks["end"] = time.perf_counter()
            self.marks["graph_builds"] = k16.BUILDS["graphs"] - b0
        s.solve = solve
        return s

    def gc_split(self) -> dict:
        """Seconds of collection by phase and generation."""
        t1, t2 = self.marks["start"], self.marks["end"]
        out = {}
        for t, d, g in self.collections:
            ph = "build" if t < t1 else ("first" if t < t2 else "steps")
            key = f"{ph}_gen{g}"
            out[key] = out.get(key, 0.0) + d
        return out

    def top(self, n: int = 25) -> list:
        import pstats
        st = pstats.Stats(self.prof)
        rows = sorted(st.stats.items(), key=lambda kv: -kv[1][3])[:n]
        return [{"fn": f"{k[0].split('simgrid_tpu_torch/')[-1]}:{k[1]}"
                 f"({k[2]})", "calls": v[1], "tot_s": v[2], "cum_s": v[3]}
                for k, v in rows]


def churn_case(profile: bool = False) -> dict:
    import torch
    from simgrid_tpu_torch.workloads import churn
    sm = _smoke()
    out = {"case": "churn_profile" if profile else "churn"}
    modes = ("cold-delta", "warm-selective") if profile else churn.MODES
    for mode in modes:
        fs = _FirstSolve(churn, profile)
        t0 = time.perf_counter()
        try:
            _, row = churn.run_churn(mode, device=torch.device("cuda"),
                                     strict=True, **sm.CHURN)
        finally:
            fs.close()
        out[mode] = {"wall_s": time.perf_counter() - t0,
                     "build_s": row["build_s"],
                     "first_solve_ms": row["first_solve_ms"],
                     "solve_ms": row["solve_ms"],
                     "solve_ms_med": row["solve_ms_med"],
                     "last_layout": row["last_layout"],
                     "first_graph_builds": fs.marks["graph_builds"],
                     "gc_s": fs.gc_split()}
        if profile:
            out[mode]["top"] = fs.top()
        torch.cuda.empty_cache()
    return out


def run_case(name: str) -> dict:
    if name in ("k8_stage", "k8_dense"):
        return round_case(name)
    return {"k9": k9_case, "headline": headline_case,
            "headline_busy": headline_busy_case,
            "churn": churn_case,
            "churn_profile": lambda: churn_case(True)}[name]()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="import simgrid_tpu_torch from this checkout")
    ap.add_argument("--out", default=None, help="append JSON lines here")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("vc_chain: no CUDA device", file=sys.stderr)
        return 2
    from simgrid_tpu_torch.kernels import build
    build.build_all()
    kind = torch.cuda.get_device_name(0)
    for name in args.cases.split(","):
        rec = {"label": args.label, "root": root, "kind": kind,
               **run_case(name)}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
