"""The LV08 alltoall of BASELINE config #4 as the Lazy network model
builds and mutates it: a selective-update System built through the
System API, and the solves the engine's default configuration makes.

:func:`build` makes exactly the calls ``NetworkCm02Model.communicate``
makes for each flow (``simgrid_tpu/models/network.py:355-452``): a link
constraint per used link (``bw_factor * bandwidth``, in first-use
order), then per flow ``variable_new(action, 0.0, -1.0, n_links)`` (the
flow waits out its latency at penalty 0), ``update_variable_bound(var,
TCP_gamma / (2 * latency))``, ``expand(link, var, 1.0)`` along the
forward route and ``expand(link, var, 0.05)`` along the back route.
Routes, latencies and LV08 penalties come from
:mod:`.dragonfly` (``build_alltoall``, ``lv08_values``), whose values
equal the engine's.

:func:`solve_sequence` then replays what the Lazy model does to the
System, solving after each step:

1. the first solve, with every flow in its latency phase;
2. each distinct latency-end date (``latency * 13.01``, the LV08
   latency factor, earliest first): ``update_variable_penalty(var,
   penalty)`` for every flow of that date (``network.py:252-265``);
3. retirement: a seeded 1% of the flows are freed;
4. a bandwidth change: a seeded 1% of the links halve their bandwidth,
   replaying both System calls of ``NetworkCm02Link.set_bandwidth``
   (``network.py:530-566``): the constraint bound, then for every flow
   whose forward route crosses the link its penalty ``pen - n*S/old +
   n*S/new`` (``n`` the link's count in the route; the back route
   carries no weight-S term).

Both functions take any System with the reference's API.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from ..device import DeviceLike
from ..kernels import path_counts, reset_launch_counts
from ..kernels import superstep_loop as k16
from ..ops.lmm_host import LmmFlags, make_new_maxmin_system
from ..ops.lmm_torch import install
from .churn import host_state
from .dragonfly import (BANDWIDTH, BW_FACTOR, LATENCY, TOPOLOGY, WEIGHT_S,
                        Dragonfly, DrainSystem, build_alltoall)

#: LV08's network/latency-factor
LATENCY_FACTOR = 13.01


class Flow:
    """The action a flow's variable stands for: its index and its
    current sharing penalty (the engine's ``action.sharing_penalty``)."""

    __slots__ = ("index", "penalty", "in_modified_set")

    def __init__(self, index: int, penalty: float):
        self.index = index
        self.penalty = penalty
        self.in_modified_set = False


class LazyAlltoall(NamedTuple):
    system: DrainSystem        # elements flow by flow, LV08 values
    starts: np.ndarray         # [F+1] first element of each flow
    latency: np.ndarray        # [F] route latency, summed link by link
    link_bw: np.ndarray        # [C] bandwidth of each link constraint
    fwd_count: List[Dict[int, int]]   # per flow: constraint -> count


def alltoall(ranks: int, topology: str = TOPOLOGY) -> LazyAlltoall:
    """The ``ranks``-rank LV08 alltoall's routes and values."""
    s = build_alltoall(ranks, topology=topology)
    F = len(s.sizes)
    starts = np.searchsorted(s.e_var, np.arange(F + 1)).astype(np.int64)
    fwd = s.e_w == 1.0
    n_fwd = np.add.reduceat(fwd.astype(np.int64), starts[:-1])
    lat = np.zeros(F)
    for k in range(int(n_fwd.max())):
        lat = np.where(n_fwd > k, lat + LATENCY, lat)
    link_bw = BANDWIDTH * Dragonfly(topology).link_count(
        s.link_ids).astype(np.float64)
    fwd_count = []
    for k in range(F):
        counts: Dict[int, int] = {}
        for j in range(starts[k], starts[k + 1]):
            if fwd[j]:
                c = int(s.e_cnst[j])
                counts[c] = counts.get(c, 0) + 1
        fwd_count.append(counts)
    return LazyAlltoall(s, starts, lat, link_bw, fwd_count)


def build(system, a2a: LazyAlltoall):
    """The link constraints and the flows' variables, through the calls
    ``communicate`` makes; returns ``(constraints, variables)``."""
    s = a2a.system
    cnsts = [system.constraint_new(None, float(b)) for b in s.c_bound]
    e_cnst = s.e_cnst.tolist()
    e_w = s.e_w.tolist()
    variables = []
    for k in range(len(s.sizes)):
        beg, end = int(a2a.starts[k]), int(a2a.starts[k + 1])
        var = system.variable_new(Flow(k, float(s.v_penalty[k])), 0.0,
                                  -1.0, end - beg)
        system.update_variable_bound(var, float(s.v_bound[k]))
        for j in range(beg, end):
            system.expand(cnsts[e_cnst[j]], var, e_w[j])
        variables.append(var)
    return cnsts, variables


def solve_sequence(system, a2a: LazyAlltoall, cnsts, variables,
                   seed: int = 0) -> Iterator[Tuple[str, float]]:
    """Mutate and solve as the Lazy model does; yields ``(label, ms)``
    after each solve, ``ms`` the host wall time of ``system.solve()``
    (the System holds that solve's result then).  Freed flows' entries
    of ``variables`` become None."""
    def solve(label):
        t0 = time.perf_counter()
        system.solve()
        ms = (time.perf_counter() - t0) * 1e3
        system.drain_modified_actions()
        return label, ms

    yield solve("first")
    dates = a2a.latency * LATENCY_FACTOR
    for d in np.unique(dates):
        for k in np.flatnonzero(dates == d):
            var = variables[k]
            system.update_variable_penalty(var, var.id.penalty)
        yield solve(f"latency {float(d)!r}")

    rng = np.random.default_rng(seed)
    F, C = len(variables), len(cnsts)
    for k in rng.choice(F, max(1, F // 100), replace=False):
        system.variable_free(variables[int(k)])
        variables[int(k)] = None
    yield solve("retire")

    bw = a2a.link_bw.copy()
    for c in rng.choice(C, max(1, C // 100), replace=False):
        c = int(c)
        old = float(bw[c])
        new = old / 2
        system.update_constraint_bound(cnsts[c], BW_FACTOR * new)
        seen = set()
        for var in list(cnsts[c].iter_variables()):
            flow = var.id
            if id(var) in seen:
                continue
            seen.add(id(var))
            n = a2a.fwd_count[flow.index].get(c, 0)
            if not n:
                continue
            flow.penalty -= n * (WEIGHT_S / old)
            flow.penalty += n * (WEIGHT_S / new)
            system.update_variable_penalty(var, flow.penalty)
        bw[c] = new
    yield solve("bandwidth")


def run_lazy(ranks: int = 320, device: DeviceLike = None, seed: int = 0,
             flags: Optional[LmmFlags] = None, states: bool = False,
             on_solve=None):
    """Build the ``ranks``-rank alltoall on a port System installed with
    the torch backend (selective update; ``flags`` default to the
    reference's with ``backend="torch"``) and run :func:`solve_sequence`.
    Returns ``(system, row)``: the build's wall time apart from the
    solves, the sizes, the number of latency-end dates, one record per
    solve (label, wall ms, warm or cold, layout, rounds, dirty slots,
    upload bytes), the kernels' launch counts over the solves and the
    warm solver's ``warm_ell_fallbacks`` (the caps refuse the 320-rank
    system's 1,272-element rows: with the default layout every solve on
    the card counts one, as in the JAX package); with
    ``states`` also the host state after every solve.  ``on_solve(label,
    system)`` runs after each solve, outside the timed solve."""
    a2a = alltoall(ranks)
    s = make_new_maxmin_system(True, flags or LmmFlags(backend="torch"))
    install(s, device=device)
    t0 = time.perf_counter()
    cnsts, variables = build(s, a2a)
    row = {"ranks": ranks, "flows": len(variables),
           "constraints": len(cnsts), "elements": len(a2a.system.e_var),
           "build_s": time.perf_counter() - t0,
           "latency_dates": len(np.unique(a2a.latency * LATENCY_FACTOR)),
           "solves": []}
    kept = []
    reset_launch_counts()
    for label, ms in solve_sequence(s, a2a, cnsts, variables, seed):
        ws = s.warm_solver
        row["solves"].append({"label": label, "ms": ms,
                              "mode": ws.last_mode,
                              "layout": ws.last_layout,
                              "rounds": ws.last_rounds,
                              "dirty_slots": ws.last_dirty_slots,
                              "upload_bytes": ws.last_upload_bytes})
        if states:
            kept.append(host_state(s))
        if on_solve is not None:
            on_solve(label, s)
    row["launches"] = path_counts()
    row["loop"] = k16.summary()
    row["solver_fallbacks"] = s.fallback_count
    row["warm_ell_fallbacks"] = s.warm_solver.warm_ell_fallbacks
    if states:
        row["states"] = kept
    return s, row
