"""The incremental-churn scenario of the JAX package's ``bench.py``
churn stage (``stage_churn``, ``bench.py:236-337``), on the port's
System.

``n_v`` variables: a background chain of ``chain`` constraints with
doubling bounds (about ``chain`` local rounds from a cold start), and
flows spread over ``clusters`` independent constraints.  Between
solves, ``churn`` of the flows retire and are replaced (the SMPI-style
mutating phase).  The modes are the reference's grid of
``lmm/warm-start`` x ``lmm/delta-upload``:

* ``legacy-subset``  — warm start off: re-flatten the modified subset;
* ``cold-full``      — cold restarts, whole dirty fields re-uploaded;
* ``cold-delta``     — cold restarts, indexed delta uploads;
* ``warm-selective`` — warm restarts of the modified component, delta
  uploads.

:func:`build` and :func:`churn_step` make the reference's System calls
in its order from the same ``np.random.default_rng(seed)`` stream; they
take any System with the reference's API.  :func:`run_churn` drives them
on a port System and reports the fields ``bench.py`` reports.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from ..device import DeviceLike
from ..kernels import path_counts, reset_launch_counts
from ..kernels import superstep_loop as k16
from ..ops import opstats
from ..ops.lmm_host import LmmFlags, make_new_maxmin_system
from ..ops.lmm_torch import install

#: mode -> (warm_start, delta_upload)
MODES = {"legacy-subset": ("off", "off"),
         "cold-full": ("cold", "off"),
         "cold-delta": ("cold", "on"),
         "warm-selective": ("on", "on")}


def build(system, rng, n_v: int, clusters: int, chain: int):
    """The chain and the cluster flows (``bench.py:272-287``); returns
    the cluster constraints and the flows of each cluster."""
    chain_cs = [system.constraint_new(None, float(2.0 ** i))
                for i in range(chain)]
    for i in range(chain - 1):
        v = system.variable_new(None, 1, -1, 2)
        system.expand(chain_cs[i], v, 1)
        system.expand(chain_cs[i + 1], v, 1)
    n_flows = n_v - (chain - 1)
    cluster_cs = [system.constraint_new(None, float(rng.uniform(50, 200)))
                  for _ in range(clusters)]
    flows: List[list] = [[] for _ in range(clusters)]
    weights = rng.choice([0.5, 1.0, 2.0], size=n_flows)
    for i in range(n_flows):
        k = i % clusters
        v = system.variable_new(None, 1.0)
        system.expand(cluster_cs[k], v, float(weights[i]))
        flows[k].append(v)
    return cluster_cs, flows


def churn_step(system, rng, cluster_cs, flows, churn_n: int) -> None:
    """One mutation batch (``bench.py:303-310``): ``churn_n`` seeded
    clusters each retire their oldest flow and get a new one."""
    ks = rng.integers(0, len(cluster_cs), size=churn_n)
    for k in ks:
        k = int(k)
        if flows[k]:
            system.variable_free(flows[k].pop(0))
        v = system.variable_new(None, 1.0)
        system.expand(cluster_cs[k], v, float(rng.choice([0.5, 1.0, 2.0])))
        flows[k].append(v)


def host_state(system):
    """The solve's result on the host: every variable's value, every
    constraint's remaining and usage, in list order."""
    return (np.array([v.value for v in system.variable_set], np.float64),
            np.array([(c.remaining, c.usage)
                      for c in system.constraint_set],
                     np.float64).reshape(-1, 2))


def run_churn(mode: str = "warm-selective", n_v: int = 100_000,
              seed: int = 42, clusters: int = 960, chain: int = 96,
              churn: float = 0.01, steps: int = 6, rounds: str = "local",
              device: DeviceLike = None, states: bool = False,
              strict: bool = False, layout: str = "auto",
              chain_mode: str = "auto"):
    """Build the scenario on a port System installed with the torch
    backend in ``mode``, solve it, then ``steps`` churn steps each
    followed by a solve.  Returns ``(system, row)``: the row holds
    ``bench.py``'s fields (flows, first-solve ms, rounds and full-upload
    bytes, per-step medians of ms, rounds, bytes and dirty slots, warm
    solves), the per-step lists and the kernels' launch counts over the
    solves; with ``states`` also the host state after every solve
    (:func:`host_state`).  ``strict`` makes a failed solve on the CPU
    path raise instead of falling back to the host list solver (on the
    card it always raises).  ``layout`` is ``LmmFlags.layout``: the
    default ``auto`` solves in ELL on the card, as the JAX package does
    on an accelerator, and in COO on the CPU; the row also reports the
    layout the last solve took and ``warm_ell_fallbacks``.
    ``chain_mode`` is ``LmmFlags.chain`` (``chain`` is the background
    chain's length): the legacy-subset mode's whole-system solves take
    the compaction chain where it is on."""
    warm_start, delta_upload = MODES[mode]
    flags = LmmFlags(backend="torch", rounds=rounds, warm_start=warm_start,
                     delta_upload=delta_upload, strict=strict,
                     layout=layout, chain=chain_mode)
    rng = np.random.default_rng(seed)
    s = make_new_maxmin_system(True, flags)
    install(s, device=device)
    t0 = time.perf_counter()
    cluster_cs, flows = build(s, rng, n_v, clusters, chain)
    out = {"mode": mode, "flows": n_v - (chain - 1), "clusters": clusters,
           "chain": chain, "churn": churn, "steps": steps,
           "build_s": time.perf_counter() - t0}
    kept = []
    reset_launch_counts()
    before = opstats.snapshot()
    t0 = time.perf_counter()
    s.solve()
    out["first_solve_ms"] = (time.perf_counter() - t0) * 1e3
    d = opstats.diff(before)
    out["rounds_first"] = int(d.get("fixpoint_rounds", 0))
    out["bytes_full_first"] = int(d.get("uploaded_bytes_full", 0))
    if states:
        kept.append(host_state(s))

    churn_n = max(1, int(out["flows"] * churn))
    walls, rnds, b_full, b_delta, dirt = [], [], [], [], []
    for _ in range(steps):
        churn_step(s, rng, cluster_cs, flows, churn_n)
        before = opstats.snapshot()
        t0 = time.perf_counter()
        s.solve()
        walls.append((time.perf_counter() - t0) * 1e3)
        d = opstats.diff(before)
        rnds.append(int(d.get("fixpoint_rounds", 0)))
        b_full.append(int(d.get("uploaded_bytes_full", 0)))
        b_delta.append(int(d.get("uploaded_bytes_delta", 0)))
        ws = s.warm_solver
        dirt.append(ws.last_dirty_slots if ws else -1)
        if states:
            kept.append(host_state(s))
    out.update(solve_ms=walls, rounds=rnds, bytes_full=b_full,
               bytes_delta=b_delta, dirty_slots=dirt,
               solve_ms_med=float(np.median(walls)),
               rounds_med=int(np.median(rnds)),
               bytes_full_med=int(np.median(b_full)),
               bytes_delta_med=int(np.median(b_delta)),
               dirty_slots_med=int(np.median(dirt)),
               warm_solves=s.warm_solver.warm_solves if s.warm_solver else 0,
               last_layout=s.warm_solver.last_layout if s.warm_solver
               else "",
               warm_ell_fallbacks=(s.warm_solver.warm_ell_fallbacks
                                   if s.warm_solver else 0),
               solver_fallbacks=s.fallback_count,
               launches=path_counts(), loop=k16.summary())
    if states:
        out["states"] = kept
    return s, out
