"""Scenario fleets as ``bench.py`` runs them, and the config-#4 fleet.

* :func:`run_sweep` — ``bench.py``'s sweep stage (``stage_sweep``): one
  shared system of 96 constraints x 400 flows (degree 3, seed 42) and 64
  mixed fault/sweep scenarios, drained at fleet widths 1, 8 and 64,
  with the counts the stage reports (dispatches, rounds, upload bytes,
  errors) and the check that every width gives the same events;
* :func:`run_fault_modes` — ``bench.py``'s fault stage
  (``stage_fault``): 32 scenarios, half with seeded MTBF/MTTR link
  failures, drained once per fault mode (``off``, ``static``, ``on``),
  with the tape's slots and fires and, for ``on``, a solo spot check;
* :func:`fleet_specs`, :func:`fleet_campaign` and
  :func:`run_fleet_full` — a fleet over a drain system (config #4's
  random drain at full width): sweep replicas and faulted replicas in
  one fleet, with its wall, supersteps, rounds and launch counts
  (:func:`run_fleet_full` also drains ``workloads/collective_fleet.py``'s
  collective campaigns); :func:`launches_per_superstep` counts a fleet's
  launches.

Every function returns rows (dicts) and runs on the card unless given
``device="cpu"``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels import launch_counts, path_counts, reset_launch_counts
from ..kernels import superstep_loop as k16
from ..ops import opstats
from ..parallel.campaign import Campaign, ScenarioSpec
from .bench_solve import build_arrays

#: ``bench.py``'s sweep and fault stages (``stage_sweep``,
#: ``stage_fault``): the shared class and the fleets
STAGE = dict(n_c=96, n_v=400, deg=3, seed=42)
SWEEP_REPLICAS = 64
FAULT_REPLICAS = 32
SUPERSTEP = 8
EPS = 1e-9

#: the counts the JAX package gives for the same campaigns on the CPU
#: (its ``Campaign.run_scoped`` on ``stage_sweep``'s and ``stage_fault``'s
#: fleets, round budget ``superstep * 512``); they do not depend on the
#: platform, and the port must give them on the card and on the CPU
JAX_COUNTS = {
    "sweep_b1": dict(dispatches=3712, fixpoint_rounds=333_891, errors=0,
                     fault_tape_events=7862),
    "sweep_b8": dict(dispatches=619, fixpoint_rounds=333_891, errors=0,
                     fault_tape_events=7862),
    "sweep_b64": dict(dispatches=79, fixpoint_rounds=333_891, errors=0,
                      fault_tape_events=7862),
    "fault_off": dict(dispatches=41, fixpoint_rounds=93_728,
                      fault_tape_slots=0, fault_tape_events=0, errors=0),
    "fault_static": dict(dispatches=43, fixpoint_rounds=93_005,
                         fault_tape_slots=0, fault_tape_events=0, errors=0),
    "fault_on": dict(dispatches=78, fixpoint_rounds=166_295,
                     fault_tape_slots=3898, fault_tape_events=3898,
                     errors=0),
}


def stage_system(n_c: int, n_v: int, deg: int, seed: int):
    """The stages' shared system: ``bench.py``'s ``build_arrays`` class
    and its flow sizes (16 sizes from 1e5 to 2e6 bytes), float64:
    ``(e_var, e_cnst, e_w, c_bound, sizes)``."""
    rng = np.random.default_rng(seed)
    a = build_arrays(rng, n_c, n_v, deg, np.float64)
    sizes = rng.choice(np.linspace(1e5, 2e6, 16), n_v)
    E = a.n_elem
    return a.e_var[:E], a.e_cnst[:E], a.e_w[:E], a.c_bound[:n_c], sizes


def sweep_specs(replicas: int = SWEEP_REPLICAS) -> List[ScenarioSpec]:
    """``stage_sweep``'s scenarios: bandwidth and size sweeps, every
    odd seed with a link-failure schedule, every third a dead flow."""
    return [ScenarioSpec(seed=s, bw_scale=1.0 + 0.1 * (s % 5),
                         size_scale=1.0 + 0.05 * (s % 3),
                         fault_mtbf=400.0 if s % 2 else None,
                         fault_mttr=50.0, fault_horizon=600.0,
                         dead_flows=(s % 11,) if s % 3 == 0 else ())
            for s in range(replicas)]


def fault_specs(replicas: int = FAULT_REPLICAS) -> List[ScenarioSpec]:
    """``stage_fault``'s scenarios (the sweep's, without dead flows)."""
    return [ScenarioSpec(seed=s, bw_scale=1.0 + 0.1 * (s % 5),
                         size_scale=1.0 + 0.05 * (s % 3),
                         fault_mtbf=400.0 if s % 2 else None,
                         fault_mttr=50.0, fault_horizon=600.0)
            for s in range(replicas)]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_sweep(device: DeviceLike = None, batches: Sequence[int] = (1, 8, 64),
              replicas: int = SWEEP_REPLICAS) -> List[Dict]:
    """``stage_sweep``: one row per fleet width, and ``events_consistent``
    (every width gives the width-1 events) on each."""
    dev = resolve_device(device)
    specs = sweep_specs(replicas)
    camp = Campaign(*stage_system(**STAGE), specs, eps=EPS,
                    dtype=np.float64, superstep=SUPERSTEP, device=dev)
    rows, streams = [], {}
    for batch in batches:
        _sync(dev)
        t0 = time.perf_counter()
        results, st = camp.run_scoped(batch=batch, stage=f"sweep/b{batch}")
        wall = time.perf_counter() - t0
        streams[batch] = [list(r.events) for r in results]
        upload = (st.get("uploaded_bytes_full", 0)
                  + st.get("uploaded_bytes_delta", 0))
        rows.append(dict(
            stage="sweep", batch=batch, replicas=replicas, **STAGE,
            superstep=SUPERSTEP, dispatches=int(st.get("dispatches", 0)),
            fixpoint_rounds=int(st.get("fixpoint_rounds", 0)),
            fault_tape_events=int(st.get("fault_tape_events", 0)),
            upload_bytes=int(upload),
            errors=sum(1 for r in results if r.error), wall_s=wall,
            wall_s_per_replica=wall / replicas,
            events=sum(len(r.events) for r in results)))
    base = streams[batches[0]]
    consistent = all(s == base for s in streams.values())
    for row in rows:
        row["events_consistent"] = consistent
    return rows


def run_fault_modes(device: DeviceLike = None,
                    modes: Sequence[str] = ("off", "static", "on"),
                    replicas: int = FAULT_REPLICAS) -> List[Dict]:
    """``stage_fault`` without its pipelined row: one row per fault
    mode; the ``on`` row carries the solo spot check of replica 1 (the
    first faulted one: events, fault events and clock equal by bits)."""
    dev = resolve_device(device)
    specs = fault_specs(replicas)
    arrays = stage_system(**STAGE)
    rows = []
    for mode in modes:
        camp = Campaign(*arrays, specs, eps=EPS, dtype=np.float64,
                        superstep=SUPERSTEP, fault_mode=mode, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        results, st = camp.run_scoped(batch=replicas, stage=f"fault/{mode}")
        wall = time.perf_counter() - t0
        row = dict(stage="fault", fault_mode=mode, replicas=replicas,
                   **STAGE, superstep=SUPERSTEP,
                   fault_tape_slots=int(st.get("fault_tape_slots", 0)),
                   fault_tape_events=int(st.get("fault_tape_events", 0)),
                   dispatches=int(st.get("dispatches", 0)),
                   fixpoint_rounds=int(st.get("fixpoint_rounds", 0)),
                   errors=sum(1 for r in results if r.error), wall_s=wall)
        if mode == "on":
            solo = camp.run_solo(1)
            row["solo_bit_identical"] = (
                solo.events == results[1].events
                and solo.t == results[1].t
                and solo.fault_events == results[1].fault_events)
        rows.append(row)
    return rows


def fleet_specs(n_v: int, n_e: int, fault: Dict, seed: int = 42,
                sweep: int = 4, faulted: int = 4) -> List[ScenarioSpec]:
    """A mixed fleet over a drain system of ``n_v`` flows and ``n_e``
    elements: ``sweep`` replicas with bandwidth scales 1.0, 1.1, ... and
    size scales 1.0/1.05 in turn (the third with 11 dead flows, the
    fourth with 64 element weights overridden, so the fleet's weights
    are per replica), then ``faulted`` replicas under the seeded
    campaign ``fault`` (``horizon``, ``mtbf``, ``mttr``) at seeds
    ``seed``, ``seed + 1``, ..."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(sweep):
        kw = {}
        if i == 2:
            kw["dead_flows"] = tuple(int(x) for x in sorted(
                rng.choice(n_v, 11, replace=False)))
        if i == 3:
            slots = sorted(rng.choice(n_e, 64, replace=False))
            kw["elem_w"] = {int(s): float(w) for s, w in zip(
                slots, rng.uniform(0.5, 1.5, 64))}
        specs.append(ScenarioSpec(seed=seed + i, bw_scale=1.0 + 0.1 * i,
                                  size_scale=1.0 + 0.05 * (i % 2),
                                  label=f"sweep{i}", **kw))
    for i in range(faulted):
        specs.append(ScenarioSpec(
            seed=fault.get("seed", seed) + i, fault_mtbf=fault["mtbf"],
            fault_mttr=fault["mttr"], fault_horizon=fault["horizon"],
            label=f"fault{i}"))
    return specs


def fleet_campaign(system, specs: Sequence[ScenarioSpec],
                   device: DeviceLike = None, superstep: int = 16,
                   link_names=None, eps: float = 1e-5) -> Campaign:
    """``specs`` over a drain system (``dragonfly.DrainSystem``),
    float64, fault mode ``on``."""
    return Campaign(system.e_var, system.e_cnst, system.e_w,
                    system.c_bound, system.sizes, list(specs),
                    link_names=link_names, eps=eps, dtype=np.float64,
                    superstep=superstep, fault_mode="on",
                    device=resolve_device(device))


def run_fleet_full(camp: Campaign, between=None,
                   max_supersteps: int = 10_000_000):
    """Drain a campaign's specs as one fleet, launch counts zeroed just
    before and read just after.  ``between(sim)`` runs after every
    superstep (an admission window).  Returns the fleet and its row; a
    collective campaign's row also names its case and edge count."""
    dev = resolve_device(camp.plan.device)
    _sync(dev)
    before = opstats.snapshot()
    reset_launch_counts()
    t0 = time.perf_counter()
    sim = camp.plan.executor(camp.specs)
    # the host's time to build the fleet (its tapes, its uploads), part
    # of the wall
    executor_s = time.perf_counter() - t0
    sim.run(max_supersteps=max_supersteps, between=between)
    _sync(dev)
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in path_counts().items() if v}
    st = opstats.diff(before)
    reps = sim.replicas
    row = dict(replicas=sim.B, flows=sim.n_v, superstep=sim.superstep_k,
               wall_s=wall, wall_s_per_replica=wall / sim.B,
               executor_s=executor_s,
               supersteps=sim.supersteps,
               dispatches=int(st.get("dispatches", 0)),
               loop_builds=sim.loop_builds, rescues=sim.rescues,
               rounds=sim.rounds,
               admitted=sim.admitted, advances=[r.advances for r in reps],
               completions=sum(len(r.events) for r in reps),
               activations=sum(len(r.collective_events) for r in reps),
               fires=[len(r.fault_events) for r in reps],
               fault_tape_events=int(st.get("fault_tape_events", 0)),
               collective_tape_fires=int(st.get("collective_tape_fires", 0)),
               t_sim=[r.t for r in reps], errors=[r.error for r in reps],
               batch_w=sim.batch_w, launches=counts, loop=k16.summary())
    cs = camp.plan.collective
    if cs is not None:
        row.update(case=f"{cs.algo}-r{cs.ranks}",
                   edges=int(camp.plan._dc.n_edges))
    return sim, row


def launches_per_superstep(sim, n: int) -> List[Dict]:
    """Run ``n`` fleet supersteps of ``sim`` and return per superstep its
    wrapper launches in all (K16's graph launch among them), its graph
    launches, and the advance slots and K1 rounds the graph ran (K16's
    device tally, fetched after each superstep)."""
    rows = []
    for _ in range(n):
        reset_launch_counts()
        k16.reset_tally()
        sim.superstep_all()
        counts = launch_counts()
        tally = k16.device_tally()
        rows.append(dict(
            launches=sum(counts.values()),
            graph_launches=sum(counts[f"superstep_loop_{k}"]
                               for k in k16.KINDS),
            slots=tally["slots"], rounds=tally["lmm_round_fleet"]))
    return rows
