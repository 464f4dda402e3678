"""The pipelined drain as ``bench.py`` runs it (``stage_pipeline``).

Two workloads, each at pipeline depths 0, 1 and 2, every row with the
fetches the host made, how many of them blocked (the card's work was not
done when the host asked), the milliseconds the host spent in them, the
wall, and the speculation census:

* **solo-wave**: ``bench.py``'s ``build_wave_arrays`` (32 links, one
  flow per link and size wave, 8 waves, seed 42: every advance retires
  one tie group) drained by ``DrainSim(superstep=8)`` with an event
  consumer (``on_batches``) that spins ``host_work_us`` (500) a
  committed advance: the host's own work per advance, the same at every
  depth;
* **fleet-wave**: the same system as a fleet of 64 scenarios
  (bandwidth scales, two element weights overridden per replica), whose
  host work is the per-replica demux.

The counts that do not depend on the platform (advances, supersteps,
fetches, speculations) must be :data:`RECORDED`, the JAX package's rows
of ``bench_results/lmm_pipeline.jsonl``; ``blocking_per_advance`` and
the times are the device's own.  Every function runs on the card unless
given ``device="cpu"``.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from ..device import DeviceLike, resolve_device
from ..ops import opstats
from ..ops.lmm_drain import DrainSim
from ..parallel.campaign import Campaign, ScenarioSpec

#: ``stage_pipeline``'s arguments
STAGE = dict(n_c=32, per=1, waves=8, seed=42)
SUPERSTEP = 8
HOST_WORK_US = 500.0
REPLICAS = 64
EPS = 1e-9
DEPTHS = (0, 1, 2)

#: the recorded counts by workload and depth: (advances, supersteps or
#: None, fetches, (issued, committed, rolled back))
RECORDED = {
    "solo-wave": {0: (253, 32, 32, (0, 0, 0)),
                  1: (253, 33, 32, (32, 31, 1)),
                  2: (253, 34, 32, (33, 31, 2))},
    "fleet-wave": {0: (16199, None, 32, (0, 0, 0)),
                   1: (16199, None, 32, (32, 31, 1)),
                   2: (16199, None, 32, (33, 31, 2))},
}


def build_wave_arrays(n_c: int, per: int, waves: int, seed: int):
    """``bench.py``'s ``build_wave_arrays``: a degree-1 system of ``per``
    flows per (link, size wave) tie group; ``(e_var, e_cnst, e_w,
    c_bound, sizes)``."""
    rng = np.random.default_rng(seed)
    n_v = n_c * per * waves
    e_var = np.arange(n_v, dtype=np.int32)
    e_cnst = (np.arange(n_v) // (per * waves)).astype(np.int32)
    e_w = np.ones(n_v)
    c_bound = rng.uniform(1e5, 1e6, n_c)
    wave = (np.arange(n_v) // per) % waves
    sizes = 1e6 * (1.0 + 0.21 * wave)
    return e_var, e_cnst, e_w, c_bound, sizes


def spin(us: float) -> None:
    """Busy-wait ``us`` microseconds on the host."""
    t_end = time.perf_counter() + us * 1e-6
    while time.perf_counter() < t_end:
        pass


def _fetch_row(st: Dict[str, float], advances: int) -> Dict:
    adv = max(advances, 1)
    blocking = int(st.get("blocking_fetches", 0))
    return dict(fetches=int(st.get("fetches", 0)), blocking_fetches=blocking,
                blocking_per_advance=blocking / adv,
                host_block_ms=float(st.get("host_block_ms", 0.0)))


def run_solo(depth: int, device: DeviceLike = None,
             host_work_us: float = HOST_WORK_US):
    """The solo wave drain at ``depth``: ``(sim, row)``."""
    dev = resolve_device(device)
    ev, ec, ew, cb, sizes = build_wave_arrays(**STAGE)
    with opstats.scoped(f"pipeline/solo-d{depth}") as st:
        t0 = time.perf_counter()
        sim = DrainSim(ev, ec, ew, cb, sizes, eps=EPS, dtype=np.float64,
                       repack_min=1 << 62, superstep=SUPERSTEP,
                       pipeline=depth, device=dev)
        if host_work_us:
            sim.on_batches = lambda bs: spin(host_work_us * len(bs))
        sim.run()
        wall = time.perf_counter() - t0
    row = dict(workload="solo-wave", n_v=len(sizes), depth=depth,
               superstep=SUPERSTEP, host_work_us=host_work_us,
               advances=sim.advances, supersteps=sim.supersteps,
               **_fetch_row(st, sim.advances), wall_ms=wall * 1e3,
               spec_issued=sim.spec_issued,
               spec_committed=sim.spec_committed,
               spec_rolled_back=sim.spec_rolled_back,
               spec_commit_rate=(sim.spec_committed / sim.spec_issued
                                 if sim.spec_issued else None),
               loop_builds=sim.loop_builds, device=str(dev))
    return sim, row


def fleet_campaign(device: DeviceLike = None) -> Campaign:
    """The fleet-wave campaign: ``REPLICAS`` bandwidth scales, each with
    two element weights of its own."""
    ev, ec, ew, cb, sizes = build_wave_arrays(**STAGE)
    E = len(ev)
    specs = [ScenarioSpec(seed=s, bw_scale=1.0 + 0.01 * (s % 37),
                          elem_w={(5 * s) % E: 1.5, (5 * s + 2) % E: 0.5})
             for s in range(REPLICAS)]
    return Campaign(ev, ec, ew, cb, sizes, specs, eps=EPS,
                    dtype=np.float64, superstep=SUPERSTEP,
                    device=resolve_device(device))


def run_fleet(camp: Campaign, depth: int):
    """The fleet wave at ``depth`` as one fleet: ``(results, row)``."""
    with opstats.scoped(f"pipeline/fleet-d{depth}") as st:
        t0 = time.perf_counter()
        sim = camp.plan.executor(camp.specs, pipeline=depth)
        sim.run()
        wall = time.perf_counter() - t0
    adv = sum(r.advances for r in sim.replicas)
    E = len(camp.e_var)
    row = dict(workload="fleet-wave", n_v=int(sim.n_v), depth=depth,
               superstep=SUPERSTEP, replicas=sim.B, advances=adv,
               supersteps=sim.supersteps, **_fetch_row(st, adv),
               wall_ms=wall * 1e3,
               spec_issued=int(st.get("speculations_issued", 0)),
               spec_committed=int(st.get("speculations_committed", 0)),
               spec_rolled_back=int(st.get("speculations_rolled_back", 0)),
               loop_builds=sim.loop_builds,
               elem_w_payload_bytes=int(st.get("uploaded_bytes_delta", 0)),
               elem_w_dense_bytes=sim.B * E * 8,
               device=str(camp.plan.device))
    return [(r.events, r.t) for r in sim.replicas], row


def recorded_mismatch(row: Dict) -> List[str]:
    """The counts of ``row`` that differ from :data:`RECORDED`."""
    adv, ss, fetches, spec = RECORDED[row["workload"]][row["depth"]]
    got = (row["advances"], row["fetches"], (row["spec_issued"],
                                             row["spec_committed"],
                                             row["spec_rolled_back"]))
    bad = [f"{k}: {g} != {w}" for k, g, w in zip(
        ("advances", "fetches", "speculations"), got, (adv, fetches, spec))
        if g != w]
    if ss is not None and row["supersteps"] != ss:
        bad.append(f"supersteps: {row['supersteps']} != {ss}")
    return bad


def run_stage(device: DeviceLike = None, depths=DEPTHS,
              host_work_us: float = HOST_WORK_US) -> Dict:
    """Both workloads at every depth (after one unscoped solo run that
    builds the kernels): the rows, whether every depth gave the same
    events and clocks, and each row's mismatches with the recorded
    counts."""
    dev = resolve_device(device)
    run_solo(0, dev, host_work_us)
    rows, solo, fleet = [], {}, {}
    for d in depths:
        sim, row = run_solo(d, dev, host_work_us)
        solo[d] = (sim.events, sim.t)
        rows.append(row)
    camp = fleet_campaign(dev)
    for d in depths:
        fleet[d], row = run_fleet(camp, d)
        rows.append(row)
    consistent = (all(v == solo[depths[0]] for v in solo.values())
                  and all(v == fleet[depths[0]] for v in fleet.values()))
    return dict(rows=rows, events_consistent=consistent,
                mismatches={f"{r['workload']}-d{r['depth']}":
                            recorded_mismatch(r) for r in rows})
