#!/usr/bin/env python3
"""The faulted config-#4 drain at full width: JAX against the port.

Builds ``chip_smoke.py``'s phase-13 drain (the 100,000 random flows of
config #4 on the 65,536-host dragonfly, float64, superstep 16) and its
seeded fault campaign (seed 42, horizon 2 s, exponential MTBF 100 s,
MTTR 0.1 s, failures clamped to 5% of a link's bound), then drains it
twice on the host CPU: with the JAX package's ``DrainSim(tape=)`` and
with the port's ``DrainSim(tape=)`` on its plain path (``device="cpu"``).
Each leg runs superstep by superstep under a wall budget
(``--budget-s``); a leg that runs out stops where it is.  Prints one JSON
row per leg (advances, supersteps, events, fault events, the clock, the
wall seconds, whether it finished) and one row comparing them: the
common prefix of the completion and fault streams, and whether the two
legs are equal by bits.  ``--last-fire`` adds, per leg, the date of the
last fire and of the last completion, how many fires came before the
last completion, the flow that completed last, its links, and the fires
on those links.  ``--legs`` picks the legs (``jax``, ``port_plain``).

Usage:
  JAX_PLATFORMS=cpu python tools/torch_parity_fault_drain.py
         [--flows 100000] [--budget-s 1800] [--last-fire]
         [--legs jax,port_plain] [--out FILE.jsonl]

It imports both packages, so it runs where JAX is installed (the host
CPU), never on the card.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: chip_smoke.py's FAULT (phase 13) and superstep K
FAULT = dict(seed=42, horizon=2.0, mtbf=100.0, mttr=0.1)
K = 16


def run_leg(sim, step, budget_s: float) -> dict:
    """Drain ``sim`` by ``step(sim)`` calls (one superstep each) until
    no flow is live or ``budget_s`` seconds have passed."""
    t0 = time.perf_counter()
    n = sim.n_v
    while n:
        if time.perf_counter() - t0 > budget_s:
            break
        n = step(sim)
    wall = time.perf_counter() - t0
    return dict(finished=n == 0, live=int(n), advances=sim.advances,
                supersteps=sim.supersteps, events=len(sim.events),
                fault_events=len(sim.fault_events), t_sim=sim.t,
                wall_s=wall)


def jax_step(sim) -> int:
    """One step of the JAX ``DrainSim.run`` superstep loop."""
    before = sim.advances
    n, _ = sim.superstep_batch(k=sim.superstep_k, donate=True)
    if n and sim.advances == before:
        n = sim._rescue_one()
    return n


def port_step(sim) -> int:
    return sim.superstep_step()


def common_prefix(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def fire_timing(sim, system) -> dict:
    """When the fires came against the last completion, and which of
    them hit the links of the flow that completed last."""
    import numpy as np
    last_ev = sim.events[-1][0] if sim.events else None
    last_fire = sim.fault_events[-1][0] if sim.fault_events else None
    before = (sum(1 for t, _ in sim.fault_events if t <= last_ev)
              if last_ev is not None else 0)
    row = dict(last_completion=last_ev, last_fire=last_fire,
               fires_before_last_completion=before)
    if sim.events:
        last = sim.events[-1][1]
        on = (np.asarray(system.e_var) == last) & (np.asarray(system.e_w)
                                                   > 0)
        links = sorted(int(c) for c in np.asarray(system.e_cnst)[on])
        row.update(last_flow=int(last), last_flow_links=links,
                   fires_on_last_flow_links=[
                       [t, s] for t, s in sim.fault_events if s in links])
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--flows", type=int, default=100_000)
    ap.add_argument("--budget-s", type=float, default=1800.0)
    ap.add_argument("--last-fire", action="store_true")
    ap.add_argument("--legs", default="jax,port_plain")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import numpy as np
    from simgrid_tpu.ops.lmm_drain import DrainSim as JaxDrainSim
    from simgrid_tpu_torch.ops.lmm_drain import DrainSim
    from simgrid_tpu_torch.workloads import dragonfly, drain_run, fault_drain

    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")

    t0 = time.perf_counter()
    dsys = dragonfly.build_system(args.flows)
    tape = fault_drain.tape_for(dsys.e_cnst, dsys.e_w, dsys.c_bound,
                                link_names=dragonfly.link_names(dsys),
                                **FAULT)
    emit(dict(leg="setup", flows=args.flows, n_cnst=len(dsys.c_bound),
              n_elem=len(dsys.e_var), tape_slots=len(tape[0]),
              build_s=time.perf_counter() - t0, **FAULT, superstep=K))
    kw = dict(eps=drain_run.EPS, done_eps=drain_run.DONE_EPS,
              dtype=np.float64, superstep=K, superstep_rounds=K * 512,
              tape=tape)
    sims = {}
    legs = args.legs.split(",")
    for leg, cls, step, extra in (
            ("jax", JaxDrainSim, jax_step, {}),
            ("port_plain", DrainSim, port_step, dict(device="cpu"))):
        if leg not in legs:
            continue
        sim = cls(dsys.e_var, dsys.e_cnst, dsys.e_w, dsys.c_bound,
                  dsys.sizes, **kw, **extra)
        row = dict(leg=leg, **run_leg(sim, step, args.budget_s))
        if args.last_fire:
            row.update(fire_timing(sim, dsys))
        emit(row)
        sims[leg] = sim
    if len(sims) < 2:
        return 0
    j, p = sims["jax"], sims["port_plain"]
    done = all(r.get("finished") for r in rows[1:])
    emit(dict(leg="compare",
              events_prefix_equal=common_prefix(j.events, p.events),
              fault_prefix_equal=common_prefix(j.fault_events,
                                               p.fault_events),
              both_finished=done,
              equal=done and j.events == p.events
              and j.fault_events == p.fault_events and j.t == p.t
              and j.advances == p.advances))
    return 0


if __name__ == "__main__":
    sys.exit(main())
