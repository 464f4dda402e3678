"""Collective fleets: what-if sweeps of one compiled collective.

A collective what-if study compiles one collective (algorithm x ranks x
topology) once and sweeps it over bandwidth, link and size overrides and
fault campaigns, each scenario a replica of one fleet
(``Campaign.for_collective``: every replica walks the shared schedule
with its own DAG state).  This module builds such fleets over
``collective_run.CASES`` (``bench.py``'s collective stage) and runs them:

* :func:`fleet_specs`: the mix, at fleet width ``width``: the first half
  sweeps ``bw_scale`` (the plain scenario first, then 0.5 to 2.0), a
  quarter scales rank 0's NIC uplink (``link_scale``, 0.25 to 1.0), a
  quarter carries fault campaigns (``fault_mode="on"``) over every used
  link at seeds 42, 43, ..., MTBF ``20 t_end``, MTTR ``0.1 t_end`` and
  horizon ``t_end`` (``t_end`` the case's completion date), failures
  clamped to 5% of the link's bound;
* :func:`fleet_campaign`: the fleet through the port's
  ``Campaign.for_collective``; ``fleet_run.run_fleet_full`` drains it
  (wall, wall per replica, supersteps, dispatches, rounds, loop builds,
  completions, activations, fault fires, kernel launches) and
  ``fleet_run.launches_per_superstep`` counts its launches;
* :func:`fires_before_end` and :func:`same_lane`: what a lane is held
  to (fires before its last completion; completions, activations, fault
  events, the clock and the Kahan pair).

Every entry point runs on the card unless given ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..collectives import CollectiveSpec
from ..device import DeviceLike, resolve_device
from ..parallel.campaign import Campaign, ScenarioSpec
from .collective_run import SUPERSTEP

#: the solve eps of ``bench.py``'s collective stage (the tape drain's
#: ``DrainSim`` default), so the plain replica is that stage's drain
EPS = 1e-5
#: the fault campaign's seeds start here
FAULT_SEED = 42


def fleet_specs(cs: CollectiveSpec, t_end: float, width: int
                ) -> List[ScenarioSpec]:
    """The module docstring's mix of ``width`` scenarios (a multiple of
    4) of collective ``cs`` whose plain drain ends at ``t_end``."""
    if width % 4:
        raise ValueError("the fleet's width must be a multiple of 4")
    n_bw, n_link = width // 2, width // 4
    bw = [1.0] + [float(x) for x in np.linspace(0.5, 2.0, n_bw - 1)]
    specs = [ScenarioSpec(seed=i, bw_scale=s, collective=cs,
                          label="plain" if i == 0 else f"bw{s:g}")
             for i, s in enumerate(bw)]
    specs += [ScenarioSpec(seed=n_bw + i, link_scale={0: float(f)},
                           collective=cs, label=f"uplink0x{f:g}")
              for i, f in enumerate(np.linspace(0.25, 1.0, n_link))]
    specs += [ScenarioSpec(seed=FAULT_SEED + i, fault_mtbf=20.0 * t_end,
                           fault_mttr=0.1 * t_end, fault_horizon=t_end,
                           collective=cs, label=f"fault{FAULT_SEED + i}")
              for i in range(width - n_bw - n_link)]
    return specs


def fleet_campaign(cs: CollectiveSpec, specs: List[ScenarioSpec],
                   device: DeviceLike = None,
                   superstep: int = SUPERSTEP) -> Campaign:
    """``specs`` over the compiled ``cs``, float64, fault mode ``on``."""
    return Campaign.for_collective(cs, specs, eps=EPS, dtype=np.float64,
                                   superstep=superstep, fault_mode="on",
                                   device=resolve_device(device))


def fires_before_end(rep) -> int:
    """Fault fires of a replica at or before its last completion."""
    if not rep.events:
        return 0
    end = rep.events[-1][0]
    return sum(1 for t, _ in rep.fault_events if t <= end)


def lane_record(rep) -> Dict:
    """What a lane is held to: completions, activations, fault events and
    the clock."""
    return dict(events=rep.events, collective_events=rep.collective_events,
                fault_events=rep.fault_events, t=rep.t)


def same_lane(a, b, pair_a: Optional[tuple] = None,
              pair_b: Optional[tuple] = None) -> bool:
    """Two lanes (replicas or solo results) equal by bits, and their
    Kahan pairs where both are given."""
    return (lane_record(a) == lane_record(b)
            and (pair_a is None or pair_b is None or pair_a == pair_b))
