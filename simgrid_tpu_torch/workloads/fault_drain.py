"""Faulted drains: a seeded link-failure campaign over a drain system's
used links, compiled to the superstep's device event tape.

The port's counterpart of ``simgrid_tpu/parallel/campaign.py``
``ScenarioPlan.tape_for`` for a plain system (no sweep overrides): a
:class:`~simgrid_tpu_torch.faults.FaultCampaign` with one link per used
constraint (``e_cnst[e_w > 0]``), registered in slot order under its
engine name, so the RNG substream layout is a pure function of the
system and the seed; failures clamp the link to ``MIN_LINK_FACTOR`` of
its bound, recoveries restore it, and the tape values are absolute
bounds.

* :func:`tape_for` compiles that tape;
* :func:`run_fault_drain` drains a system under a tape, with the tape's
  counters beside the drain's (``drain_run.run_drain``'s row).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..faults import FaultCampaign
from .drain_run import run_drain

#: a fully failed link would zero its capacity and stall every flow
#: routed over it; failures clamp the bound to this factor
MIN_LINK_FACTOR = 0.05

Tape = Tuple[np.ndarray, np.ndarray, np.ndarray]


def used_links(e_cnst, e_w, n_c: int) -> np.ndarray:
    """Constraint slots that carry an element of positive weight."""
    used = np.zeros(n_c, bool)
    used[np.asarray(e_cnst)[np.asarray(e_w) > 0]] = True
    return np.flatnonzero(used)


def tape_for(e_cnst, e_w, c_bound, seed: int, horizon: float, mtbf: float,
             mttr: float, dist: str = "exponential", shape: float = 1.0,
             link_names: Optional[Sequence[Optional[str]]] = None,
             floor: float = MIN_LINK_FACTOR) -> Optional[Tape]:
    """The device event tape ``(dates f64, constraint slots i32, new
    bounds f64)`` of the seeded campaign over the used links (a slot
    without a name is ``link<slot>``), or None when it is empty."""
    cb = np.asarray(c_bound, np.float64)
    fc = FaultCampaign(seed=seed, horizon=horizon)
    names: Dict[str, int] = {}
    for slot in used_links(e_cnst, e_w, len(cb)):
        slot = int(slot)
        name = (str(link_names[slot]) if link_names is not None
                and slot < len(link_names) and link_names[slot]
                else f"link{slot}")
        names[name] = slot
        fc.add_link(name, mtbf=mtbf, mttr=mttr, dist=dist, shape=shape)
    entries = fc.compile_tape(floor=floor)
    if not entries:
        return None
    t = np.empty(len(entries), np.float64)
    s = np.empty(len(entries), np.int32)
    v = np.empty(len(entries), np.float64)
    for i, (date, _kind, name, factor) in enumerate(entries):
        slot = names[name]
        t[i] = date
        s[i] = slot
        v[i] = cb[slot] * factor
    return t, s, v


def run_fault_drain(system, tape: Optional[Tape], **kw):
    """Drain ``system`` under ``tape`` (arguments as
    ``drain_run.make_sim``; ``superstep=K`` is required with a tape).
    Returns the drain and ``run_drain``'s row with the tape's slots,
    entries fired before the drain ended and ``fault_events``."""
    sim, row = run_drain(system, tape=tape, **kw)
    row["tape_slots"] = 0 if tape is None else len(tape[0])
    row["fires"] = len(sim.fault_events)
    return sim, row
