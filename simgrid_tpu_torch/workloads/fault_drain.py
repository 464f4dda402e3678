"""Faulted drains: a seeded link-failure campaign over a drain system's
used links, compiled to the superstep's device event tape.

* :func:`tape_for` compiles that tape for a plain system (no sweep
  overrides): the port's ``ScenarioPlan.tape_for``
  (:mod:`simgrid_tpu_torch.parallel.campaign`) of a neutral spec, so the
  tape code exists once.  One link per used constraint
  (``e_cnst[e_w > 0]``), registered in slot order under its engine name,
  so the RNG substream layout is a pure function of the system and the
  seed; failures clamp the link to ``MIN_LINK_FACTOR`` of its bound,
  recoveries restore it, and the tape values are absolute bounds;
* :func:`run_fault_drain` drains a system under a tape, with the tape's
  counters beside the drain's (``drain_run.run_drain``'s row).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..parallel.campaign import MIN_LINK_FACTOR, ScenarioPlan, ScenarioSpec
from .drain_run import run_drain

__all__ = ["MIN_LINK_FACTOR", "Tape", "used_links", "tape_for",
           "run_fault_drain"]

Tape = Tuple[np.ndarray, np.ndarray, np.ndarray]


def used_links(e_cnst, e_w, n_c: int) -> np.ndarray:
    """Constraint slots that carry an element of positive weight."""
    used = np.zeros(n_c, bool)
    used[np.asarray(e_cnst)[np.asarray(e_w) > 0]] = True
    return np.flatnonzero(used)


def tape_for(e_cnst, e_w, c_bound, seed: int, horizon: float, mtbf: float,
             mttr: float, dist: str = "exponential", shape: float = 1.0,
             link_names: Optional[Sequence[Optional[str]]] = None
             ) -> Optional[Tape]:
    """The device event tape ``(dates f64, constraint slots i32, new
    bounds f64)`` of the seeded campaign over the used links (a slot
    without a name is ``link<slot>``), or None when it is empty."""
    e_cnst = np.asarray(e_cnst)
    plan = ScenarioPlan(np.zeros(len(e_cnst), np.int32), e_cnst, e_w,
                        c_bound, np.zeros(0), link_names=link_names,
                        fault_mode="on")
    return plan.tape_for(ScenarioSpec(
        seed=seed, fault_mtbf=mtbf, fault_mttr=mttr, fault_dist=dist,
        fault_shape=shape, fault_horizon=horizon))


def run_fault_drain(system, tape: Optional[Tape], **kw):
    """Drain ``system`` under ``tape`` (arguments as
    ``drain_run.make_sim``; ``superstep=K`` is required with a tape).
    Returns the drain and ``run_drain``'s row with the tape's slots,
    entries fired before the drain ended and ``fault_events``."""
    sim, row = run_drain(system, tape=tape, **kw)
    row["tape_slots"] = 0 if tape is None else len(tape[0])
    row["fires"] = len(sim.fault_events)
    return sim, row
