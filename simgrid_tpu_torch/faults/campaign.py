"""Deterministic fault-injection campaigns, compiled to device tapes.

The port's copy of ``simgrid_tpu/faults/campaign.py`` ``FaultCampaign``:
per-resource MTBF/MTTR distributions turned into explicit
failure/recovery schedules from seeded RngStream draws (one substream
per resource, assigned in sorted name order, so each resource's event
stream is independent of every other resource's draw count and of
insertion order), and flattened into the time-sorted event tape the
drain's superstep consults between advances.  Identical seeds give
bit-identical schedules, and the same bits as the reference's.

The reference also attaches a schedule to a live engine as state or
bandwidth Profiles (``schedule``, ``schedule_degrade``); the port has no
engine yet, so those two are not here.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from ..utils.rngstream import RngStream, seeded_stream

#: supported inter-event distributions
DISTRIBUTIONS = ("exponential", "weibull", "fixed")


def _draw(rng: RngStream, dist: str, mean: float, shape: float) -> float:
    """One inter-event delay by inverse-CDF sampling (u in [0,1))."""
    if dist == "fixed":
        return mean
    u = rng.rand_u01()
    if dist == "exponential":
        return -mean * math.log(1.0 - u)
    # weibull, parameterized by its mean: scale = mean / Gamma(1 + 1/shape)
    scale = mean / math.gamma(1.0 + 1.0 / shape)
    return scale * (-math.log(1.0 - u)) ** (1.0 / shape)


class _Spec:
    __slots__ = ("kind", "name", "mtbf", "mttr", "dist", "shape")

    def __init__(self, kind: str, name: str, mtbf: float, mttr: float,
                 dist: str, shape: float):
        if dist not in DISTRIBUTIONS:
            raise ValueError(f"Unknown distribution {dist!r} "
                             f"(expected one of {DISTRIBUTIONS})")
        if mtbf <= 0 or mttr <= 0:
            raise ValueError(f"{kind} '{name}': MTBF and MTTR must be > 0")
        if shape <= 0:
            raise ValueError(f"{kind} '{name}': weibull shape must be > 0")
        self.kind = kind
        self.name = name
        self.mtbf = mtbf
        self.mttr = mttr
        self.dist = dist
        self.shape = shape


def _check_floor(floor: float) -> float:
    floor = float(floor)
    if not 0.0 < floor <= 1.0:
        raise ValueError("floor must be in (0, 1]")
    return floor


class FaultCampaign:
    """A seeded host/link failure+recovery schedule generator.

    Usage::

        campaign = FaultCampaign(seed=42, horizon=2.0)
        campaign.add_link("backbone", mtbf=100.0, mttr=0.1)
        tape = campaign.compile_tape(floor=0.05)

    :meth:`fork` returns a fresh campaign with the same resource specs
    and an optionally offset seed (``fork()`` reproduces this campaign
    bit for bit, ``fork(seed_offset=k)`` is replica k's independent
    draw).  :meth:`generate`, :meth:`mean_availability`,
    :meth:`compile_tape` and :meth:`tape_len` are pure and repeatable.
    """

    def __init__(self, seed: int = 0, horizon: float = 1000.0):
        if horizon <= 0:
            raise ValueError("horizon must be > 0")
        self.seed = int(seed)
        self.horizon = float(horizon)
        self._specs: Dict[Tuple[str, str], _Spec] = {}
        self._events: Optional[Dict[Tuple[str, str],
                                    List[Tuple[float, float]]]] = None

    # -- declaration -------------------------------------------------------
    def _add(self, kind: str, resource, mtbf: float, mttr: float,
             dist: str, shape: float) -> "FaultCampaign":
        name = getattr(resource, "name", resource)
        self._specs[(kind, str(name))] = _Spec(kind, str(name), mtbf, mttr,
                                               dist, shape)
        self._events = None     # invalidate any generated schedule
        return self

    def add_host(self, host, mtbf: float, mttr: float,
                 dist: str = "exponential", shape: float = 1.0
                 ) -> "FaultCampaign":
        """Declare a host to fail with the given mean time between
        failures and mean time to repair (a host object or its name)."""
        return self._add("host", host, mtbf, mttr, dist, shape)

    def add_link(self, link, mtbf: float, mttr: float,
                 dist: str = "exponential", shape: float = 1.0
                 ) -> "FaultCampaign":
        """Declare a link to fail (a link object or its name)."""
        return self._add("link", link, mtbf, mttr, dist, shape)

    def fork(self, seed_offset: int = 0) -> "FaultCampaign":
        """A fresh campaign with the same horizon and resource specs and
        seed ``self.seed + seed_offset``."""
        out = FaultCampaign(seed=self.seed + int(seed_offset),
                            horizon=self.horizon)
        for (kind, name), spec in sorted(self._specs.items()):
            out._add(kind, name, spec.mtbf, spec.mttr, spec.dist,
                     spec.shape)
        return out

    # -- generation --------------------------------------------------------
    def generate(self) -> Dict[Tuple[str, str], List[Tuple[float, float]]]:
        """Generate (and cache) the event schedule: a sorted-by-resource
        dict of ``(kind, name) -> [(date, value), ...]`` with value 0.0
        for failure and 1.0 for recovery."""
        if self._events is not None:
            return self._events
        rng = seeded_stream(self.seed, "fault-campaign")
        events: Dict[Tuple[str, str], List[Tuple[float, float]]] = {}
        for key in sorted(self._specs):
            spec = self._specs[key]
            rng.reset_next_substream()
            points: List[Tuple[float, float]] = []
            t = 0.0
            while True:
                t += _draw(rng, spec.dist, spec.mtbf, spec.shape)
                if t >= self.horizon:
                    break
                points.append((t, 0.0))
                t += _draw(rng, spec.dist, spec.mttr, spec.shape)
                if t >= self.horizon:
                    break
                points.append((t, 1.0))
            events[key] = points
        self._events = events
        return events

    def mean_availability(self, horizon: Optional[float] = None
                          ) -> Dict[Tuple[str, str], float]:
        """Fraction of ``[0, horizon)`` each declared resource spends UP
        under the generated schedule (the time-averaged capacity factor
        a static campaign folds into the bounds)."""
        h = self.horizon if horizon is None else float(horizon)
        if h <= 0:
            raise ValueError("horizon must be > 0")
        out: Dict[Tuple[str, str], float] = {}
        for key, points in sorted(self.generate().items()):
            down = 0.0
            fail_at: Optional[float] = None
            for date, value in points:
                if date >= h:
                    break
                if value == 0.0:
                    fail_at = date
                elif fail_at is not None:
                    down += date - fail_at
                    fail_at = None
            if fail_at is not None:
                down += h - fail_at
            out[key] = 1.0 - down / h
        return out

    def compile_tape(self, floor: float
                     ) -> List[Tuple[float, str, str, float]]:
        """Flatten the schedule into ONE time-sorted event tape of
        ``(date, kind, name, factor)`` entries: a failure degrades the
        resource's capacity to ``floor`` (a dead resource would stall a
        pure drain), a recovery restores ``factor = 1.0``.  Ties sort by
        the resource key."""
        floor = _check_floor(floor)
        tape: List[Tuple[float, str, str, float]] = []
        for (kind, name), points in sorted(self.generate().items()):
            for date, value in points:
                tape.append((date, kind, name,
                             1.0 if value > 0 else floor))
        tape.sort(key=lambda e: (e[0], e[1], e[2]))
        return tape

    def tape_len(self, floor: float = 0.05) -> int:
        """Number of entries :meth:`compile_tape` would emit (the
        tape-slot count to reserve for this campaign)."""
        _check_floor(floor)
        sched = self.generate()
        return sum(len(sched[k]) for k in sorted(sched))
