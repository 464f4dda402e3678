"""Time-stamped resource profiles ("traces") + the future event set.

The port's copy of ``simgrid_tpu/kernel/profile.py``.

Semantics from the reference's src/kernel/resource/profile/: profiles are
delta-encoded streams of (date, value) events attached to resources
(availability, bandwidth, latency, on/off state); the FutureEvtSet is the
heap of upcoming profile events consumed by surf_solve.  Formats accepted:
the reference's trace files (``date value`` lines, ``PERIODICITY x`` /
``LOOPAFTER x`` directives, ``#``/``%`` comments).
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

from ..exceptions import ParseError


class DatedValue:
    __slots__ = ("date", "value")

    def __init__(self, date: float = 0.0, value: float = 0.0):
        self.date = date
        self.value = value

    def __eq__(self, other):
        return (abs(self.date - other.date) < 1e-9
                and abs(self.value - other.value) < 1e-9)

    def __repr__(self):
        return f"DatedValue({self.date}, {self.value})"


class Event:
    __slots__ = ("profile", "idx", "resource", "free_me")

    def __init__(self, profile: "Profile", resource):
        self.profile = profile
        self.idx = 0
        self.resource = resource
        self.free_me = False


#: Registry of named profiles (the reference's trace_list), filled both by
#: platform files' <trace> tags and from_file/from_string.
trace_list: Dict[str, "Profile"] = {}


class Profile:
    """Delta-encoded event stream; event_list[0] is a placeholder whose date
    is patched to the loop-back delta (reference Profile.cpp:26-31)."""

    def __init__(self):
        self.event_list: List[DatedValue] = [DatedValue(0, -1)]
        self.fes: Optional[FutureEvtSet] = None

    def schedule(self, fes: "FutureEvtSet", resource) -> Event:
        event = Event(self, resource)
        self.fes = fes
        fes.add_event(0.0, event)
        return event

    def next(self, event: Event, event_date: float) -> DatedValue:
        """Advance the stream past `event` (which just fired at
        `event_date`) and reschedule the follow-up occurrence.  The
        reference reads the date off the heap top (Profile.cpp:53) because
        it pops only afterwards; we take it as an argument instead."""
        date_val = self.event_list[event.idx]
        if event.idx < len(self.event_list) - 1:
            self.fes.add_event(event_date + date_val.date, event)
            event.idx += 1
        elif date_val.date > 0:  # last element: loop
            self.fes.add_event(event_date + date_val.date, event)
            event.idx = 1
        else:
            event.free_me = True
        return date_val

    @staticmethod
    def from_string(name: str, input_str: str, periodicity: float = -1.0
                    ) -> "Profile":
        if name in trace_list:
            raise ParseError(f"Refusing to define trace '{name}' twice")
        profile = Profile()
        last_event = profile.event_list[-1]
        for lineno, raw in enumerate(input_str.replace("\r", "\n").split("\n"), 1):
            line = raw.strip()
            if not line or line[0] in "#%":
                continue
            parts = line.split()
            if parts[0] in ("PERIODICITY", "LOOPAFTER") and len(parts) == 2:
                periodicity = float(parts[1])
                continue
            if len(parts) != 2:
                raise ParseError(f"{name}:{lineno}: syntax error in trace: {line!r}")
            event = DatedValue(float(parts[0]), float(parts[1]))
            if last_event.date > event.date:
                raise ParseError(
                    f"{name}:{lineno}: invalid trace: events must be sorted "
                    f"({last_event.date} > {event.date})")
            last_event.date = event.date - last_event.date
            profile.event_list.append(event)
            last_event = event
        if periodicity > 0:
            last_event.date = periodicity + profile.event_list[0].date
        else:
            last_event.date = -1
        trace_list[name] = profile
        return profile

    @staticmethod
    def from_dated_values(name: str, points, periodicity: float = -1.0,
                          register: bool = False) -> "Profile":
        """Build a profile from in-memory (date, value) pairs — the
        programmatic analog of from_string, used by fault campaigns to
        compile generated failure schedules into the same delta-encoded
        stream the platform traces flow through."""
        if register and name in trace_list:
            raise ParseError(f"Refusing to define trace '{name}' twice")
        profile = Profile()
        last_event = profile.event_list[-1]
        for date, value in points:
            event = DatedValue(float(date), float(value))
            if last_event.date > event.date:
                raise ParseError(
                    f"{name}: invalid schedule: events must be sorted "
                    f"({last_event.date} > {event.date})")
            last_event.date = event.date - last_event.date
            profile.event_list.append(event)
            last_event = event
        if periodicity > 0:
            last_event.date = periodicity + profile.event_list[0].date
        else:
            last_event.date = -1
        if register:
            trace_list[name] = profile
        return profile

    @staticmethod
    def from_file(path: str) -> "Profile":
        if not path:
            raise ParseError("Cannot parse a trace from an empty filename")
        with open(path) as f:
            return Profile.from_string(path, f.read(), -1.0)


class FutureEvtSet:
    """Heap of upcoming profile events (reference FutureEvtSet.cpp)."""

    def __init__(self):
        self._heap: List[Tuple[float, int, Event]] = []
        self._seq = 0

    def add_event(self, date: float, event: Event) -> None:
        heapq.heappush(self._heap, (date, self._seq, event))
        self._seq += 1

    def next_date(self) -> float:
        return self._heap[0][0] if self._heap else -1.0

    def pop_leq(self, date: float):
        """Pop the next event occurring at or before `date`; returns
        (event, value, resource) or None."""
        if not self._heap or self._heap[0][0] > date:
            return None
        event_date, _, event = heapq.heappop(self._heap)
        date_val = event.profile.next(event, event_date)
        return event, date_val.value, event.resource

    def empty(self) -> bool:
        return not self._heap


def clear_trace_registry() -> None:
    trace_list.clear()
