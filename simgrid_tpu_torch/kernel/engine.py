"""The simulation engine's resource half: models, clock, time advance.

The port's copy of the resource half of ``simgrid_tpu/kernel/engine.py``
``EngineImpl``: the models and the clock, the future event set of the
profiles, timers, the host/link/netpoint registries and ``surf_solve``,
the time advance (reference surf_solve, src/surf/surf_c_bindings.cpp:
45-151): jump simulated time to the next action completion (the
min-reduction over models, solved by the LMM backend on the engine's
device), apply profile events and update the actions' states.

Actors are not ported yet (ROADMAP queue A, item A3b): ``create_actor``
and ``run`` raise.  The caller steps the engine itself, as the JAX
package's engine tests do: post actions through the models, then loop
``surf_solve`` and each model's ``extract_done_action``.
"""

from __future__ import annotations

import heapq
from typing import Callable, Dict, List

from ..device import DeviceLike, resolve_device
from ..utils.signal import Signal
from .profile import FutureEvtSet

_A3B = "ROADMAP queue A, item A3b (actors, EngineImpl.run)"


class Timer:
    """A host-side timer fired at an absolute simulated date
    (reference simix::Timer, smx_global.cpp:120-146)."""

    _cancelled = False

    def __init__(self, date: float, callback: Callable[[], None]):
        self.date = date
        self.callback = callback

    def remove(self) -> None:
        self._cancelled = True


class EngineImpl:
    """The kernel: owns the models, timers, registries and clock.
    ``device`` is where every model's System solves (``resolve_device``:
    the card unless ``"cpu"`` is asked for)."""

    on_time_advance = Signal()
    on_platform_created = Signal()

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.now = 0.0
        self.models: List = []            # all_existing_models
        self.host_model = None
        self.cpu_model = None
        self.network_model = None
        self.storage_model = None
        self.vm_model = None
        self.future_evt_set = FutureEvtSet()
        self.watched_hosts: set = set()
        self._timers: List = []  # heap of (date, seq, Timer)
        self._timer_seq = 0
        self.netpoints: Dict[str, object] = {}
        self.hosts: Dict[str, object] = {}
        self.links: Dict[str, object] = {}
        self.storages: Dict[str, object] = {}
        self.netzone_root = None

    def add_model(self, model) -> None:
        self.models.append(model)

    # -- actors (not ported) ---------------------------------------------
    def create_actor(self, name: str, host, code: Callable,
                     daemonize: bool = False):
        raise NotImplementedError(f"actors are not ported yet ({_A3B})")

    def run(self, until: float = -1.0) -> None:
        raise NotImplementedError(
            "EngineImpl.run schedules actors, which are not ported yet "
            f"({_A3B}); step the engine with surf_solve")

    # -- timers ----------------------------------------------------------
    def timer_set(self, date: float, callback: Callable[[], None]) -> Timer:
        timer = Timer(date, callback)
        heapq.heappush(self._timers, (date, self._timer_seq, timer))
        self._timer_seq += 1
        return timer

    def next_timer_date(self) -> float:
        while self._timers and self._timers[0][2]._cancelled:
            heapq.heappop(self._timers)
        return self._timers[0][0] if self._timers else -1.0

    def execute_timers(self) -> bool:
        """Fire every timer due at the current date; True if one fired."""
        result = False
        while self._timers and self.now >= self._timers[0][0]:
            _, _, timer = heapq.heappop(self._timers)
            if timer._cancelled:
                continue
            result = True
            timer.callback()
        return result

    # ------------------------------------------------------------------
    # surf_solve: the time-advance (surf_c_bindings.cpp:45-151)
    # ------------------------------------------------------------------
    def surf_solve(self, max_date: float) -> float:
        time_delta = -1.0
        # >= 0: a bound AT the current date (run_until(now), timers at
        # t=0) means a zero-length advance, not an unbounded one
        if max_date >= 0.0:
            assert max_date >= self.now, \
                f"You asked to simulate up to {max_date} but that's in the past"
            time_delta = max_date - self.now

        # Physical models first: host composes cpu+network+storage.
        next_event_phy = self.host_model.next_occurring_event(self.now)
        if (time_delta < 0.0 or next_event_phy < time_delta) and next_event_phy >= 0.0:
            time_delta = next_event_phy
        if self.vm_model is not None:
            next_event_virt = self.vm_model.next_occurring_event(self.now)
            if (time_delta < 0.0 or next_event_virt < time_delta) and next_event_virt >= 0.0:
                time_delta = next_event_virt
        for model in self.models:
            if model in (self.host_model, self.vm_model, self.network_model,
                         self.storage_model, self.cpu_model):
                continue
            next_event_model = model.next_occurring_event(self.now)
            if (time_delta < 0.0 or next_event_model < time_delta) and next_event_model >= 0.0:
                time_delta = next_event_model

        # Stalled-resume upgrade over the reference: if no action can ever
        # complete (time_delta < 0, e.g. every flow parked on a
        # zero-bandwidth link) but actions are running and a future profile
        # event could unblock them, jump to that event instead of
        # deadlocking (the reference bails out here, surf_c_bindings.cpp:
        # 128-134).
        if time_delta < 0.0:
            next_event_date = self.future_evt_set.next_date()
            if next_event_date >= 0.0 and any(
                    model.started_action_set for model in self.models):
                time_delta = next_event_date - self.now

        # Consume profile events up to the chosen horizon.
        while True:
            next_event_date = self.future_evt_set.next_date()
            if not self.network_model.next_occurring_event_is_idempotent():
                # ns-3-style co-simulation backend hook
                if next_event_date != -1.0:
                    time_delta = min(next_event_date - self.now, time_delta)
                else:
                    time_delta = max(next_event_date - self.now, time_delta)
                model_next_action_end = self.network_model.next_occurring_event(time_delta)
                if model_next_action_end >= 0.0:
                    time_delta = model_next_action_end
            if next_event_date < 0.0 or next_event_date > self.now + time_delta:
                break
            while True:
                popped = self.future_evt_set.pop_leq(next_event_date)
                if popped is None:
                    break
                event, value, resource = popped
                if value < 0:
                    # Profile idx-0 placeholder (value -1, Profile.cpp:26-31):
                    # skipped so traces starting at t>0 keep the platform
                    # value until their first real event.
                    continue
                if (resource.is_used()
                        or resource.name in self.watched_hosts):
                    time_delta = next_event_date - self.now
                round_start = self.now
                self.now = next_event_date
                resource.apply_event(event, value)
                self.now = round_start

        if time_delta < 0:
            return -1.0

        self.now += time_delta
        for model in self.models:
            model.update_actions_state(self.now, time_delta)
        EngineImpl.on_time_advance(time_delta)
        return time_delta
