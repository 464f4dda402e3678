"""CPU models: base interface + Cas01 (the default share-based model).

The port's copy of ``simgrid_tpu/models/cpu.py``.  Semantics from the reference's src/surf/cpu_interface.cpp (CpuModel
update paths, CpuAction lazy remains) and src/surf/cpu_cas01.cpp
(constraint per core-set, one variable per execution, sleep as a
0-penalty action with max_duration, speed/state profile events).
"""

from __future__ import annotations

from typing import List, Optional

from ..kernel.resource import (Action, ActionState, Model, Resource,
                               SuspendStates, NO_MAX_DURATION, UpdateAlgo)
from ..ops import opstats
from ..ops.lmm_host import System
from ..utils.config import config
from ..utils.signal import Signal
from ..kernel import profile as profile_mod


class CpuAction(Action):
    """An execution (or sleep) on a CPU (reference cpu_interface.cpp)."""

    on_state_change = Signal()  # used by the energy/load plugins

    def update_remains_lazy(self, now: float) -> None:
        assert self.state_set is self.model.started_action_set, \
            "You're updating an action that is not running."
        assert self.sharing_penalty > 0, \
            "You're updating an action that seems suspended."
        delta = now - self.last_update
        if self.remains > 0:
            self.update_remains(self.last_value * delta)
        self.last_update = now
        self.last_value = self.variable.value

    def set_state(self, state: ActionState) -> None:
        super().set_state(state)
        CpuAction.on_state_change(self)


class CpuModel(Model):
    """Base CPU model: lazy heap pops + full sweeps (cpu_interface.cpp)."""

    def update_actions_state_lazy(self, now: float, delta: float) -> None:
        eps = config["surf/precision"]
        while (not self.action_heap.empty()
               and abs(self.action_heap.top_date() - now) < eps):
            action = self.action_heap.pop()
            action.finish(ActionState.FINISHED)

    def update_actions_state_full(self, now: float, delta: float) -> None:
        if len(self.started_action_set):
            opstats.bump("native_advances")
        # direct IntrusiveList traversal (removal-safe for the current
        # node): no O(V) list(...) allocation per advance
        for action in self.started_action_set:
            action.update_remains(action.variable.value * delta)
            action.update_max_duration(delta)
            if ((action.get_remains_no_update() <= 0
                 and action.variable.sharing_penalty > 0)
                    or (action.max_duration != NO_MAX_DURATION
                        and action.max_duration <= 0)):
                action.finish(ActionState.FINISHED)


class Cpu(Resource):
    """A host's processor: LMM constraint of capacity core_count*speed
    (reference cpu_interface.hpp + cpu_cas01.cpp)."""

    def __init__(self, model: CpuModel, host, speed_per_pstate: List[float],
                 core_count: int = 1):
        super().__init__(model, host.name,
                         model.system.constraint_new(
                             None, core_count * speed_per_pstate[0]))
        self.constraint.id = self
        self.host = host
        self.core_count = core_count
        self.speed_per_pstate = list(speed_per_pstate)
        self.pstate = 0
        self.speed_scale = 1.0   # availability-profile factor
        self.speed_peak = speed_per_pstate[0]
        self.speed_event: Optional[profile_mod.Event] = None
        self.state_event: Optional[profile_mod.Event] = None
        host.cpu = self

    # -- dynamics ---------------------------------------------------------
    def get_speed(self) -> float:
        return self.speed_peak * self.speed_scale

    def set_pstate(self, index: int) -> None:
        assert 0 <= index < len(self.speed_per_pstate), \
            f"Invalid pstate {index} (must be in [0, {len(self.speed_per_pstate)})"
        self.pstate = index
        self.speed_peak = self.speed_per_pstate[index]
        self.on_speed_change()

    def get_pstate_count(self) -> int:
        return len(self.speed_per_pstate)

    def on_speed_change(self) -> None:
        # reference CpuCas01::on_speed_change + Cpu::on_speed_change signal
        self.model.system.update_constraint_bound(
            self.constraint, self.core_count * self.speed_scale * self.speed_peak)
        for var in list(self.constraint.iter_variables()):
            action = var.id
            if action is not None:
                self.model.system.update_variable_bound(
                    action.variable,
                    getattr(action, "requested_core", 1)
                    * self.speed_scale * self.speed_peak)
        Host_on_speed_change(self.host)

    def is_used(self) -> bool:
        return self.constraint._acs_hook is not None  # constraint_used()

    def set_speed_profile(self, profile: profile_mod.Profile) -> None:
        self.speed_event = profile.schedule(self.model.engine.future_evt_set, self)

    def set_state_profile(self, profile: profile_mod.Profile) -> None:
        self.state_event = profile.schedule(self.model.engine.future_evt_set, self)
        # a profile whose first point is (0, 0) means the host exists
        # but starts OFF: apply eagerly so a deployment parsed before
        # run() already sees it down (platform-failures: Fafard's
        # '0 0' profile + 'Cannot launch actor on failed host')
        # (delta encoding: event_list[0].date is the delay before the
        # first real point, whose value sits in event_list[1])
        if (len(profile.event_list) > 1
                and profile.event_list[0].date == 0.0
                and profile.event_list[1].value == 0.0
                and self.is_on()):
            self.host.turn_off()

    def apply_event(self, event: profile_mod.Event, value: float) -> None:
        # reference CpuCas01::apply_event
        if event is self.speed_event:
            self.speed_scale = value
            self.on_speed_change()
        elif event is self.state_event:
            if value > 0:
                if not self.is_on():
                    self.host.turn_on()
            else:
                date = self.model.engine.now
                self.host.turn_off()
                for var in list(self.constraint.iter_variables()):
                    action = var.id
                    if action is not None and action.get_state() in (
                            ActionState.INITED, ActionState.STARTED,
                            ActionState.IGNORED):
                        action.finish_time = date
                        action.failure_cause = "host"
                        action.set_state(ActionState.FAILED)
        else:
            raise AssertionError("Unknown event!")

    # -- action factories -------------------------------------------------
    def execution_start(self, size: float, requested_cores: int = 1) -> CpuAction:
        raise NotImplementedError

    def sleep(self, duration: float) -> CpuAction:
        raise NotImplementedError


class CpuCas01Model(CpuModel):
    def __init__(self, engine, algo: UpdateAlgo):
        super().__init__(engine, algo)
        select = config["cpu/maxmin-selective-update"]
        if algo == UpdateAlgo.LAZY:
            assert select or config.is_default("cpu/maxmin-selective-update"), \
                "You cannot disable cpu selective update with lazy updates"
            select = True
        self.set_maxmin_system(System(select))
        if select and algo != UpdateAlgo.LAZY:
            # FULL-mode never drains the modified-actions list (see
            # NetworkCm02Model): selective bookkeeping here feeds the
            # warm-started device solve only
            self.system.modified_actions = None

    def create_cpu(self, host, speed_per_pstate: List[float],
                   core_count: int = 1) -> "CpuCas01":
        return CpuCas01(self, host, speed_per_pstate, core_count)


class CpuCas01(Cpu):
    def execution_start(self, size: float, requested_cores: int = 1) -> CpuAction:
        return CpuCas01Action(self.model, size, not self.is_on(),
                              self.speed_scale * self.speed_peak,
                              self.constraint, requested_cores)

    def sleep(self, duration: float) -> CpuAction:
        # reference CpuCas01::sleep (cpu_cas01.cpp:178-205)
        if duration > 0:
            duration = max(duration, config["surf/precision"])
        action = CpuCas01Action(self.model, 1.0, not self.is_on(),
                                self.speed_scale * self.speed_peak,
                                self.constraint)
        action.max_duration = duration
        action.suspended = SuspendStates.SLEEPING
        if duration == NO_MAX_DURATION:
            action.set_state(ActionState.IGNORED)
        self.model.system.update_variable_penalty(action.variable, 0.0)
        if self.model.is_lazy():
            self.model.action_heap.remove(action)
            # weight-0 variables are invisible to the solver: make sure the
            # max_duration is (re)considered at the next share computation
            if not action.in_modified_set and self.model.system.modified_actions is not None:
                action.in_modified_set = True
                self.model.system.modified_actions.insert(0, action)
        return action


class CpuCas01Action(CpuAction):
    def __init__(self, model: CpuModel, cost: float, failed: bool,
                 speed: float, constraint, requested_core: int = 1):
        variable = model.system.variable_new(
            None, 1.0 / requested_core, requested_core * speed, 1)
        super().__init__(model, cost, failed, variable)
        variable.id = self
        self.requested_core = requested_core
        if model.is_lazy():
            self.set_last_update()
        model.system.expand(constraint, variable, 1.0)


def Host_on_speed_change(host) -> None:
    """Hook point for plugins; the s4u layer connects its signal here."""
    if hasattr(host, "on_speed_change"):
        host.on_speed_change()
