"""Resource layer base: Model, Action, Resource, ActionHeap.

The port's copy of ``simgrid_tpu/kernel/resource.py``: the semantics of
the reference's
src/kernel/resource/{Model,Action,Resource}.cpp and
include/simgrid/kernel/resource/{Model,Action}.hpp: action state machines
(inited/started/failed/finished/ignored), the FULL re-solve path and the
LAZY path (partial invalidation + completion-date heap), and the
modified-action set coupling with the LMM solver.
"""

from __future__ import annotations

import heapq
from enum import Enum
from typing import List, Optional

from ..ops.lmm_host import System, double_update
from ..utils.config import config, lmm_flags
from ..utils.intrusive import IntrusiveList

NO_MAX_DURATION = -1.0


class ActionState(Enum):
    INITED = 0    # created but not started
    STARTED = 1   # currently running
    FAILED = 2    # resource failed or action canceled
    FINISHED = 3  # successfully completed
    IGNORED = 4   # e.g. failure detectors


class SuspendStates(Enum):
    RUNNING = 0
    SUSPENDED = 1
    SLEEPING = 2


class HeapType(Enum):
    LATENCY = 100    # heap entry warning that the latency is paid
    MAX_DURATION = 1  # heap entry for the timeout deadline
    NORMAL = 2       # normal completion date
    UNSET = 3


class ActionHeap:
    """Completion-date priority queue with stable ordering for equal dates
    (the reference uses boost::heap::pairing_heap<stable<true>>); implemented
    as a heapq with monotonic sequence numbers and lazy invalidation."""

    def __init__(self):
        self._heap: List[list] = []  # [date, seq, action] ; action None = stale
        self._seq = 0
        self._entries = {}  # id(action) -> entry

    def empty(self) -> bool:
        self._prune()
        return not self._heap

    def top_date(self) -> float:
        self._prune()
        return self._heap[0][0]

    def top(self) -> "Action":
        self._prune()
        return self._heap[0][2]

    def insert(self, action: "Action", date: float, type_: HeapType) -> None:
        action.heap_type = type_
        entry = [date, self._seq, action]
        self._seq += 1
        self._entries[id(action)] = entry
        heapq.heappush(self._heap, entry)

    def update(self, action: "Action", date: float, type_: HeapType) -> None:
        self.remove(action)
        self.insert(action, date, type_)

    def remove(self, action: "Action") -> None:
        action.heap_type = HeapType.UNSET
        entry = self._entries.pop(id(action), None)
        if entry is not None:
            entry[2] = None  # lazy deletion

    def pop(self) -> "Action":
        self._prune()
        date, seq, action = heapq.heappop(self._heap)
        del self._entries[id(action)]
        return action

    def _prune(self) -> None:
        while self._heap and self._heap[0][2] is None:
            heapq.heappop(self._heap)


class Action:
    """A consumption on a resource (flow on links, burn on a CPU, ...).

    Reference: include/simgrid/kernel/resource/Action.hpp +
    src/kernel/resource/Action.cpp.
    """

    State = ActionState

    def __init__(self, model: "Model", cost: float, failed: bool,
                 variable=None):
        self.model = model
        self.cost = cost
        self.remains = cost
        self.start_time = model.engine.now
        self.finish_time = -1.0
        self.variable = variable
        self.sharing_penalty = 1.0
        self.max_duration = NO_MAX_DURATION
        self.activity = None       # back-reference to the kernel activity
        self.category: Optional[str] = None  # tracing category
        self.data = None
        self.suspended = SuspendStates.RUNNING
        self.refcount = 1
        # lazy-update machinery
        self.last_update = 0.0
        self.last_value = 0.0
        self.heap_type = HeapType.UNSET
        self.in_modified_set = False
        self._state_hook = None
        self.state_set: Optional[IntrusiveList] = (
            model.failed_action_set if failed else model.started_action_set)
        self.state_set.push_back(self)
        self._stamp()

    # -- state machine ----------------------------------------------------
    def get_state(self) -> ActionState:
        m = self.model
        if self.state_set is m.inited_action_set:
            return ActionState.INITED
        if self.state_set is m.started_action_set:
            return ActionState.STARTED
        if self.state_set is m.failed_action_set:
            return ActionState.FAILED
        if self.state_set is m.finished_action_set:
            return ActionState.FINISHED
        return ActionState.IGNORED

    def set_state(self, state: ActionState) -> None:
        self.state_set.remove(self)
        m = self.model
        self.state_set = {
            ActionState.INITED: m.inited_action_set,
            ActionState.STARTED: m.started_action_set,
            ActionState.FAILED: m.failed_action_set,
            ActionState.FINISHED: m.finished_action_set,
            ActionState.IGNORED: m.ignored_action_set,
        }[state]
        self.state_set.push_back(self)
        self._stamp()

    def _stamp(self) -> None:
        """Number the action's entry into its state set: every set is
        appended to only, so its order is the order of ``seq`` (the drain
        fast path orders a batch of completions by it instead of walking
        the whole started set)."""
        m = self.model
        self.seq = m.entries
        m.entries += 1

    def finish(self, state: ActionState) -> None:
        self.finish_time = self.model.engine.now
        self.remains = 0.0
        self.set_state(state)

    def cancel(self) -> None:
        self.set_state(ActionState.FAILED)
        if self.model.is_lazy():
            if self.in_modified_set:
                self.in_modified_set = False
                try:
                    self.model.system.modified_actions.remove(self)
                except ValueError:
                    pass
            self.model.action_heap.remove(self)

    def destroy(self) -> None:
        """Drop the action from every kernel structure (~Action)."""
        if self._state_hook is not None:
            self.state_set.remove(self)
        if self.variable is not None:
            self.model.system.variable_free(self.variable)
            self.variable = None
        self.model.action_heap.remove(self)
        if self.in_modified_set:
            self.in_modified_set = False
            try:
                self.model.system.modified_actions.remove(self)
            except ValueError:
                pass

    def unref(self) -> bool:
        self.refcount -= 1
        if self.refcount == 0:
            self.destroy()
            return True
        return False

    def ref(self) -> None:
        self.refcount += 1

    # -- knobs ------------------------------------------------------------
    def get_bound(self) -> float:
        return self.variable.bound if self.variable is not None else 0.0

    def set_bound(self, bound: float) -> None:
        if self.variable is not None:
            self.model.system.update_variable_bound(self.variable, bound)
        if self.model.is_lazy() and self.last_update != self.model.engine.now:
            self.model.action_heap.remove(self)

    def set_max_duration(self, duration: float) -> None:
        self.max_duration = duration
        if self.model.is_lazy():
            self.model.action_heap.remove(self)

    def set_sharing_penalty(self, penalty: float) -> None:
        self.sharing_penalty = penalty
        self.model.system.update_variable_penalty(self.variable, penalty)
        if self.model.is_lazy():
            self.model.action_heap.remove(self)

    def suspend(self) -> None:
        if self.suspended != SuspendStates.SLEEPING:
            self.model.system.update_variable_penalty(self.variable, 0.0)
            if self.model.is_lazy():
                self.model.action_heap.remove(self)
                if (self.state_set is self.model.started_action_set
                        and self.sharing_penalty > 0):
                    self.update_remains_lazy(self.model.engine.now)
            self.suspended = SuspendStates.SUSPENDED

    def resume(self) -> None:
        if self.suspended != SuspendStates.SLEEPING:
            self.model.system.update_variable_penalty(self.variable,
                                                      self.sharing_penalty)
            self.suspended = SuspendStates.RUNNING
            if self.model.is_lazy():
                self.model.action_heap.remove(self)

    def is_suspended(self) -> bool:
        return self.suspended == SuspendStates.SUSPENDED

    # -- progress ---------------------------------------------------------
    def get_remains(self) -> float:
        if self.model.is_lazy():
            self.update_remains_lazy(self.model.engine.now)
        return self.remains

    def get_remains_no_update(self) -> float:
        return self.remains

    def update_remains(self, delta: float) -> None:
        self.remains = double_update(
            self.remains, delta,
            config["maxmin/precision"] * config["surf/precision"])

    def update_max_duration(self, delta: float) -> None:
        if self.max_duration != NO_MAX_DURATION:
            self.max_duration = double_update(self.max_duration, delta,
                                              config["surf/precision"])

    def update_remains_lazy(self, now: float) -> None:
        """Catch the remains up to `now` using the last solved rate;
        model-specific (CPU actions also hook tracing): overridden."""
        raise NotImplementedError

    def get_rate(self) -> float:
        return self.variable.value if self.variable is not None else 0.0

    def set_last_update(self) -> None:
        self.last_update = self.model.engine.now


class UpdateAlgo(Enum):
    FULL = 0
    LAZY = 1


class Model:
    """Base of every resource model (reference Model.hpp/Model.cpp)."""

    UpdateAlgo = UpdateAlgo

    def __init__(self, engine, algo: UpdateAlgo):
        self.engine = engine
        self.update_algorithm = algo
        self.inited_action_set = IntrusiveList("_state_hook")
        self.started_action_set = IntrusiveList("_state_hook")
        self.failed_action_set = IntrusiveList("_state_hook")
        self.finished_action_set = IntrusiveList("_state_hook")
        self.ignored_action_set = IntrusiveList("_state_hook")
        self.action_heap = ActionHeap()
        self.system: Optional[System] = None
        #: entries into the action state sets so far (``Action.seq``)
        self.entries = 0
        engine.add_model(self)

    def set_maxmin_system(self, system: System) -> None:
        # Wire the configured solver backend (lmm/backend: auto routes
        # small live sets to the exact host list solver and large ones
        # to the device solve, torch always solves on the device, list
        # never) into every kernel system, on the engine's device.
        # Standalone Systems built via make_new_maxmin_system stay on
        # the exact list solver unless the caller installs a backend.
        from ..ops import lmm_torch
        self.system = lmm_torch.install(system, lmm_flags(),
                                        self.engine.device)

    def is_lazy(self) -> bool:
        return self.update_algorithm == UpdateAlgo.LAZY

    def next_occurring_event_is_idempotent(self) -> bool:
        return True

    # -- share computation -------------------------------------------------
    def next_occurring_event(self, now: float) -> float:
        if self.update_algorithm == UpdateAlgo.LAZY:
            return self.next_occurring_event_lazy(now)
        return self.next_occurring_event_full(now)

    def next_occurring_event_lazy(self, now: float) -> float:
        # reference Model.cpp:40-101
        self.system.solve()
        for action in self.system.drain_modified_actions():
            max_duration_flag = False
            if action.state_set is not self.started_action_set:
                continue
            # "Bogus priority" skip (Model.cpp:55): use the effective
            # penalty where defined — a parked flow (every weight-S term
            # gone because its links are at bandwidth 0) has finite part 0
            # but effective penalty inf, and must still be processed so its
            # stale completion date is dropped.
            if (getattr(action, "effective_penalty", action.sharing_penalty)
                    <= 0 or action.heap_type == HeapType.LATENCY):
                continue
            action.update_remains_lazy(now)
            min_date = -1.0
            share = action.variable.value
            if share > 0:
                if action.remains > 0:
                    time_to_completion = action.get_remains_no_update() / share
                else:
                    time_to_completion = 0.0
                min_date = now + time_to_completion
            if (action.max_duration != NO_MAX_DURATION
                    and (min_date <= -1
                         or action.start_time + action.max_duration < min_date)):
                min_date = action.start_time + action.max_duration
                max_duration_flag = True
            if min_date <= -1:
                # Share 0 and no deadline: the action is parked (e.g. on a
                # zero-bandwidth link).  The reference dies here
                # (Model.cpp:89 DIE_IMPOSSIBLE); we drop the stale
                # completion date instead — a profile event may revive it.
                self.action_heap.remove(action)
                continue
            self.action_heap.update(
                action, min_date,
                HeapType.MAX_DURATION if max_duration_flag else HeapType.NORMAL)

        if not self.action_heap.empty():
            return self.action_heap.top_date() - now
        return -1.0

    def next_occurring_event_full(self, now: float) -> float:
        # reference Model.cpp:103-129
        self.system.solve()
        min_date = -1.0
        for action in self.started_action_set:
            value = action.variable.value if action.variable is not None else 0.0
            if value > 0:
                if action.remains > 0:
                    value = action.get_remains_no_update() / value
                else:
                    value = 0.0
                if min_date < 0 or value < min_date:
                    min_date = value
            if action.max_duration >= 0 and (min_date < 0
                                             or action.max_duration < min_date):
                min_date = action.max_duration
        return min_date

    # -- post-advance updates ---------------------------------------------
    def update_actions_state(self, now: float, delta: float) -> None:
        if self.update_algorithm == UpdateAlgo.FULL:
            self.update_actions_state_full(now, delta)
        else:
            self.update_actions_state_lazy(now, delta)

    def update_actions_state_lazy(self, now: float, delta: float) -> None:
        raise NotImplementedError

    def update_actions_state_full(self, now: float, delta: float) -> None:
        raise NotImplementedError

    # -- completion extraction --------------------------------------------
    def extract_done_action(self) -> Optional[Action]:
        return self.finished_action_set.pop_front()

    def extract_failed_action(self) -> Optional[Action]:
        return self.failed_action_set.pop_front()


class Resource:
    """A model resource with an LMM constraint and on/off state
    (reference include/simgrid/kernel/resource/Resource.hpp)."""

    def __init__(self, model: Model, name: str, constraint):
        self.model = model
        self.name = name
        self.constraint = constraint
        self.is_on_flag = True
        self.state_profile = None  # profile.Event once attached

    def is_on(self) -> bool:
        return self.is_on_flag

    def is_off(self) -> bool:
        return not self.is_on_flag

    def turn_on(self) -> None:
        self.is_on_flag = True

    def turn_off(self) -> None:
        self.is_on_flag = False

    def is_used(self) -> bool:
        raise NotImplementedError

    def apply_event(self, event, value: float) -> None:
        raise NotImplementedError

    def get_load(self) -> float:
        return self.constraint.get_usage() if self.constraint else 0.0
