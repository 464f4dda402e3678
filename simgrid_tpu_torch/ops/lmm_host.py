"""The max-min System (graph, mutations, selective-update bookkeeping)
and its exact host list solver.

The port's own copy of ``simgrid_tpu/ops/lmm_host.py``: SimGrid's
lmm::System saturate-bottleneck algorithm (maxmin.cpp:502-693,
concurrency limits at maxmin.hpp:104-129, epsilon helpers at
surf_interface.hpp:34-55) with the same list orderings, tie-breaking and
``double_update`` clamping.  The two configuration reads of the
reference (``maxmin/precision``, ``maxmin/concurrency-limit``) are
fields of :class:`LmmFlags`, which the System holds; the flags' other
fields select the solve backend (:func:`simgrid_tpu_torch.ops.lmm_torch.install`).

The problem solved: maximize the minimum of ``penalty_i * rho_i`` subject to
``sum_i (w_ij * rho_i) <= C_j`` for every SHARED constraint j (``max_i``
instead of the sum for FATPIPE constraints), plus per-variable upper bounds.
The algorithm repeatedly saturates the bottleneck constraint (smallest
remaining/usage ratio), freezing the variables it feeds.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, List, Optional

from ..utils.intrusive import IntrusiveList


@dataclass(frozen=True)
class LmmFlags:
    """The solver settings the reference reads from its configuration,
    with the reference's defaults (``simgrid_tpu/utils/config.py``):

    * ``precision`` — ``maxmin/precision``;
    * ``concurrency_limit`` — ``maxmin/concurrency-limit`` of new
      constraints (-1: none);
    * ``backend`` — ``lmm/backend``: ``torch`` (the device solve),
      ``auto`` (the host list solver below ``threshold`` live
      variables, the device above) or ``list``;
    * ``threshold`` — ``lmm/jax-threshold``;
    * ``dtype`` — ``lmm/dtype``, ``float64`` or ``float32``;
    * ``rounds`` — ``lmm/rounds``, ``local`` or ``global``;
    * ``warm_start`` — ``lmm/warm-start``: ``auto``/``on`` (warm
      restarts of selective solves), ``cold`` or ``off`` (re-flatten the
      modified subset);
    * ``delta_upload`` — ``lmm/delta-upload``: ``auto``/``on`` (one
      indexed payload per solve) or ``off`` (whole dirty fields);
    * ``strict`` — ``lmm/strict``: a failed solve on the host CPU path
      raises instead of falling back to the host list solver (on the
      card it always raises);
    * ``layout`` — ``lmm/layout``: ``auto`` (ELL on the card where the
      width and fill caps accept the system, COO elsewhere), ``coo`` or
      ``ell``;
    * ``chain`` — ``lmm/chain``: ``auto`` (the compaction chain on the
      card for ELL, local, bound-free solves of at least 16,384 variable
      slots), ``on`` or ``off``."""
    precision: float = 1e-5
    concurrency_limit: int = -1
    backend: str = "auto"
    threshold: int = 512
    dtype: str = "float64"
    rounds: str = "local"
    warm_start: str = "auto"
    delta_upload: str = "auto"
    strict: bool = False
    layout: str = "auto"
    chain: str = "auto"

    def __post_init__(self):
        for name, allowed in (("backend", ("torch", "auto", "list")),
                              ("dtype", ("float64", "float32")),
                              ("rounds", ("local", "global")),
                              ("warm_start", ("auto", "on", "cold", "off")),
                              ("delta_upload", ("auto", "on", "off")),
                              ("layout", ("auto", "coo", "ell")),
                              ("chain", ("auto", "on", "off"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"Unknown {name} {getattr(self, name)!r} "
                                 f"(expected one of {', '.join(allowed)})")


class SharingPolicy(Enum):
    SHARED = 0   # sum of consumptions bounded
    FATPIPE = 1  # max of consumptions bounded
    WIFI = 2


INT_MAX = sys.maxsize


# -- float helpers with explicit precision (surf_interface.hpp:34-55) -------

def double_update(value: float, delta: float, precision: float) -> float:
    value -= delta
    if value < precision:
        value = 0.0
    return value


def double_positive(value: float, precision: float) -> bool:
    return value > precision


def double_equals(a: float, b: float, precision: float) -> bool:
    return abs(a - b) < precision


# The reference keeps elements/variables/constraints in boost::intrusive
# lists whose push_front/push_back ordering defines the deterministic
# iteration (and hence floating-point accumulation) order; see
# utils/intrusive.py for the Python equivalent.


class Element:
    """One (variable, constraint) incidence with its consumption weight."""

    __slots__ = ("consumption_weight", "constraint", "variable",
                 "_enabled_hook", "_disabled_hook", "_active_hook",
                 "_view_eslot")

    def __init__(self, constraint: "Constraint", variable: "Variable",
                 consumption_weight: float):
        self.consumption_weight = consumption_weight
        self.constraint = constraint
        self.variable = variable
        self._enabled_hook = None
        self._disabled_hook = None
        self._active_hook = None

    def get_concurrency(self) -> int:
        # weight < 1 (e.g. cross-traffic at 0.05) does not count toward the
        # constraint's concurrency (maxmin.cpp:30-40).
        return 1 if self.consumption_weight >= 1 else 0

    def decrease_concurrency(self) -> None:
        self.constraint.concurrency_current -= self.get_concurrency()

    def increase_concurrency(self) -> None:
        cnst = self.constraint
        cnst.concurrency_current += self.get_concurrency()
        if cnst.concurrency_current > cnst.concurrency_maximum:
            cnst.concurrency_maximum = cnst.concurrency_current

    def make_active(self) -> None:
        if self._active_hook is None:
            self.constraint.active_element_set.push_front(self)

    def make_inactive(self) -> None:
        if self._active_hook is not None:
            self.constraint.active_element_set.remove(self)


class Constraint:
    """A bounded resource: ``sum/max of w*rho <= bound``."""

    __slots__ = ("bound", "id", "rank", "remaining", "usage",
                 "concurrency_limit", "concurrency_current",
                 "concurrency_maximum", "_sharing_policy",
                 "enabled_element_set", "disabled_element_set",
                 "active_element_set", "_cs_hook", "_acs_hook", "_mcs_hook",
                 "_light_idx", "_view_slot", "_system",
                 "_waiters")

    def __init__(self, system: "System", id_obj, bound: float):
        self._system = system
        self.bound = bound
        self.id = id_obj
        self.rank = system._next_cnst_rank
        system._next_cnst_rank += 1
        self.remaining = 0.0
        self.usage = 0.0
        self.concurrency_limit = system.flags.concurrency_limit
        self.concurrency_current = 0
        self.concurrency_maximum = 0
        self._sharing_policy = SharingPolicy.SHARED
        self.enabled_element_set = IntrusiveList("_enabled_hook")
        self.disabled_element_set = IntrusiveList("_disabled_hook")
        self.active_element_set = IntrusiveList("_active_hook")
        self._cs_hook = None
        self._acs_hook = None
        self._mcs_hook = None
        self._light_idx = -1
        #: staged variables whose cached blocker is this constraint
        #: (insertion-ordered dict used as an ordered set)
        self._waiters: dict = {}

    @property
    def sharing_policy(self) -> "SharingPolicy":
        return self._sharing_policy

    @sharing_policy.setter
    def sharing_policy(self, policy: "SharingPolicy") -> None:
        # models assign the policy directly after constraint_new; route
        # the write through the ArrayView so a FATPIPE link created
        # after the view exists is solved with max-sharing, not sum
        self._sharing_policy = policy
        view = self._system.array_view
        if view is not None:
            view.on_policy(self)

    # concurrency ---------------------------------------------------------
    def get_concurrency_limit(self) -> int:
        return self.concurrency_limit

    def set_concurrency_limit(self, limit: int) -> None:
        assert limit < 0 or self.concurrency_maximum <= limit
        self.concurrency_limit = limit
        # A raised limit frees slack without an on_disabled_var event:
        # probe our registered waiters now (failed probes re-register on
        # their real blocker).  The reference would wake them at the
        # next disabled-list scan — same outcome, earlier instant.
        for var in list(self._waiters.values()):
            if var.staged_penalty > 0 and var.can_enable():
                self._system.enable_var(var)

    def get_concurrency_slack(self) -> int:
        if self.concurrency_limit < 0:
            return INT_MAX
        return self.concurrency_limit - self.concurrency_current

    # introspection -------------------------------------------------------
    def get_usage(self) -> float:
        """Load of the resource: sum (or max for FATPIPE) of w*value."""
        result = 0.0
        if self.sharing_policy != SharingPolicy.FATPIPE:
            for elem in self.enabled_element_set:
                if elem.consumption_weight > 0:
                    result += elem.consumption_weight * elem.variable.value
        else:
            for elem in self.enabled_element_set:
                if elem.consumption_weight > 0:
                    result = max(result, elem.consumption_weight * elem.variable.value)
        return result

    def get_variable_amount(self) -> int:
        return sum(1 for e in self.enabled_element_set if e.consumption_weight > 0)

    def iter_variables(self):
        for elem in self.enabled_element_set:
            yield elem.variable
        for elem in self.disabled_element_set:
            yield elem.variable


class Variable:
    """One consumer (an Action's rate): solved value is ``rho``."""

    __slots__ = ("id", "rank", "cnsts", "sharing_penalty", "staged_penalty",
                 "bound", "concurrency_share", "value", "visited", "mu",
                 "_vs_hook", "_svs_hook", "_view_slot",
                 "_by_cnst", "_blocker")

    def __init__(self, system: "System", id_obj, sharing_penalty: float,
                 bound: float):
        self.id = id_obj
        self.rank = system._next_var_rank
        system._next_var_rank += 1
        self.cnsts: List[Element] = []
        #: constraint-id -> [elements]: O(1) lookup for expand's
        #: current-share scan and expand_add's edge search — a linear
        #: var.cnsts walk per element made huge-class bench construction
        #: (384 elements/var) quadratic per variable
        self._by_cnst: dict = {}
        #: the first constraint whose slack blocked can_enable — while
        #: its slack stays below our share, later wake-up probes answer
        #: 'no' in O(1) instead of rescanning all 384 bench elements,
        #: and on_disabled_var probes only its own registered waiters
        #: (the staged-variable wake-up walk was quadratic without it)
        self._blocker = None
        self.sharing_penalty = sharing_penalty
        self.staged_penalty = 0.0
        self.bound = bound
        self.concurrency_share = 1
        self.value = 0.0
        self.visited = system._visited_counter - 1
        self.mu = 0.0
        self._vs_hook = None
        self._svs_hook = None

    def set_concurrency_share(self, value: int) -> None:
        self.concurrency_share = value

    def get_value(self) -> float:
        return self.value

    def get_bound(self) -> float:
        return self.bound

    def get_min_concurrency_slack(self) -> int:
        minslack = INT_MAX
        for elem in self.cnsts:
            slack = elem.constraint.get_concurrency_slack()
            if slack < minslack:
                if slack == 0:
                    return 0
                minslack = slack
        return minslack

    def set_blocker(self, cnst) -> None:
        """(Re)register this staged variable as waiting on `cnst`; the
        wake-up scan (System.on_disabled_var) probes only registered
        waiters."""
        old = self._blocker
        if old is cnst:
            return
        if old is not None:
            old._waiters.pop(id(self), None)
        self._blocker = cnst
        if cnst is not None:
            cnst._waiters[id(self)] = self

    def can_enable(self) -> bool:
        # Early-exit slack scan (vs the reference's full
        # get_min_concurrency_slack): the first constraint below the
        # required share answers 'no', and it is cached as the blocker
        # so the next probe is O(1) until that constraint frees
        # capacity — keeps dense bench-protocol construction from
        # going quadratic in staged variables.
        if self.staged_penalty <= 0:
            return False
        share = self.concurrency_share
        blocker = self._blocker
        if (blocker is not None
                and blocker.get_concurrency_slack() < share):
            return False
        for elem in self.cnsts:
            if elem.constraint.get_concurrency_slack() < share:
                self.set_blocker(elem.constraint)
                return False
        self.set_blocker(None)
        return True

    def get_constraint(self, num: int) -> Optional[Constraint]:
        return self.cnsts[num].constraint if num < len(self.cnsts) else None

    def get_constraint_weight(self, num: int) -> float:
        return self.cnsts[num].consumption_weight

    def get_number_of_constraint(self) -> int:
        return len(self.cnsts)


class _LightEntry:
    __slots__ = ("cnst", "remaining_over_usage")

    def __init__(self, cnst: Constraint, rou: float):
        self.cnst = cnst
        self.remaining_over_usage = rou


class System:
    """The max-min fairness system: constraint/variable graph + solve().

    ``solve()`` runs ``solve_fn`` when a backend is installed
    (:func:`simgrid_tpu_torch.ops.lmm_torch.install`), and the exact
    list-based fixpoint below otherwise.
    """

    def __init__(self, selective_update: bool = False,
                 flags: Optional[LmmFlags] = None):
        self.flags = flags if flags is not None else LmmFlags()
        self.selective_update_active = selective_update
        self.modified = False
        self._visited_counter = 1
        self._next_var_rank = 1
        self._next_cnst_rank = 1
        self.variable_set = IntrusiveList("_vs_hook")
        self.constraint_set = IntrusiveList("_cs_hook")
        self.active_constraint_set = IntrusiveList("_acs_hook")
        self.modified_constraint_set = IntrusiveList("_mcs_hook")
        self.saturated_variable_set = IntrusiveList("_svs_hook")
        # Actions whose variable value changed in the last solve; consumed
        # by lazy model updates (Action::ModifiedSet analog).
        self.modified_actions: Optional[List[Any]] = [] if selective_update else None
        self.solve_fn: Optional[Callable[["System"], None]] = None
        self.solve_count = 0
        #: solves the host list solver took over from a failed device
        #: solve (lmm_torch.solve_torch)
        self.fallback_count = 0
        #: incrementally-maintained flat arrays (ops.lmm_view.ArrayView),
        #: created lazily by the device backend; hooks below keep it in
        #: sync with every graph mutation
        self.array_view = None
        #: device-resident incremental solver (ops.lmm_warm.WarmSolver),
        #: created lazily on the first selective device solve
        self.warm_solver = None

    def flag_action_modified(self, action) -> None:
        """Report one action's rate as changed by the current solve
        (idempotent; the shared idiom of every solve backend)."""
        if (self.modified_actions is not None and action is not None
                and not getattr(action, "in_modified_set", False)):
            action.in_modified_set = True
            self.modified_actions.append(action)

    def drain_modified_actions(self) -> List[Any]:
        """Pop the actions whose rate changed in the last solve (the
        Action::ModifiedSet analog consumed by lazy model updates), clearing
        their membership flag so later solves can re-report them."""
        actions = self.modified_actions or []
        for action in actions:
            action.in_modified_set = False
        self.modified_actions = [] if self.selective_update_active else None
        return actions

    # -- graph construction ----------------------------------------------
    def constraint_new(self, id_obj, bound: float) -> Constraint:
        cnst = Constraint(self, id_obj, bound)
        self.constraint_set.push_back(cnst)
        if self.array_view is not None:
            self.array_view.on_new_cnst(cnst)
        return cnst

    def variable_new(self, id_obj, sharing_penalty: float,
                     bound: float = -1.0,
                     number_of_constraints: int = 1) -> Variable:
        var = Variable(self, id_obj, sharing_penalty, bound)
        if sharing_penalty > 0:
            self.variable_set.push_front(var)
        else:
            self.variable_set.push_back(var)
        if self.array_view is not None:
            self.array_view.on_new_var(var)
        return var

    def variable_free(self, var: Variable) -> None:
        self.variable_set.remove(var)
        if var._svs_hook is not None:
            self.saturated_variable_set.remove(var)
        self._var_free(var)

    def variable_free_all(self) -> None:
        while not self.variable_set.empty():
            self.variable_free(self.variable_set.front())

    def _var_free(self, var: Variable) -> None:
        self.modified = True
        if self.array_view is not None:
            self.array_view.on_var_free(var)
        if var.cnsts:
            self.update_modified_set(var.cnsts[0].constraint)
        for elem in var.cnsts:
            if var.sharing_penalty > 0:
                elem.decrease_concurrency()
            if elem._enabled_hook is not None:
                elem.constraint.enabled_element_set.remove(elem)
            if elem._disabled_hook is not None:
                elem.constraint.disabled_element_set.remove(elem)
            if elem._active_hook is not None:
                elem.constraint.active_element_set.remove(elem)
            nelements = (len(elem.constraint.enabled_element_set)
                         + len(elem.constraint.disabled_element_set))
            if nelements == 0:
                self.make_constraint_inactive(elem.constraint)
            else:
                self.on_disabled_var(elem.constraint)
        var.set_blocker(None)
        var.cnsts.clear()
        var._by_cnst.clear()

    def cnst_free(self, cnst: Constraint) -> None:
        self.make_constraint_inactive(cnst)
        self.constraint_set.remove(cnst)
        if self.array_view is not None:
            self.array_view.on_cnst_free(cnst)

    def expand(self, cnst: Constraint, var: Variable,
               consumption_weight: float) -> None:
        """Add (or stage) the var->cnst edge (maxmin.cpp:234-285 behavior)."""
        self.modified = True

        current_share = 0
        if var.concurrency_share > 1:
            for elem in var._by_cnst.get(id(cnst), ()):
                if elem._enabled_hook is not None:
                    current_share += elem.get_concurrency()

        if (var.sharing_penalty > 0
                and var.concurrency_share - current_share > cnst.get_concurrency_slack()):
            penalty = var.sharing_penalty
            self.disable_var(var)
            for elem in var.cnsts:
                self.on_disabled_var(elem.constraint)
            consumption_weight = 0
            var.staged_penalty = penalty
            assert not var.sharing_penalty
            # a failed can_enable registers the real blocker; on the
            # (rare) success, conservatively wait on the trigger
            if var.can_enable():
                var.set_blocker(cnst)

        elem = Element(cnst, var, consumption_weight)
        var.cnsts.append(elem)
        var._by_cnst.setdefault(id(cnst), []).append(elem)

        if var.sharing_penalty:
            cnst.enabled_element_set.push_front(elem)
            elem.increase_concurrency()
        else:
            cnst.disabled_element_set.push_back(elem)
        if self.array_view is not None:
            self.array_view.on_expand(elem)

        if not self.selective_update_active:
            self.make_constraint_active(cnst)
        elif elem.consumption_weight > 0 or var.sharing_penalty > 0:
            self.make_constraint_active(cnst)
            self.update_modified_set(cnst)
            if len(var.cnsts) > 1:
                self.update_modified_set(var.cnsts[0].constraint)

    def expand_add(self, cnst: Constraint, var: Variable, value: float) -> None:
        """Add value to an existing edge's weight (max for FATPIPE)."""
        self.modified = True
        edge = var._by_cnst.get(id(cnst))
        elem = edge[0] if edge else None
        if elem is not None:
            if var.sharing_penalty:
                elem.decrease_concurrency()
            if cnst.sharing_policy != SharingPolicy.FATPIPE:
                elem.consumption_weight += value
            else:
                elem.consumption_weight = max(elem.consumption_weight, value)
            if self.array_view is not None:
                self.array_view.on_weight(elem)
            if var.sharing_penalty:
                if cnst.get_concurrency_slack() < elem.get_concurrency():
                    penalty = var.sharing_penalty
                    self.disable_var(var)
                    for elem2 in var.cnsts:
                        self.on_disabled_var(elem2.constraint)
                    var.staged_penalty = penalty
                    assert not var.sharing_penalty
                    if var.can_enable():
                        var.set_blocker(cnst)
                elem.increase_concurrency()
            self.update_modified_set(cnst)
        else:
            self.expand(cnst, var, value)

    # -- active/modified bookkeeping --------------------------------------
    def make_constraint_active(self, cnst: Constraint) -> None:
        if cnst._acs_hook is None:
            self.active_constraint_set.push_back(cnst)

    def make_constraint_inactive(self, cnst: Constraint) -> None:
        if cnst._acs_hook is not None:
            self.active_constraint_set.remove(cnst)
        if cnst._mcs_hook is not None:
            self.modified_constraint_set.remove(cnst)

    def update_modified_set(self, cnst: Constraint) -> None:
        if self.selective_update_active and cnst._mcs_hook is None:
            self.modified_constraint_set.push_back(cnst)
            self._update_modified_set_rec(cnst)

    def _update_modified_set_rec(self, cnst: Constraint) -> None:
        # Depth-first propagation with the exact recursion order of the
        # reference (maxmin.cpp:898-913) — the modified-set order is the
        # selective solve's constraint order, so it must match — but driven
        # by an explicit generator stack so 100k-flow chains cannot
        # overflow Python's recursion limit.
        def visit(c: Constraint):
            for elem in c.enabled_element_set:
                var = elem.variable
                for elem2 in var.cnsts:
                    if var.visited == self._visited_counter:
                        break
                    c2 = elem2.constraint
                    if c2 is not c and c2._mcs_hook is None:
                        self.modified_constraint_set.push_back(c2)
                        yield c2
                var.visited = self._visited_counter

        stack = [visit(cnst)]
        while stack:
            child = next(stack[-1], None)
            if child is None:
                stack.pop()
            else:
                stack.append(visit(child))

    def remove_all_modified_set(self) -> None:
        self._visited_counter += 1
        if self._visited_counter == 1:
            for var in self.variable_set:
                var.visited = 0
        self.modified_constraint_set.clear()

    # -- enable/disable/staging (concurrency limits) ----------------------
    def enable_var(self, var: Variable) -> None:
        var.set_blocker(None)
        var.sharing_penalty = var.staged_penalty
        var.staged_penalty = 0
        if self.array_view is not None:
            self.array_view.on_penalty(var)
        self.variable_set.remove(var)
        self.variable_set.push_front(var)
        for elem in var.cnsts:
            elem.constraint.disabled_element_set.remove(elem)
            elem.constraint.enabled_element_set.push_front(elem)
            elem.increase_concurrency()
        if var.cnsts:
            self.update_modified_set(var.cnsts[0].constraint)

    def disable_var(self, var: Variable) -> None:
        assert not var.staged_penalty, "Staged penalty should have been cleared"
        self.variable_set.remove(var)
        self.variable_set.push_back(var)
        if var.cnsts:
            self.update_modified_set(var.cnsts[0].constraint)
        for elem in var.cnsts:
            elem.constraint.enabled_element_set.remove(elem)
            elem.constraint.disabled_element_set.push_back(elem)
            if elem._active_hook is not None:
                elem.constraint.active_element_set.remove(elem)
            elem.decrease_concurrency()
        var.sharing_penalty = 0.0
        var.staged_penalty = 0.0
        var.value = 0.0
        if self.array_view is not None:
            self.array_view.on_penalty(var)

    def on_disabled_var(self, cnst: Constraint) -> None:
        """Wake staged variables when `cnst` frees concurrency slack.

        The reference walks the whole disabled element list with a full
        slack scan per candidate (maxmin.cpp on_disabled_var) — O(list)
        per wake-up and quadratic over a churny run.  Here every staged
        variable is registered on ONE currently-blocking constraint
        (Variable.set_blocker), so the scan probes exactly the
        candidates this constraint was blocking, in registration order.
        Candidates blocked elsewhere cannot become enableable from this
        constraint's slack release, so skipping them is
        behavior-preserving; the probe order within one scan is
        registration order rather than the reference's disabled-list
        order (observable only when several waiters compete for the
        same freed slack — documented divergence)."""
        if cnst.get_concurrency_limit() < 0:
            return
        if not cnst._waiters:
            return
        for var in list(cnst._waiters.values()):
            if cnst.concurrency_current == cnst.get_concurrency_limit():
                break
            if var.staged_penalty > 0 and var.can_enable():
                self.enable_var(var)

    # -- runtime updates ---------------------------------------------------
    def update_variable_penalty(self, var: Variable, penalty: float) -> None:
        assert penalty >= 0, "Variable penalty should not be negative!"
        if penalty == var.sharing_penalty:
            return
        enabling_var = penalty > 0 and var.sharing_penalty <= 0
        disabling_var = penalty <= 0 and var.sharing_penalty > 0
        self.modified = True
        if enabling_var:
            var.staged_penalty = penalty
            minslack = var.get_min_concurrency_slack()
            if minslack < var.concurrency_share:
                # minslack < share guarantees the scan fails; run it
                # for its blocker-registration side effect
                var.can_enable()
                return
            self.enable_var(var)
        elif disabling_var:
            self.disable_var(var)
        else:
            var.sharing_penalty = penalty
            if self.array_view is not None:
                self.array_view.on_penalty(var)

    def update_variable_bound(self, var: Variable, bound: float) -> None:
        self.modified = True
        var.bound = bound
        if self.array_view is not None:
            self.array_view.on_vbound(var)
        if var.cnsts:
            self.update_modified_set(var.cnsts[0].constraint)

    def update_constraint_bound(self, cnst: Constraint, bound: float) -> None:
        self.modified = True
        self.update_modified_set(cnst)
        cnst.bound = bound
        if self.array_view is not None:
            self.array_view.on_cbound(cnst)

    # -- solve -------------------------------------------------------------
    def solve(self) -> None:
        if not self.modified:
            return
        self.solve_count += 1
        if self.solve_fn is not None:
            self.solve_fn(self)
            return
        self.solve_exact()

    def solve_exact(self) -> None:
        if self.selective_update_active:
            self._solve_list(list(self.modified_constraint_set))
        else:
            self._solve_list(list(self.active_constraint_set))

    def _solve_list(self, cnst_list: List[Constraint]) -> None:
        eps = self.flags.precision
        min_usage = -1.0
        min_bound = -1.0

        # Reset the value of every enabled variable of the touched portion.
        for cnst in cnst_list:
            for elem in cnst.enabled_element_set:
                elem.variable.value = 0.0

        light: List[_LightEntry] = []
        saturated_constraints: List[int] = []

        for cnst in cnst_list:
            cnst.remaining = cnst.bound
            if not double_positive(cnst.remaining, cnst.bound * eps):
                # Zero-capacity constraint: its flows get rate 0 this round.
                # Unlike the reference (maxmin.cpp:523-525), still report the
                # actions as modified so the lazy model drops their stale
                # completion dates (park support, see Model lazy path).
                for elem in cnst.enabled_element_set:
                    if elem.consumption_weight > 0:
                        self.flag_action_modified(elem.variable.id)
                continue
            cnst.usage = 0.0
            for elem in cnst.enabled_element_set:
                if elem.consumption_weight > 0:
                    w = elem.consumption_weight / elem.variable.sharing_penalty
                    if cnst.sharing_policy != SharingPolicy.FATPIPE:
                        cnst.usage += w
                    elif cnst.usage < w:
                        cnst.usage = w
                    elem.make_active()
                    self.flag_action_modified(elem.variable.id)
            if cnst.usage > 0:
                rou = cnst.remaining / cnst.usage
                entry = _LightEntry(cnst, rou)
                cnst._light_idx = len(light)
                light.append(entry)
                min_usage, saturated_constraints = self._saturated_constraints_update(
                    rou, len(light) - 1, saturated_constraints, min_usage)

        self._saturated_variable_set_update(light, saturated_constraints)

        light_num = len(light)
        while True:
            var_list = self.saturated_variable_set
            for var in var_list:
                if var.bound > 0 and var.bound * var.sharing_penalty < min_usage:
                    if min_bound < 0:
                        min_bound = var.bound * var.sharing_penalty
                    else:
                        min_bound = min(min_bound, var.bound * var.sharing_penalty)

            while not var_list.empty():
                var = var_list.front()
                if min_bound < 0:
                    var.value = min_usage / var.sharing_penalty
                else:
                    if double_equals(min_bound, var.bound * var.sharing_penalty, eps):
                        var.value = var.bound
                    else:
                        var_list.remove(var)
                        continue

                for elem in var.cnsts:
                    cnst = elem.constraint
                    if cnst.sharing_policy != SharingPolicy.FATPIPE:
                        cnst.remaining = double_update(
                            cnst.remaining, elem.consumption_weight * var.value,
                            cnst.bound * eps)
                        cnst.usage = double_update(
                            cnst.usage,
                            elem.consumption_weight / var.sharing_penalty, eps)
                        if (not double_positive(cnst.usage, eps)
                                or not double_positive(cnst.remaining, cnst.bound * eps)):
                            if cnst._light_idx >= 0:
                                idx = cnst._light_idx
                                light[idx] = light[light_num - 1]
                                light[idx].cnst._light_idx = idx
                                light_num -= 1
                                cnst._light_idx = -1
                        else:
                            if cnst._light_idx >= 0:
                                light[cnst._light_idx].remaining_over_usage = \
                                    cnst.remaining / cnst.usage
                        elem.make_inactive()
                    else:
                        # FATPIPE: recompute the max over still-unset vars.
                        cnst.usage = 0.0
                        elem.make_inactive()
                        for elem2 in cnst.enabled_element_set:
                            if elem2.variable.value > 0:
                                continue
                            if elem2.consumption_weight > 0:
                                cnst.usage = max(
                                    cnst.usage,
                                    elem2.consumption_weight / elem2.variable.sharing_penalty)
                        if (not double_positive(cnst.usage, eps)
                                or not double_positive(cnst.remaining, cnst.bound * eps)):
                            if cnst._light_idx >= 0:
                                idx = cnst._light_idx
                                light[idx] = light[light_num - 1]
                                light[idx].cnst._light_idx = idx
                                light_num -= 1
                                cnst._light_idx = -1
                        else:
                            if cnst._light_idx >= 0:
                                light[cnst._light_idx].remaining_over_usage = \
                                    cnst.remaining / cnst.usage
                var_list.remove(var)

            min_usage = -1.0
            min_bound = -1.0
            saturated_constraints = []
            for pos in range(light_num):
                min_usage, saturated_constraints = self._saturated_constraints_update(
                    light[pos].remaining_over_usage, pos, saturated_constraints,
                    min_usage)
            self._saturated_variable_set_update(light, saturated_constraints)
            if light_num <= 0:
                break

        self.modified = False
        if self.selective_update_active:
            self.remove_all_modified_set()

    @staticmethod
    def _saturated_constraints_update(usage, pos, saturated, min_usage):
        assert usage > 0, "Impossible"
        if min_usage < 0 or min_usage > usage:
            min_usage = usage
            saturated = [pos]
        elif min_usage == usage:
            saturated.append(pos)
        return min_usage, saturated

    def _saturated_variable_set_update(self, light, saturated_constraints):
        for pos in saturated_constraints:
            cnst = light[pos].cnst
            for elem in cnst.active_element_set:
                if elem.consumption_weight > 0 and elem.variable._svs_hook is None:
                    self.saturated_variable_set.push_back(elem.variable)

    # -- debugging ---------------------------------------------------------
    def print_system(self, out=sys.stderr) -> None:
        out.write("MAX-MIN ( " + " ".join(
            f"'{v.rank}'({v.sharing_penalty})" for v in self.variable_set) + " )\n")
        for cnst in self.active_constraint_set:
            op = " , " if cnst.sharing_policy == SharingPolicy.FATPIPE else " + "
            terms = op.join(
                f"{e.consumption_weight}.'{e.variable.rank}'({e.variable.value})"
                for e in cnst.enabled_element_set)
            out.write(f"\t({terms}0) <= {cnst.bound} ('{cnst.rank}')\n")
        for var in self.variable_set:
            bound = f" (<={var.bound})" if var.bound > 0 else ""
            out.write(f"'{var.rank}'({var.sharing_penalty}) : {var.value}{bound}\n")


def make_new_maxmin_system(selective_update: bool = False,
                           flags: Optional[LmmFlags] = None) -> System:
    """A System solved by the exact host list solver until a backend is
    installed."""
    return System(selective_update, flags)
