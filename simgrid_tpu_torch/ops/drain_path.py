"""Engine-side drain fast path: delegate pure-drain phases — and, with
``drain/transitions``, whole compute/comm ALTERNATION phases — to the
device-resident superstep executor.

The port's copy of ``simgrid_tpu/ops/drain_path.py`` over the port's
:class:`~simgrid_tpu_torch.ops.lmm_drain.DrainSim`.  One thing differs
in kind: the JAX superstep's input arrays are immutable, so its batch
start costs nothing to keep, while the port's superstep (K16's graph)
writes the committed flow state in place.  The plan therefore keeps the
batch-start penalties and remains in buffers of its own, filled by one
in-stream copy before each collected superstep, and a rollback copies
them back into the committed state before it replays the served prefix
(``superstep_batch(k, fetch=False)``).  A speculative superstep runs on
a spare buffer set of the drain's ``CarryPool`` and is dropped through
``CarryPool.discard``.

A *pure-drain phase* is the shape the end-to-end north star degenerates
to (BASELINE config #4): every started network flow has paid its
latency, none carries a deadline, and no profile event fires before the
next completion — the maestro's loop is then exactly

    solve rates -> dt to next completion -> retire flows

per advance, costing >= 3 host<->device syncs plus an O(V) Python walk
each time through the generic `Model::update_actions_state` path.  This
module detects that phase from `NetworkCm02Model`'s FULL-mode hooks and
serves *batches* of advances from one `DrainSim` superstep dispatch
(ops.lmm_drain), keeping completion-event ordering identical:

* completions are emitted by walking `started_action_set` in order and
  finishing exactly the planned set — the same traversal order the
  generic path uses;
* the plan is built from the incrementally-maintained ArrayView
  (ops.lmm_view) — no graph walk — and audited by its mutation
  `version` counter, with the frees caused by *our own* served
  completions whitelisted (`expected_frees`);
* with ``drain/pipeline`` > 0 the NEXT superstep is issued
  speculatively the moment ring N is fetched — the launches are
  asynchronous, so the device executes ring N+1 while the engine
  consumes ring N's batches, and the next fetch finds a ready buffer
  instead of waiting.  Speculation never touches the committed flow
  state (it runs on a spare buffer set), so ANY plan teardown —
  profile event before the horizon, an unrecognized ArrayView
  mutation, a stall — simply discards the in-flight token and the
  deterministic-replay rollback proceeds exactly as in the unpipelined
  path.  Event order, timestamps and clocks are bit-identical to
  ``drain/pipeline:0``.

Device-resident mutating phases (``drain/transitions``, the PR 9
tentpole): the mutation census is a CLASSIFIER, not a tripwire.  When
the ArrayView version moves while a plan is live, the per-consumer
dirty-INDEX map (``ArrayView.consume("drain")``) is classified:

* **resumable transitions** — a latency wake or suspend/resume
  (v_penalty), a bound/weight change (c_bound / v_bound / e_w from
  set_bandwidth, set_latency, TCP windows), a NEW flow posted on
  existing routes (recycled or fresh variable slot + appended element
  slots within the plan's padded capacity), or the echo of our own
  retirements — are batched into ONE fused indexed *transition
  payload* (the lmm_warm delta-upload shape: [indices..., values...]
  runs with a static layout tuple) and scattered into the live device
  plan (`DrainSim.apply_transitions`).  No re-flatten, no platform
  re-upload; the superstep resumes from the patched state.
* **true invalidations** — a layout epoch bump (array reallocation /
  compaction), whole-field dirtiness, sharing-policy changes, a
  fatpipe route, deadlines, route-less flows, non-finite (parked)
  penalties, or any lane the classifier cannot attribute to a started
  action — keep today's bit-identical replay fallback: rewind to the
  served prefix, write remains/rates back, hand the phase to the
  generic loop.

Latency phases ride the plan as *invisible lanes* (device penalty 0 —
not flowing), so a comm wave is planned the moment it is posted:
`serve` returns min(plan dt, min latency) and `apply` replicates the
generic walk's latency double_update + wake (the wake's penalty update
is itself absorbed as a transition on the next serve).  An engine
advance decided by ANOTHER model (a CPU exec completing mid-drain)
becomes a forced partial advance ON DEVICE (`DrainSim.partial_advance`
— the same strict-< retirement rule at an externally fixed delta)
instead of a plan teardown.  Together these keep the compute/comm
alternation of the SMPI NAS workloads on the superstep path end to
end; coverage is counted per run (`fastpath_advances` vs
`native_advances`, plus the `drain_cause_*` histogram).

Precision: f64 plans retire flows at the engine's absolute
`maxmin/precision * surf/precision` threshold — bit-matching the
generic double_update path — while f32 plans use the RELATIVE
`drain/done-eps * size` rule so chip-precision ties stay grouped
(see ops.lmm_drain).

Fidelity trade: while a plan is being served, the
`remains` of still-live flows and link usage introspection lag until
the plan ends (they are synced on every invalidation); actors in a
drain are blocked in comm waits, so nothing observes the lag.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.config import config
from . import opstats
from .lmm_host import double_update

#: started-flow census below which a plan is never attempted (plan
#: bookkeeping beats the generic path only at scale); the config flag
#: drain/min-flows overrides per run.
_MIN_FLOWS_FLOOR = 8


def _plan_inputs(model, dtype, allow_latency: bool = False):
    """The drain precondition walk + flattened state, shared by the
    fast path's plan builder and the campaign capture: one O(V) pass
    maps view slots to started actions and rejects anything the device
    plan has no semantics for (deadlines, route-less flows, live
    non-flow variables, zero remains — and, unless ``allow_latency``,
    latency phases and suspensions).  With ``allow_latency`` (the
    drain/transitions mode) latency-phase and suspended actions are
    accepted as INVISIBLE lanes (device penalty 0, not flowing) and
    their slots returned in `lat_slots`.  Returns
    ``(slot_action, view, snap, sizes, rem, pen, lat_slots)`` or None.
    """
    from ..kernel.resource import NO_MAX_DURATION
    from .lmm_view import ArrayView

    system = model.system
    view = system.array_view
    if view is None:
        view = ArrayView(system)

    slot_action: Dict[int, object] = {}
    lat_slots: set = set()
    for action in model.started_action_set:
        var = action.variable
        if (var is None
                or action.max_duration != NO_MAX_DURATION
                or var.get_number_of_constraint() == 0):
            return None
        if (action.latency > 0 or action.is_suspended()
                or var.sharing_penalty <= 0):
            if not allow_latency:
                return None
            if action.latency > 0:
                lat_slots.add(var._view_slot)
        slot_action[var._view_slot] = action

    snap = view.snapshot(dtype)
    # NOTE: snapshot() may compact, which renumbers element slots
    # but not variable slots — the slot map above stays valid.
    pen_all = snap.v_penalty
    live = np.flatnonzero(pen_all > 0)
    # a live variable that is NOT a started flow (e.g. a failed
    # action not yet reaped) shares bandwidth in the generic solve:
    # not servable by a plan
    if not all(int(s) in slot_action for s in live):
        return None
    if not allow_latency and len(live) != len(slot_action):
        return None

    n_v = len(pen_all)
    sizes = np.ones(n_v)
    rem = np.zeros(n_v)
    pen = np.zeros(n_v, dtype)
    for slot, action in sorted(slot_action.items()):
        sizes[slot] = max(action.cost, 1.0)
        rem[slot] = action.get_remains_no_update()
        pen[slot] = pen_all[slot]
    if np.any(rem[live] <= 0):
        return None         # zero-remains flows: let generic finish
    return slot_action, view, snap, sizes, rem, pen, lat_slots


def classify_phase(sim) -> str:
    """Classify what kind of phase a drain executor is walking, from
    its armed device tapes: ``collective-tape`` (a comm-DAG schedule
    tape drives activations on device — optionally composed with a
    fault tape as ``collective-tape+faults``), ``fault-tape`` (link
    events only) or ``pure-drain``.  Bumps the matching
    ``phase_<kind>`` opstats counter.
    Accepts any executor with the DrainSim flag surface (DrainSim,
    BatchDrainSim, a fast-path plan)."""
    has_coll = bool(getattr(sim, "has_coll", False))
    has_tape = bool(getattr(sim, "has_tape", False))
    if has_coll:
        kind = ("collective-tape+faults" if has_tape
                else "collective-tape")
    elif has_tape:
        kind = "fault-tape"
    else:
        kind = "pure-drain"
    opstats.bump("phase_" + kind.replace("-", "_").replace("+", "_"))
    return kind


def capture_scenario(model):
    """Snapshot the model's CURRENT pure-drain phase as the shared base
    scenario of a batched campaign (parallel.campaign.Campaign): the
    same preconditions as the fast path's plan builder, returned as
    plain numpy arrays plus the slot->action and constraint->link-name
    maps a campaign needs to label its dimensions.  None when the
    phase is not a pure drain."""
    plan = _plan_inputs(model, np.float64)
    if plan is None:
        return None
    slot_action, view, snap, sizes, rem, pen, _lat = plan
    E = snap.n_elem
    names = [getattr(getattr(c, "id", None), "name", None)
             for c in view.slot_cnst]
    names += [None] * (len(snap.c_bound) - len(names))
    return dict(e_var=snap.e_var[:E].copy(),
                e_cnst=snap.e_cnst[:E].copy(),
                e_w=snap.e_w[:E].copy(),
                c_bound=snap.c_bound.copy(),
                sizes=sizes, remains=rem,
                penalty=pen.astype(np.float64),
                v_bound=snap.v_bound.copy(),
                link_names=names,
                slot_action=dict(slot_action))


class DrainFastPath:
    """Per-network-model drain plan server (see module docstring)."""

    def __init__(self, model):
        self.model = model
        self.sim = None                     # active DrainSim, or None
        self.phase_kind = "none"            # classify_phase at build
        self.slot_action: Dict[int, object] = {}
        self.lat_actions: Dict[int, object] = {}   # latency-phase lanes
        self.live_slots: set = set()        # slots with device pen > 0
        self.version = -1                   # ArrayView version at build
        self.epoch = -1                     # ArrayView layout epoch
        self.absorbing = False              # transitions enabled at build
        self._done_mode = "abs"
        self._done_eps = 0.0
        self.batches: List[Tuple[float, List[int]]] = []
        self.saved = None                   # (pen, rem) at batch start
        self._save = None                   # the buffers saved lives in
        self.served = 0                     # advances of current batch
        self.spec = None                    # in-flight speculative token
        # observability (asserted by tests, reported by tools)
        self.plans = 0
        self.advances_served = 0
        self.invalidations = 0
        self.rollbacks = 0
        self.speculations = 0
        self.spec_commits = 0
        self.spec_discards = 0
        self.transitions_absorbed = 0
        self.transition_slots = 0
        self.partial_advances = 0

    # -- eligibility -------------------------------------------------------

    def _enabled(self) -> bool:
        mode = config["drain/fastpath"]
        if mode not in ("auto", "on", "off"):
            raise ValueError(f"Unknown drain/fastpath {mode!r} "
                             "(expected auto, on or off)")
        if mode == "off":
            return False
        backend = config["lmm/backend"]
        if backend not in ("torch", "auto"):
            return False
        model = self.model
        # FULL-mode only (the hooks live in next_occurring_event_full);
        # selective-update systems are fine: served completions feed
        # the modified set through the var-free closure, so the warm
        # solver (ops.lmm_warm) picks up exactly where the plan left
        # off when the drain phase ends
        if model.is_lazy():
            return False
        n = len(model.started_action_set)
        if n < max(int(config["drain/min-flows"]), _MIN_FLOWS_FLOOR):
            return False
        if backend == "auto" and n < config["lmm/jax-threshold"]:
            return False
        if model.latency_phase_count and not self._transitions_enabled():
            # without transition absorption the plan cannot see latency
            # wakes; with it, latency phases ride as invisible lanes
            return False
        return True

    def _transitions_enabled(self) -> bool:
        mode = config["drain/transitions"]
        if mode not in ("auto", "on", "off"):
            raise ValueError(f"Unknown drain/transitions {mode!r} "
                             "(expected auto, on or off)")
        return mode != "off"

    def _build(self) -> bool:
        """One O(V) walk to check the drain preconditions and map view
        slots to actions, then a snapshot + DrainSim construction.
        Amortized over the K advances each superstep serves."""
        from .lmm_drain import DrainSim

        dtype = (np.float32 if config["lmm/dtype"] == "float32"
                 else np.float64)
        absorbing = self._transitions_enabled()
        plan = _plan_inputs(self.model, dtype, allow_latency=absorbing)
        if plan is None:
            return False
        slot_action, view, snap, sizes, rem, pen, lat_slots = plan

        # fatpipe constraints (the default loopback) have no drain
        # program (the superstep kernel hardcodes SHARED): refuse the
        # plan while any mapped element rides one
        used = np.zeros(len(snap.c_bound), bool)
        used[snap.e_cnst[snap.e_w > 0]] = True
        if np.any(used & snap.c_fatpipe):
            return False

        if dtype == np.float64:
            done_mode = "abs"
            done_eps = (config["maxmin/precision"]
                        * config["surf/precision"])
        else:
            done_mode = "rel"
            done_eps = config["drain/done-eps"]

        # the plan spans the FULL padded view arrays (not the tight
        # n_elem slice): the pow2 slack is what lets transition
        # payloads append new flows' elements without a re-upload —
        # padding carries weight 0 and is masked by the solver
        sim = DrainSim(
            snap.e_var, snap.e_cnst, snap.e_w,
            snap.c_bound, sizes,
            eps=config["maxmin/precision"], done_eps=done_eps,
            dtype=dtype, done_mode=done_mode,
            v_bound=snap.v_bound,
            superstep=int(config["drain/superstep"]),
            penalty=pen, remains=rem,
            # device repacks would detach the replay snapshot from the
            # element tables; plans are rebuilt often enough that the
            # view's own host-side compaction covers shrinkage
            repack_min=1 << 62, device=self.model.engine.device)
        self.sim = sim
        self.phase_kind = classify_phase(sim)
        self.slot_action = slot_action
        self.lat_actions = {s: slot_action[s]
                            for s in sorted(lat_slots)}
        self.live_slots = {int(s) for s in np.flatnonzero(pen > 0)}
        self.version = view.version
        self.epoch = view.layout_epoch
        self.absorbing = absorbing
        self._done_mode = done_mode
        self._done_eps = float(done_eps)
        view.consume("drain")      # reset the dirty-index census
        self.batches = []
        self.saved = None
        self.served = 0
        self.spec = None
        self.plans += 1
        return True

    # -- plan serving ------------------------------------------------------

    def _discard_spec(self) -> None:
        """Drop the in-flight speculative superstep (mispredict: the
        plan is being invalidated or patched, or its batch never
        materialized).  Issue never committed anything, so there is no
        state to restore — only the device work is wasted (and
        counted, ``CarryPool.discard``)."""
        if self.spec is not None:
            if self.sim is not None:
                self.sim._carries.discard(self.sim)
            self.spec_discards += 1
            self.spec = None

    def _save_batch_start(self) -> None:
        """Queue the copy of the committed flow state into the plan's own
        buffers: the batch start a rollback returns to (the JAX token's
        immutable input arrays).  The committed state is what the next
        superstep starts from whether it is issued now or was issued
        speculatively (a speculative superstep writes a spare set)."""
        sim = self.sim
        buf = self._save
        if buf is None or buf[0].shape != sim._pen.shape:
            buf = self._save = (torch.empty_like(sim._pen),
                                torch.empty_like(sim._rem))
        buf[0].copy_(sim._pen)
        buf[1].copy_(sim._rem)
        self.saved = buf

    @staticmethod
    def _restore(sim, saved) -> None:
        """Queue the copy of the batch start back into the committed
        state, in place, so the graphs built over it stay valid."""
        sim._pen.copy_(saved[0])
        sim._rem.copy_(saved[1])

    def _sync_to_served(self) -> None:
        """Rewind the committed device flow state to the advances
        actually served to the engine: deterministic replay of the
        served prefix from the immutable batch-start arrays, then drop
        the now-stale batch tail.  No-op when nothing is outstanding
        (the committed state already IS the served state)."""
        sim = self.sim
        if self.batches and self.saved is not None:
            self._restore(sim, self.saved)
            if self.served:
                sim.superstep_batch(k=self.served, fetch=False)
            self.rollbacks += 1
        self.batches = []
        self.saved = None
        self.served = 0

    def _dispatch_batch(self) -> bool:
        """Collect one superstep (the in-flight speculative one when
        the prediction held, else a fresh dispatch + fetch); False when
        it made no progress (solve exceeded the round budget, or the
        drain stalled — a parked/zero-rate remainder the generic path
        knows how to diagnose)."""
        sim = self.sim
        tok, self.spec = self.spec, None
        # batch-start snapshot for deterministic replay: the committed
        # state, which no speculative superstep writes
        self._save_batch_start()
        if tok is None:
            tok = sim._superstep_issue()
        else:
            sim._carries.inflight.remove(tok)
        self.served = 0
        try:
            n_live, batches, clean = sim._superstep_collect(tok)
        except RuntimeError:
            # stall/non-convergence surfaced mid-batch: the advances it
            # applied were never served, so restore the batch-start
            # state into the committed one and hand the phase back to
            # the generic path
            self._restore(sim, self.saved)
            return False
        if tok.speculative:
            self.spec_commits += 1
        if not batches:
            return False
        self.batches = batches
        if clean and int(config["drain/pipeline"]) > 0:
            # speculative issue of the NEXT superstep, chained from the
            # one just committed: the device executes ring N+1 while
            # the engine consumes ring N's batches below (plans keep ONE
            # token in flight — each ring already covers K engine
            # advances of host work)
            self.spec = sim._superstep_issue(prev=tok)
            sim._carries.inflight.append(self.spec)
            self.speculations += 1
        return True

    def serve(self, now: float) -> Optional[float]:
        """next_occurring_event_full hook: the dt to the next planned
        completion or latency expiry, or None to fall back to the
        generic path (None with a live idle plan means no started
        action — the plan is parked awaiting the next wave)."""
        model = self.model
        if self.sim is not None:
            view = model.system.array_view
            if view is None:
                self._invalidate(sync=True)
            else:
                # mirror the native path's per-advance compaction
                # cadence: the generic solve runs maybe_compact() every
                # next-event, and the per-constraint element ORDER it
                # produces decides the usage sums' rounding — serving
                # from a stale layout would drift the rates a ulp off
                # the host walk.  A compaction here epoch-bumps the
                # view, which is a full (bit-identical) replay below.
                view.maybe_compact()
                if view.layout_epoch != self.epoch:
                    self._invalidate(sync=True)
                elif view.version != self.version:
                    if not (self.absorbing and self._absorb()):
                        self._invalidate(sync=True)
        if self.sim is not None \
                and len(self.lat_actions) != model.latency_phase_count:
            # an action left the latency census behind the view's back
            # (cancel/kill carries no LMM mutation until destroy): the
            # classifier cannot see it, so the plan cannot either
            self._invalidate(sync=True)
        if self.sim is None:
            if not self._enabled() or not self._build():
                return None
        dt = None
        if self.live_slots:
            if not self.batches and not self._dispatch_batch():
                self._invalidate(sync=True, cause="stall")
                return None
            dt = self.batches[0][0]
        if self.lat_actions:
            dt_lat = min(self.lat_actions[s].latency
                         for s in sorted(self.lat_actions))
            if dt is None or dt_lat < dt:
                dt = dt_lat
        if dt is None:
            if self.absorbing and not len(model.started_action_set):
                # idle plan between waves: nothing to time, nothing to
                # go stale — hold it for the next absorbed transition
                return None
            self._invalidate(sync=True)
            return None
        # a profile event before the completion horizon can mutate the
        # system mid-advance: generic path's turn
        next_event = model.engine.future_evt_set.next_date()
        if 0.0 <= next_event <= now + dt:
            self._invalidate(sync=True, cause="profile_event")
            return None
        return dt

    def apply(self, now: float, delta: float) -> bool:
        """update_actions_state_full hook: commit the planned advance
        when the engine advanced by exactly its dt; otherwise absorb
        the partial advance on device (drain/transitions) or roll back
        deterministically and let the generic loop run.  Returns True
        when the advance was fully handled here."""
        if self.sim is None:
            return False
        if self.batches and delta == self.batches[0][0]:
            _dt, slots = self.batches.pop(0)
            self.served += 1
            self.advances_served += 1
            opstats.bump("fastpath_advances")
            self._finish_slots(slots)
            self._advance_latencies(delta)
            return True
        if not self.absorbing:
            if not self.batches:
                return False
            # partial advance (another model's event or a run bound):
            # replay to the served prefix, write remains+rates back,
            # generic loop takes it from here
            self._invalidate(sync=True, with_rates=True,
                             cause="partial_advance")
            return False
        if not self.batches and not self.live_slots \
                and not self.lat_actions \
                and not len(self.model.started_action_set):
            return False       # idle plan: nothing to account
        return self._partial_advance(delta)

    def _finish_slots(self, slots) -> None:
        """Finish the planned completion set in started-set order —
        exactly the generic sweep's traversal — whitelisting the frees
        our own retirements are about to cause.  The started set is
        appended to only, so its order is ``Action.seq``'s: the batch is
        sorted by it instead of walking every started action (JAX's
        walk is O(V) an advance).  A slot the plan cannot attribute to a
        started action of its own takes the walk, as JAX does."""
        from ..kernel.resource import ActionState
        done = set(slots)
        if not done:
            return
        self.live_slots.difference_update(done)
        started = self.model.started_action_set
        acts = []
        for slot in done:
            action = self.slot_action.get(slot)
            var = None if action is None else action.variable
            if (var is None or var._view_slot != slot
                    or action.state_set is not started):
                acts = [a for a in started if a.variable is not None
                        and a.variable._view_slot in done]
                break
            acts.append(action)
        else:
            acts.sort(key=lambda a: a.seq)
        view = self.model.system.array_view
        for action in acts:
            view.expected_frees.add(id(action.variable))
            action.finish(ActionState.FINISHED)

    def _advance_latencies(self, delta: float) -> None:
        """The generic walk's latency bookkeeping, applied to the
        plan's invisible lanes: double_update decrement, census
        maintenance, and the wake's penalty update — which the view
        marks as dirty, so the NEXT serve absorbs it as a transition
        and the lane starts flowing on device."""
        if not self.lat_actions:
            return
        eps = config["surf/precision"]
        model = self.model
        woken = []
        for slot, action in sorted(self.lat_actions.items()):
            if action.latency > delta:
                action.latency = double_update(action.latency, delta,
                                               eps)
            else:
                action.latency = 0.0
            if action.latency <= 0.0:
                if action._lat_counted:
                    action._lat_counted = False
                    model.latency_phase_count -= 1
                if not action.is_suspended():
                    model.system.update_variable_penalty(
                        action.variable, action.effective_penalty)
                woken.append(slot)
        for slot in woken:
            del self.lat_actions[slot]

    def _partial_advance(self, delta: float) -> bool:
        """Serve an engine advance SMALLER than the plan's own dt
        (another model's event, a latency expiry) on device: forced
        remains decrement + threshold retirement at the given delta,
        batches flushed (their schedule shifted), plan kept alive."""
        if self.batches and delta > self.batches[0][0]:
            # the engine advanced PAST our served horizon: a serve/
            # apply protocol breach this path has no semantics for
            self._invalidate(sync=True, with_rates=True)
            return False
        self.partial_advances += 1
        opstats.bump("drain_cause_partial_advance")
        if self.live_slots:
            self._discard_spec()
            try:
                self._sync_to_served()
                done_slots, _n_live = self.sim.partial_advance(delta)
            except RuntimeError:
                self._invalidate(sync=True, with_rates=True,
                                 cause="stall")
                return False
            self._finish_slots(int(s) for s in done_slots)
        else:
            self._discard_spec()
            self.batches = []
            self.saved = None
            self.served = 0
        self._advance_latencies(delta)
        self.advances_served += 1
        opstats.bump("fastpath_advances")
        return True

    # -- transition absorption ---------------------------------------------

    def _absorb(self) -> bool:
        """Classify the mutation batch since the plan's version and
        absorb it into the device plan as ONE fused transition payload.
        Returns False when any mutation is not recognized as resumable
        — the caller then runs the bit-identical replay invalidation.
        Nothing is shipped before classification completes, so a False
        return leaves the device state untouched."""
        model = self.model
        view = model.system.array_view
        if view.layout_epoch != self.epoch:
            return False       # slots renumbered: indices are garbage
        dirty = view.consume("drain")
        if dirty is None:
            return False
        if any(dirty[f] is True for f in sorted(dirty)):
            return False       # index identity lost for a whole field
        if dirty["c_fatpipe"]:
            return False       # sharing-policy change: no drain program

        # classification MUST NOT mutate tracking state before it is
        # complete: a False return hands the plan to _invalidate, whose
        # remains write-back trusts slot_action — stage everything and
        # commit only after the whole batch is recognized
        updates: Dict[str, tuple] = {}
        pen_ix: List[int] = []
        pen_v: List[float] = []
        rem_ix: List[int] = []
        rem_v: List[float] = []
        th_v: List[float] = []
        vb_ix: List[int] = []
        vb_v: List[float] = []
        track: List[Tuple[int, object]] = []   # slot -> action (re)binds
        drop: List[int] = []                   # slots leaving the plan
        lat_add: List[Tuple[int, object]] = []
        lat_del: List[int] = []
        live_add: List[int] = []
        live_del: List[int] = []
        from ..kernel.resource import NO_MAX_DURATION

        # element dirt: structural appends from new flows, weight
        # changes (set_bandwidth re-weighing), retirement zeroing —
        # final-state scatters straight from the f64 masters
        e_dirty = sorted(dirty["e_var"] | dirty["e_cnst"]
                         | dirty["e_w"])
        for i in e_dirty:
            if view.e_w[i] > 0 and view.c_fatpipe[view.e_cnst[i]]:
                return False   # a fatpipe route joined the plan
        if e_dirty:
            updates["e_var"] = (e_dirty,
                                [int(view.e_var[i]) for i in e_dirty])
            updates["e_cnst"] = (e_dirty,
                                 [int(view.e_cnst[i]) for i in e_dirty])
            updates["e_w"] = (e_dirty,
                              [float(view.e_w[i]) for i in e_dirty])
        cb = sorted(dirty["c_bound"])
        if cb:
            updates["c_bound"] = (cb,
                                  [float(view.c_bound[i]) for i in cb])

        for slot in sorted(dirty["v_penalty"] | dirty["v_bound"]):
            var = (view.slot_var[slot]
                   if slot < len(view.slot_var) else None)
            known = self.slot_action.get(slot)
            if var is None:
                # freed lane: our own retirement's echo, or an external
                # free whose version bump rode along — dead either way
                pen_ix.append(slot)
                pen_v.append(0.0)
                drop.append(slot)
                continue
            action = getattr(var, "id", None)
            pen = float(view.v_penalty[slot])
            if (action is None or action.state_set
                    is not model.started_action_set):
                if pen > 0:
                    # a live lane not owned by a started action (e.g. a
                    # cancelled-but-undestroyed flow): the generic solve
                    # keeps sharing bandwidth with it forever; a plan
                    # would retire it — different semantics, bail
                    return False
                pen_ix.append(slot)
                pen_v.append(0.0)
                drop.append(slot)
                continue
            if not math.isfinite(pen):
                return False   # parked flow (inf penalty): replay path
            if known is None or known.variable is not var:
                # a NEW lane (fresh or recycled slot): full admission
                if action.max_duration != NO_MAX_DURATION:
                    return False
                if var.get_number_of_constraint() == 0:
                    return False   # route-less: generic completes it
                remains = action.get_remains_no_update()
                if pen > 0 and remains <= 0:
                    return False
                track.append((slot, action))
                rem_ix.append(slot)
                rem_v.append(remains)
                size = max(action.cost, 1.0)
                th_v.append(self._done_eps if self._done_mode == "abs"
                            else self._done_eps * size)
                if action.latency > 0:
                    lat_add.append((slot, action))
                else:
                    lat_del.append(slot)
            if slot in dirty["v_penalty"]:
                pen_ix.append(slot)
                pen_v.append(pen)
                if pen > 0:
                    live_add.append(slot)
                else:
                    live_del.append(slot)
            if slot in dirty["v_bound"]:
                vb_ix.append(slot)
                vb_v.append(float(view.v_bound[slot]))

        # classification succeeded: commit the staged tracking updates
        for slot in drop:
            self.slot_action.pop(slot, None)
            self.lat_actions.pop(slot, None)
            self.live_slots.discard(slot)
        for slot, action in track:
            self.slot_action[slot] = action
        for slot in lat_del:
            self.lat_actions.pop(slot, None)
        for slot, action in lat_add:
            self.lat_actions[slot] = action
        for slot in live_del:
            self.live_slots.discard(slot)
        for slot in live_add:
            self.live_slots.add(slot)
        if pen_ix:
            updates["v_penalty"] = (pen_ix, pen_v)
        if rem_ix:
            updates["remains"] = (rem_ix, rem_v)
            updates["thresh"] = (rem_ix, th_v)
        if vb_ix:
            updates["v_bound"] = (vb_ix, vb_v)

        # commit: rewind to the served prefix (the scatters describe
        # mutations of the SERVED state), drop speculation, ship the
        # payload, resume — the next serve dispatches a fresh superstep
        self._discard_spec()
        self._sync_to_served()
        n = self.sim.apply_transitions(updates)
        self.version = view.version
        self.transitions_absorbed += 1
        self.transition_slots += n
        opstats.bump("drain_transitions")
        opstats.bump("drain_transition_slots", n)
        opstats.bump("drain_cause_transition")
        return True

    # -- teardown ----------------------------------------------------------

    def _invalidate(self, sync: bool, with_rates: bool = False,
                    cause: str = "unrecognized") -> None:
        """Retire the plan.  With sync=True the device flow state is
        replayed to the served prefix and `remains` written back to the
        still-live actions (with_rates also refreshes
        action.variable.value so the generic loop can apply a partial
        advance).  An in-flight speculative superstep is discarded
        FIRST — it was issued against post-batch state the rollback is
        about to rewind past, and it never committed anything."""
        self._discard_spec()
        sim, saved = self.sim, self.saved
        self.sim = None
        if sim is None:
            return
        self.invalidations += 1
        opstats.bump("drain_cause_" + cause)
        if not sync:
            return
        if self.batches or with_rates:
            # mid-batch stop: deterministic replay of the served prefix
            # from the batch-start buffers (no transfer)
            if saved is not None:
                self._restore(sim, saved)
                if self.served:
                    sim.superstep_batch(k=self.served, fetch=False)
                self.rollbacks += 1
        rem = opstats.timed_fetch(sim._rem)
        pen = opstats.timed_fetch(sim._pen)
        rates = sim.solve_rates() if with_rates else None
        # any advances this plan served mean the host System's cached
        # rates are stale: force the next generic call to re-solve
        self.model.system.modified = True
        for slot, action in sorted(self.slot_action.items()):
            if pen[slot] <= 0:
                continue
            if action.state_set is not self.model.started_action_set:
                continue
            action.remains = float(rem[slot])
            if rates is not None:
                action.variable.value = float(rates[slot])
        self.batches = []
        self.saved = None
        self.served = 0
        self.slot_action = {}
        self.lat_actions = {}
        self.live_slots = set()
