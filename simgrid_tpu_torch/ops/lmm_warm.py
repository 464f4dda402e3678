"""Warm-started selective solves on the card.

The port's counterpart of ``simgrid_tpu/ops/lmm_warm.py`` (``:95-778``,
its COO leg).  A selective-update System re-solves only the constraints
reachable from a mutation (maxmin.cpp's selective update): the max-min
solution decomposes by connected component, so untouched components
keep their exact previous solution.  The warm solver carries that onto
the card:

* **Resident masters, delta uploads.**  The view's seven flattened
  arrays (:data:`~..kernels.transition_scatter.DELTA_FIELDS`) stay on
  the device between solves; each solve ships one float64 payload of
  the slots the System mutated since the last one
  (``ArrayView.consume``), padded as the JAX package pads it, and K5
  (``delta_scatter``) writes it into the masters.  The row indexes K1
  walks are rebuilt on the device after any element change
  (``ops/csr.build_csr``, counted as ``row_index_builds``, not as
  uploaded bytes, so ``uploaded_bytes_*`` stay comparable with JAX's).
* **Warm restarts.**  The previous converged solve stays in the
  fixpoint :class:`~..kernels.common.Work`.  K6 (``warm_init``) resets
  only the modified component to the cold init and masks everything
  else fixed and dark (the modified constraints handed to it sorted,
  :func:`modified_index`); K1's rounds then run from that state, so the
  rounds drop from the depth of the whole system to the depth of the
  delta, and the result equals a cold solve of the same arrays bit for
  bit, as every round's reductions are component-local.

* **The ELL leg** (``lmm_warm.py:111-116, 141-199, 377-513`` in the JAX
  package).  Where the solve's layout resolves to ELL (``flags.layout``
  ``ell``, or ``auto`` on the card) the solve is served from resident
  ELL masters beside the COO ones: built on the host with the same
  widths, caps and stable lane order as ``lmm_ell.ell_from_arrays``,
  kept up to date by element deltas (a new element takes lane
  ``fill[row]++`` on each side; K5 writes the six flat runs,
  ``delta_scatter_ell``), rebuilt when a row outgrows its width or the
  slot tables grow.  Cold solves start from K7's init, warm ones from
  K6's ELL arm; the rounds are K8's (local, bound-free) or K7's.  A
  system the caps refuse is served in COO and counted in
  ``warm_ell_fallbacks``.  The carry is layout-addressed (``cv_live``
  lives at (row, lane)), so the carry's tag names the layout and the
  ELL table shape, and a flip of either restarts cold.

Carry invalidation follows the reference exactly: a layout epoch or
shape change re-uploads everything and restarts cold; a whole-field
dirt, a dirty slot outside the modified component that the solve can
see, or a live element crossing the component boundary restart cold;
each solve dtype keeps its own masters and carry; a solve that raises
leaves no carry behind (``Work.carry_valid``).  The warm/cold decisions
and every counter are taken on the host from the same numpy arrays as
the reference's, so they agree with it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.common import EllSystem, EllWork, LmmSystem, Work
from ..kernels.ell_round import ell_init
from ..kernels.lmm_round import lmm_init
from ..kernels.transition_scatter import (DELTA_FIELDS, delta_scatter,
                                          ell_delta_scatter)
from ..kernels.warm_init import warm_init, warm_init_ell
from . import opstats
from .csr import build_csr
from .lmm_arrays import bucket
from .lmm_ell import build_vc_index, ell_tables, ell_widths
from .lmm_torch import (SolveError, chunk_rounds, reset_modified, run_chunks,
                        uses_ell)
from .lmm_view import ArrayView

_CAST_FIELDS = ("e_w", "c_bound", "v_penalty", "v_bound")
_ELEM_FIELDS = ("e_var", "e_cnst", "e_w")


def modified_index(mc: np.ndarray) -> np.ndarray:
    """The modified constraints as K6 takes them: int32, sorted
    (non-decreasing), padded to ``bucket(len(mc), floor=8)`` entries by
    repeating the last one.  The JAX warm solver pads its index by
    repeating the first entry in the caller's order; both give the same
    set and the same byte count, and K6's kernel needs the order (it
    decides "modified" by binary search)."""
    mc = np.sort(np.asarray(mc, np.int64))
    if len(mc) == 0:
        raise ValueError("no modified constraint")
    out = np.empty(bucket(len(mc), floor=8), np.int32)
    out[:len(mc)] = mc
    out[len(mc):] = mc[-1]
    return out


class DtypeState:
    """Per-solve-dtype device residency: the seven masters (in
    ``DELTA_FIELDS`` order), the system K1 reads (masters plus row
    indexes), the fixpoint state that carries the last converged solve,
    and the tags that say what the masters and the carry track."""

    __slots__ = ("masters", "sys", "work", "shapes", "epoch", "meta",
                 "ell", "ell_work", "ell_shape", "ell_n", "cv_lane",
                 "vc_lane", "cv_fill", "vc_fill")

    def __init__(self, masters: Sequence[torch.Tensor]):
        self.masters = list(masters)
        e_w, c_bound, v_penalty = masters[2], masters[3], masters[5]
        self.shapes = (int(e_w.shape[0]), int(c_bound.shape[0]),
                       int(v_penalty.shape[0]))
        self.sys: LmmSystem = None
        self.rebuild_rows()
        self.work = Work(self.shapes[2], self.shapes[1], e_w.dtype,
                         e_w.device)
        self.epoch = -1            # view.layout_epoch the masters track
        self.meta = None           # (eps, local, layout, ELL shape) of it
        # ELL residency: the six tables (an EllSystem over them and the
        # COO masters' bounds and FATPIPE flags), the ELL fixpoint state,
        # and the host lane maps that let element deltas land in place
        self.ell: Optional[EllSystem] = None
        self.ell_work: Optional[EllWork] = None
        self.ell_shape = None      # (C, Wc, V, Wv)
        self.ell_n = 0             # element slots placed so far
        self.cv_lane = None        # per-element lane in its cv row
        self.vc_lane = None        # per-element lane in its vc row
        self.cv_fill = None        # per-constraint occupied lane count
        self.vc_fill = None        # per-variable occupied lane count

    def works(self):
        return [w for w in (self.work, self.ell_work) if w is not None]

    def drop_carry(self) -> None:
        for w in self.works():
            w.carry_valid = False

    def rebuild_rows(self) -> None:
        """Both row indexes from the masters, on their device (a new
        LmmSystem, so K1's pointer cache builds afresh)."""
        ev, ec, ew, cb, fat = self.masters[:5]
        csr = build_csr(ev, ec, ew, self.shapes[1], self.shapes[2])
        self.sys = LmmSystem(ev, ec, ew, cb, csr, self.shapes[2], fat)
        opstats.bump("row_index_builds")


def resident_state(arrays: Sequence[np.ndarray], device: torch.device
                   ) -> DtypeState:
    """A DtypeState whose masters are copies of the seven numpy arrays
    (``DELTA_FIELDS`` order, already in the solve dtype) on
    ``device``."""
    return DtypeState([torch.from_numpy(np.array(a)).to(device)
                       for a in arrays])


class WarmSolver:
    """Device-resident incremental solver attached to one System."""

    def __init__(self, system, device: DeviceLike = None):
        self.system = system
        self.device = resolve_device(device)
        system.warm_solver = self
        self._states: Dict[np.dtype, DtypeState] = {}
        # observability (read by tests, tools and the smoke run)
        self.solves = 0
        self.warm_solves = 0
        self.cold_solves = 0
        self.warm_ell_fallbacks = 0
        self.carry_invalidations = 0
        self.last_rounds = 0
        self.last_mode = ""
        self.last_layout = ""
        self.last_upload_bytes = 0
        self.last_dirty_slots = 0

    # -- carry management --------------------------------------------------

    def invalidate(self) -> None:
        """Drop every carried fixpoint state (masters stay resident).
        Called when a solve happened outside this solver (the host
        fallback), so stale values never seed a warm restart."""
        for dt in sorted(self._states, key=str):
            st = self._states[dt]
            if any(w.carry_valid for w in st.works()):
                self.carry_invalidations += 1
            st.drop_carry()

    # -- upload ------------------------------------------------------------

    @staticmethod
    def _cast(view, field: str, key):
        src = getattr(view, field)
        return src.astype(key) if field in _CAST_FIELDS else src

    def _upload_full(self, view, key) -> DtypeState:
        arrays = [self._cast(view, f, key) for f in DELTA_FIELDS]
        nbytes = sum(a.nbytes for a in arrays)
        st = resident_state(arrays, self.device)
        st.epoch = view.layout_epoch
        opstats.bump("uploaded_bytes_full", nbytes)
        self.last_upload_bytes += nbytes
        return st

    def _refresh_field(self, st: DtypeState, view, key, f: str) -> None:
        arr = self._cast(view, f, key)
        st.masters[DELTA_FIELDS.index(f)].copy_(torch.from_numpy(arr))
        opstats.bump("uploaded_bytes_full", arr.nbytes)
        self.last_upload_bytes += arr.nbytes

    def _upload_delta(self, st: DtypeState, view, key, dirty,
                      delta: bool) -> int:
        """Apply per-index mutations to the device masters; returns the
        number of dirty slots shipped, or -1 when a field lost its index
        identity (re-shipped whole; the caller drops the carry)."""
        true_fields = [f for f in DELTA_FIELDS if dirty[f] is True]
        for f in true_fields:
            self._refresh_field(st, view, key, f)
        idx_fields = [(f, sorted(dirty[f])) for f in DELTA_FIELDS
                      if dirty[f] is not True and dirty[f]]
        n_slots = sum(len(ix) for _, ix in idx_fields)
        if idx_fields and delta:
            layout = []
            chunks = []
            off = 0
            for f, ix in idx_fields:
                # JAX's padding: bucket(n, floor=8), the tail repeating
                # the first (index, value) pair
                n = bucket(len(ix), floor=8)
                idx = np.empty(n, np.float64)
                vals = np.empty(n, np.float64)
                idx[:len(ix)] = ix
                idx[len(ix):] = ix[0]
                src = getattr(view, f)
                vals[:len(ix)] = src[ix]
                vals[len(ix):] = src[ix[0]]
                layout.append((DELTA_FIELDS.index(f), off, n))
                chunks.append(idx)
                chunks.append(vals)
                off += 2 * n
            payload = np.concatenate(chunks)
            delta_scatter(torch.from_numpy(payload).to(self.device), layout,
                          st.masters)
            opstats.bump("uploaded_bytes_delta", payload.nbytes)
            self.last_upload_bytes += payload.nbytes
        else:
            # whole-field refresh of only the fields that changed
            for f, _ in idx_fields:
                self._refresh_field(st, view, key, f)
        if any(f in _ELEM_FIELDS for f in true_fields) or any(
                f in _ELEM_FIELDS for f, _ in idx_fields):
            st.rebuild_rows()
        if true_fields:
            return -1
        return n_slots

    # -- ELL residency -----------------------------------------------------

    def _build_ell(self, st: DtypeState, view, key) -> bool:
        """Host rebuild of the ELL masters and lane maps from the view
        (``lmm_warm.py:377-441``: the widths, caps and stable lane order
        of ``ell_from_arrays``).  Returns False when the caps refuse the
        system."""
        n_e = view.n_elem
        e_var = view.e_var[:n_e].astype(np.int64)
        e_cnst = view.e_cnst[:n_e].astype(np.int64)
        e_w = view.e_w[:n_e]
        n_c, n_v = len(view.c_bound), len(view.v_penalty)
        widths = ell_widths(e_var, e_cnst, n_c, n_v)
        if widths is None:
            st.ell = None
            return False
        c_deg, v_deg, wc, wv = widths
        arrays, cv_l, vc_l = ell_tables(e_var, e_cnst, e_w, n_c, n_v, wc,
                                        wv, key)
        cv_lane = np.full(len(view.e_var), -1, np.int32)
        vc_lane = np.full(len(view.e_var), -1, np.int32)
        cv_lane[:n_e], vc_lane[:n_e] = cv_l, vc_l
        nbytes = sum(a.nbytes for a in arrays)
        t = [torch.from_numpy(a).to(self.device) for a in arrays]
        st.ell = EllSystem(t[0], t[1], t[2], t[3], t[4], t[5],
                           st.masters[3], st.masters[4],
                           **build_vc_index(t[3], t[4], t[5], n_c))
        shape = (n_c, wc, n_v, wv)
        if st.ell_work is None or st.ell_shape != shape:
            st.ell_work = EllWork(n_v, n_c, wc, t[1].dtype, self.device)
        st.ell_shape = shape
        st.ell_n = n_e
        st.cv_lane, st.vc_lane = cv_lane, vc_lane
        st.cv_fill = c_deg.astype(np.int32)
        st.vc_fill = v_deg.astype(np.int32)
        opstats.bump("uploaded_bytes_full", nbytes)
        self.last_upload_bytes += nbytes
        return True

    def _sync_ell(self, st: DtypeState, view, key, dirty) -> bool:
        """Scatter the element dirt into the resident ELL masters
        (``lmm_warm.py:443-500``).  New elements (append-only within an
        epoch) take lane ``fill[row]++`` on each side, the lane a fresh
        stable-order build gives them.  Returns False when a row
        overflows its padded width or the slot tables grew (rebuild)."""
        e_dirty = sorted(dirty["e_var"] | dirty["e_cnst"] | dirty["e_w"])
        if not e_dirty:
            return True
        n_c, wc, n_v, wv = st.ell_shape
        if (len(view.c_bound) != n_c or len(view.v_penalty) != n_v
                or len(view.e_var) != len(st.cv_lane)):
            return False
        cols = [[] for _ in range(6)]
        for i in e_dirty:
            v = int(view.e_var[i])
            c = int(view.e_cnst[i])
            w = float(view.e_w[i])
            if i >= st.ell_n:
                lane_c = int(st.cv_fill[c])
                lane_v = int(st.vc_fill[v])
                if lane_c >= wc or lane_v >= wv:
                    return False
                st.cv_fill[c] = lane_c + 1
                st.vc_fill[v] = lane_v + 1
                st.cv_lane[i] = lane_c
                st.vc_lane[i] = lane_v
            else:
                lane_c = int(st.cv_lane[i])
                lane_v = int(st.vc_lane[i])
                if lane_c < 0 or lane_v < 0:
                    return False
            for col, x in zip(cols, (c * wc + lane_c, v, w, v * wv + lane_v,
                                     c, w)):
                col.append(x)
        st.ell_n = max(st.ell_n, e_dirty[-1] + 1)

        # JAX's padding (bucket(n, floor=8), the tail repeating the
        # first entry) and its byte count: six arrays, four int32 and
        # two in the solve dtype
        n = bucket(len(cols[0]), floor=8)
        pads = []
        for src, dt in zip(cols, (np.int32, np.int32, key, np.int32,
                                  np.int32, key)):
            a = np.empty(n, dt)
            a[:len(src)] = src
            a[len(src):] = src[0]
            pads.append(a)
        cv_idx, cv_v, cv_wv, vc_idx, vc_c, vc_wv = (
            a.astype(np.float64) for a in pads)
        # per ELL master (ELL_FIELDS order): flat indexes, then values;
        # the validity masters take the weights (written as w > 0)
        runs = ((cv_idx, cv_v), (cv_idx, cv_wv), (cv_idx, cv_wv),
                (vc_idx, vc_c), (vc_idx, vc_wv), (vc_idx, vc_wv))
        payload = np.concatenate([x for run in runs for x in run])
        layout = [(ti, 2 * n * ti, n) for ti in range(6)]
        e = st.ell
        ell_delta_scatter(torch.from_numpy(payload).to(self.device), layout,
                          [e.cv_var, e.cv_w, e.cv_valid, e.vc_cnst,
                           e.vc_valid, e.vc_w])
        st.ell = e._replace(**build_vc_index(e.vc_cnst, e.vc_valid,
                                             e.vc_w, n_c))
        nbytes = sum(a.nbytes for a in pads)
        opstats.bump("uploaded_bytes_delta", nbytes)
        self.last_upload_bytes += nbytes
        return True

    def _ensure_ell(self, st: DtypeState, view, key, dirty) -> bool:
        """Bring the ELL masters up to date with the view; True when the
        solve can be served in the ELL layout (``lmm_warm.py:502-513``)."""
        if st.ell is not None and dirty is not None \
                and not any(dirty[f] is True
                            for f in ("e_var", "e_cnst", "e_w")):
            if self._sync_ell(st, view, key, dirty):
                return True
        # missing, stale or overflowed: rebuild (a new table shape
        # restarts cold through the carry's tag)
        return self._build_ell(st, view, key)

    # -- carry validity ----------------------------------------------------

    @staticmethod
    def _delta_in_component(view, dirty, c_mod, v_mod, has_live_elem,
                            has_live_c) -> bool:
        """Every slot mutated since the carry must be either inside the
        modified component or invisible to the solve (zero weight, no
        live element) — otherwise the carried values of some untouched
        slot are stale and only a cold restart is exact."""
        e_dirty = dirty["e_var"] | dirty["e_cnst"] | dirty["e_w"]
        if e_dirty:
            ei = np.fromiter(e_dirty, np.int64, len(e_dirty))
            if not np.all(c_mod[view.e_cnst[ei]] | (view.e_w[ei] == 0.0)):
                return False
        v_dirty = dirty["v_penalty"] | dirty["v_bound"]
        if v_dirty:
            vi = np.fromiter(v_dirty, np.int64, len(v_dirty))
            visible = (view.v_penalty[vi] > 0) & has_live_elem[vi]
            if not np.all(v_mod[vi] | ~visible):
                return False
        c_dirty = dirty["c_bound"] | dirty["c_fatpipe"]
        if c_dirty:
            ci = np.fromiter(c_dirty, np.int64, len(c_dirty))
            if not np.all(c_mod[ci] | ~has_live_c[ci]):
                return False
        return True

    def _can_warm(self, view, dirty, mc, shapes) -> bool:
        """The reference's closure and boundary checks
        (``lmm_warm.py:595-614``), on the host."""
        c_mod = np.zeros(shapes[1], bool)
        c_mod[mc] = True
        live = view.e_w > 0
        en = view.v_penalty > 0
        v_mod = np.zeros(shapes[2], bool)
        v_mod[view.e_var[live & c_mod[view.e_cnst]]] = True
        has_live_elem = np.zeros(shapes[2], bool)
        has_live_elem[view.e_var[live]] = True
        has_live_c = np.zeros(shapes[1], bool)
        has_live_c[view.e_cnst[live & en[view.e_var]]] = True
        # component-closure boundary: a live enabled variable of the
        # modified component must not touch any unmodified constraint,
        # or a cold solve could fix it at that constraint's level while
        # the warm solve cannot
        boundary_ok = not np.any(live & en[view.e_var] & v_mod[view.e_var]
                                 & ~c_mod[view.e_cnst])
        return boundary_ok and self._delta_in_component(
            view, dirty, c_mod, v_mod, has_live_elem, has_live_c)

    # -- solve -------------------------------------------------------------

    def solve(self, view, cnst_list, dtype, eps: float, warm: bool):
        """Solve the System with the given modified constraints; returns
        host (values, remaining, usage) at view slot numbering.  Raises
        :class:`SolveError` on non-convergence, a stall or non-finite
        rates (the caller degrades to the host list solver)."""
        flags = self.system.flags
        key = np.dtype(dtype)
        view.maybe_compact()
        st = self._states.get(key)
        dirty = view.consume(f"warm:{key}")
        shapes = (len(view.e_var), len(view.c_bound), len(view.v_penalty))

        self.last_upload_bytes = 0
        self.last_dirty_slots = 0
        full = (dirty is None or st is None
                or st.epoch != view.layout_epoch or st.shapes != shapes)
        if full:
            st = self._states[key] = self._upload_full(view, key)
        else:
            n_slots = self._upload_delta(st, view, key, dirty,
                                         flags.delta_upload != "off")
            if n_slots < 0:
                st.drop_carry()
            else:
                self.last_dirty_slots = n_slots

        use_ell = False
        if uses_ell(flags.layout, self.device):
            use_ell = self._ensure_ell(st, view, key,
                                       None if full else dirty)
            if not use_ell:
                self.warm_ell_fallbacks += 1
                opstats.bump("warm_ell_fallbacks")
        self.last_layout = "ell" if use_ell else "coo"

        eps_f = float(eps)
        parallel = flags.rounds == "local"
        meta = (eps_f, parallel, self.last_layout,
                st.ell_shape if use_ell else None)
        mc = np.fromiter((c._view_slot for c in cnst_list), np.int64,
                         len(cnst_list))
        w = st.ell_work if use_ell else st.work
        pen, vb_all = st.masters[5], st.masters[6]

        restarted = (warm and w.carry_valid and st.meta == meta
                     and self._can_warm(view, dirty, mc, shapes))
        # the state is written in place from here on: poisoned until
        # this solve converges
        st.drop_carry()
        if restarted:
            mc_pad = modified_index(mc)
            opstats.bump("uploaded_bytes_delta", mc_pad.nbytes)
            self.last_upload_bytes += mc_pad.nbytes
            # K6 takes the index on the host and uploads it itself
            if use_ell:
                warm_init_ell(st.ell, w, pen, mc_pad, eps_f)
            else:
                warm_init(st.sys, w, pen, mc_pad, eps_f)

        # as JAX decides them for the warm path: over every view slot
        has_bounds = bool(np.any((view.v_bound > 0) & (view.v_penalty > 0)))
        has_fatpipe = bool(view.c_fatpipe.any())
        sys = st.ell if use_ell else st.sys
        if not restarted:
            if use_ell:
                ell_init(sys, w, pen, eps_f, vb_all)
            else:
                lmm_init(sys, w, pen, eps_f, has_fatpipe=has_fatpipe)
        vb = vb_all if use_ell or has_bounds else None
        values, remaining, usage, rounds = run_chunks(
            sys, w, pen, eps_f, vb, has_bounds, has_fatpipe, not parallel,
            chunk_rounds(self.device, shapes[0]),
            ("LMM warm solve", f"{shapes[1]} constraint slots, "
                               f"{shapes[2]} variable slots"))
        if not np.all(np.isfinite(values)):
            raise SolveError(
                "LMM warm solve returned non-finite rates "
                f"({shapes[1]} constraint slots, {shapes[2]} variable "
                f"slots)")
        w.carry_valid = True
        st.meta = meta

        self.solves += 1
        self.last_rounds = rounds
        self.last_mode = "warm" if restarted else "cold"
        if restarted:
            self.warm_solves += 1
            opstats.bump("warm_solves")
            # a warm restart whose whole delta is constraint bounds (the
            # fault-injection signature) is counted apart
            if dirty is not None and all(
                    f == "c_bound" or not dirty[f]
                    for f in sorted(dirty)) and dirty.get("c_bound"):
                opstats.bump("warm_bound_restarts")
        else:
            self.cold_solves += 1
            opstats.bump("cold_solves")
        opstats.bump("solves")
        opstats.bump("fixpoint_rounds", rounds)
        return values, remaining, usage


def solve_selective(system, dtype, eps: float,
                    device: DeviceLike = None) -> bool:
    """Device entry of selective-update systems: serve the solve from
    the warm solver.  Returns False when ``warm_start="off"`` asks for
    the legacy re-flatten path instead.

    Host side effects mirror the list solver's selective init pass
    (``lmm_torch.reset_modified``), and only the modified constraints'
    variables, remaining and usage are written back."""
    mode = system.flags.warm_start
    if mode == "off":
        return False
    view = system.array_view
    if view is None:
        view = ArrayView(system)
    solver = system.warm_solver
    if solver is None:
        solver = WarmSolver(system, device)

    cnst_list = reset_modified(system)
    if cnst_list:
        values, remaining, usage = solver.solve(
            view, cnst_list, dtype, eps, warm=mode in ("auto", "on"))
        for cnst in cnst_list:
            ci = cnst._view_slot
            cnst.remaining = float(remaining[ci])
            cnst.usage = float(usage[ci])
            for elem in cnst.enabled_element_set:
                elem.variable.value = \
                    float(values[elem.variable._view_slot])

    system.modified = False
    system.remove_all_modified_set()
    return True
