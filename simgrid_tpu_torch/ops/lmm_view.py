"""Array-primary incremental view of an LMM System.

The port's own copy of ``simgrid_tpu/ops/lmm_view.py``.  The view keeps
the padded COO arrays (:class:`~simgrid_tpu_torch.ops.lmm_arrays.LmmArrays`)
alive across solves and applies every System mutation incrementally,
instead of walking the intrusive lists on every solve (maxmin.cpp:509-539):

* new constraints / variables take slots from a free list (O(1));
* ``expand`` appends element triples into bucketed spare capacity
  (O(1) amortized);
* enable/disable/penalty/bound updates are single array writes — the
  solve derives element validity from ``(e_w > 0) & (v_penalty > 0)``,
  so enabling a variable after its latency phase is a pure value
  update here;
* freeing a variable zeroes its elements' weights (masked out in the
  solve) and recycles the slot; dead element slots are compacted away
  only when they outnumber live ones (amortized O(1) per free).

Mutated fields are handed to the solver as copy-on-write snapshots
(``snapshot``): an unchanged field keeps its previous ndarray identity.

Beyond whole-field dirtiness the view also tracks dirty *indices* per
named consumer (``consume``): the warm-start solver
(:mod:`simgrid_tpu_torch.ops.lmm_warm`) keeps the master arrays resident
on the device and applies mutations as one indexed scatter payload, so
its upload cost scales with the number of touched slots instead of
field size.  ``version`` counts mutation events and ``expected_frees``
lists frees a consumer already applied (the drain fast path's census).
Index tracking is only meaningful while slot numbering is stable, so
every renumbering or reallocation (growth, ``_compact``) bumps
``layout_epoch`` — consumers treat an epoch change as everything-dirty.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .lmm_host import SharingPolicy
from .lmm_arrays import LmmArrays, bucket as _bucket

#: Fields whose mutation does not change the element structure.
_FIELDS = ("e_var", "e_cnst", "e_w", "c_bound", "c_fatpipe",
           "v_penalty", "v_bound")


class ArrayView:
    """Incrementally-maintained flat arrays for one System."""

    #: fields cast to the requested solve dtype on handout (masters are
    #: always float64 so f64 and f32 solves can alternate without
    #: rebuilding the view)
    _CAST_FIELDS = ("e_w", "c_bound", "v_penalty", "v_bound")

    def __init__(self, system):
        self.system = system
        self.dtype = np.float64          # master array dtype
        #: mutation census for plan-based consumers (the drain fast
        #: path): bumped ONCE per mutation event (not once per touched
        #: field) by every hook EXCEPT the free of a variable the
        #: consumer pre-registered in `expected_frees` — retiring a
        #: flow the device plan already retired changes nothing the
        #: plan does not know about
        self.version = 0
        #: bumped whenever slot numbering or array allocation changes
        #: (growth, _compact): per-index dirtiness from before the bump
        #: no longer addresses the same data
        self.layout_epoch = 0
        self.expected_frees: set = set()
        #: per-requested-dtype dirty sets and handout snapshots
        self._dirty: Dict[np.dtype, set] = {}
        self._handout: Dict[np.dtype, Dict[str, np.ndarray]] = {}
        #: named consumers tracking dirty INDICES per field (see
        #: consume()); value per field is a set of slots, or True when
        #: index identity was lost (whole field dirty)
        self._consumers: Dict[str, Dict[str, object]] = {}
        self._free_var_slots: List[int] = []
        self._free_cnst_slots: List[int] = []
        self.slot_var: List = []
        self.slot_cnst: List = []
        self.n_elem = 0
        self.dead_elems = 0
        self._build()
        system.array_view = self

    # -- initial build ----------------------------------------------------
    def _build(self) -> None:
        """Walk the existing System once (same element order as
        lmm_torch.flatten: per-constraint, enabled then disabled) and
        seed the arrays."""
        sys_ = self.system
        cnsts = list(sys_.constraint_set)
        variables = list(sys_.variable_set)
        n_c, n_v = len(cnsts), len(variables)
        e_triples = []
        var_slot: Dict[int, int] = {}
        self.slot_var = list(variables)
        self.slot_cnst = list(cnsts)
        for slot, var in enumerate(variables):
            var._view_slot = slot
            var_slot[id(var)] = slot
        for ci, cnst in enumerate(cnsts):
            cnst._view_slot = ci
            for elem in list(cnst.enabled_element_set) + \
                    list(cnst.disabled_element_set):
                e_triples.append((elem, var_slot[id(elem.variable)], ci))
        n_e = len(e_triples)
        E, C, V = _bucket(max(n_e, 1)), _bucket(max(n_c, 1)), \
            _bucket(max(n_v, 1))
        self.e_var = np.zeros(E, np.int32)
        self.e_cnst = np.zeros(E, np.int32)
        self.e_w = np.zeros(E, self.dtype)
        self.c_bound = np.zeros(C, self.dtype)
        self.c_fatpipe = np.zeros(C, bool)
        self.v_penalty = np.zeros(V, self.dtype)
        self.v_bound = np.full(V, -1.0, self.dtype)
        for k, (elem, vs, cs) in enumerate(e_triples):
            elem._view_eslot = k
            self.e_var[k] = vs
            self.e_cnst[k] = cs
            self.e_w[k] = elem.consumption_weight
        for ci, cnst in enumerate(cnsts):
            self.c_bound[ci] = cnst.bound
            self.c_fatpipe[ci] = cnst.sharing_policy == SharingPolicy.FATPIPE
        for slot, var in enumerate(variables):
            self.v_penalty[slot] = var.sharing_penalty
            self.v_bound[slot] = var.bound
        self.n_elem = n_e
        self.dead_elems = 0

    # -- mutation hooks (called from System) ------------------------------
    # Each hook bumps `version` exactly ONCE per mutation event (plan
    # invalidation censuses count mutations, not fields) and marks the
    # touched field/slot pairs via _mark.
    def _mark(self, field: str, idx=None) -> None:
        """Record `field` (slot `idx`, or the whole field when None) as
        dirty for every handout dtype and every index consumer.  Each
        mark is a set insertion, so the order of the dtypes and
        consumers changes nothing; they are not sorted (the JAX copy's
        sort by dtype name cost the engine's 100,000-flow drain more
        than its superstep graphs)."""
        for dirty in self._dirty.values():
            dirty.add(field)
        for cons in self._consumers.values():
            cur = cons[field]
            if cur is True:
                continue
            if idx is None:
                cons[field] = True
            else:
                cur.add(idx)

    def consume(self, name: str):
        """Hand the named consumer its accumulated dirty-index map
        ({field: set-of-slots | True}) and reset it.  Returns None on
        the first call (unseen consumer: everything is dirty).  Index
        validity is scoped to `layout_epoch`: after an epoch bump the
        returned indices address renumbered slots and must be ignored
        in favor of a full refresh."""
        prev = self._consumers.get(name)
        self._consumers[name] = {f: set() for f in _FIELDS}
        return prev

    def on_policy(self, cnst) -> None:
        self.version += 1
        self.c_fatpipe[cnst._view_slot] = \
            cnst.sharing_policy == SharingPolicy.FATPIPE
        self._mark("c_fatpipe", cnst._view_slot)

    def on_new_cnst(self, cnst) -> None:
        self.version += 1
        if self._free_cnst_slots:
            slot = self._free_cnst_slots.pop()
            self.slot_cnst[slot] = cnst
        else:
            slot = len(self.slot_cnst)
            self.slot_cnst.append(cnst)
            if slot >= len(self.c_bound):
                grow = _bucket(slot + 1, grow=True)
                cb = np.zeros(grow, self.dtype)
                cb[:len(self.c_bound)] = self.c_bound
                self.c_bound = cb
                fat = np.zeros(grow, bool)
                fat[:len(self.c_fatpipe)] = self.c_fatpipe
                self.layout_epoch += 1
                self.c_fatpipe = fat
                self._mark("c_bound")
                self._mark("c_fatpipe")
        cnst._view_slot = slot
        self.c_bound[slot] = cnst.bound
        self.c_fatpipe[slot] = cnst.sharing_policy == SharingPolicy.FATPIPE
        self._mark("c_bound", slot)
        self._mark("c_fatpipe", slot)

    def on_new_var(self, var) -> None:
        self.version += 1
        if self._free_var_slots:
            slot = self._free_var_slots.pop()
            self.slot_var[slot] = var
        else:
            slot = len(self.slot_var)
            self.slot_var.append(var)
            if slot >= len(self.v_penalty):
                grow = _bucket(slot + 1, grow=True)
                vp = np.zeros(grow, self.dtype)
                vp[:len(self.v_penalty)] = self.v_penalty
                self.v_penalty = vp
                vb = np.full(grow, -1.0, self.dtype)
                vb[:len(self.v_bound)] = self.v_bound
                self.layout_epoch += 1
                self.v_bound = vb
                self._mark("v_penalty")
                self._mark("v_bound")
        var._view_slot = slot
        self.v_penalty[slot] = var.sharing_penalty
        self.v_bound[slot] = var.bound
        self._mark("v_penalty", slot)
        self._mark("v_bound", slot)

    def on_expand(self, elem) -> None:
        self.version += 1          # ONE bump per structural mutation
        k = self.n_elem
        if k >= len(self.e_var):
            grow = _bucket(k + 1, grow=True)
            ev = np.zeros(grow, np.int32); ev[:len(self.e_var)] = self.e_var
            ec = np.zeros(grow, np.int32); ec[:len(self.e_cnst)] = self.e_cnst
            self.e_var, self.e_cnst = ev, ec
            ew = np.zeros(grow, self.dtype)
            ew[:len(self.e_w)] = self.e_w
            self.layout_epoch += 1
            self.e_w = ew
            self._mark("e_var")
            self._mark("e_cnst")
            self._mark("e_w")
        elem._view_eslot = k
        self.e_var[k] = elem.variable._view_slot
        self.e_cnst[k] = elem.constraint._view_slot
        self.e_w[k] = elem.consumption_weight
        self.n_elem = k + 1
        self._mark("e_var", k)
        self._mark("e_cnst", k)
        self._mark("e_w", k)

    def on_weight(self, elem) -> None:
        self.version += 1
        self.e_w[elem._view_eslot] = elem.consumption_weight
        self._mark("e_w", elem._view_eslot)

    def on_penalty(self, var) -> None:
        self.version += 1
        self.v_penalty[var._view_slot] = var.sharing_penalty
        self._mark("v_penalty", var._view_slot)

    def on_vbound(self, var) -> None:
        self.version += 1
        self.v_bound[var._view_slot] = var.bound
        self._mark("v_bound", var._view_slot)

    def on_cbound(self, cnst) -> None:
        self.version += 1
        self.c_bound[cnst._view_slot] = cnst.bound
        self._mark("c_bound", cnst._view_slot)

    def on_var_free(self, var) -> None:
        """Called BEFORE var.cnsts is cleared: kill the elements on
        device (zero weight) and recycle the variable slot."""
        # an expected free (a retirement the drain fast path already
        # applied on device) leaves the plan-consistency version alone;
        # the dirty-index marks still happen — device-resident masters
        # must see the zeroing either way
        bump = True
        if self.expected_frees:
            bump = id(var) not in self.expected_frees
            if not bump:
                self.expected_frees.discard(id(var))
        if bump:
            self.version += 1
        for elem in var.cnsts:
            self.e_w[elem._view_eslot] = 0.0
            self.dead_elems += 1
            self._mark("e_w", elem._view_eslot)
        slot = var._view_slot
        self.v_penalty[slot] = 0.0
        self.slot_var[slot] = None
        self._free_var_slots.append(slot)
        self._mark("v_penalty", slot)

    def on_cnst_free(self, cnst) -> None:
        self.version += 1
        slot = cnst._view_slot
        self.c_bound[slot] = 0.0
        self.slot_cnst[slot] = None
        self._free_cnst_slots.append(slot)
        self._mark("c_bound", slot)

    # -- solve-side -------------------------------------------------------
    def _compact(self) -> None:
        """Drop dead element slots (weight 0 from freed variables).
        Live zero-weight elements (e.g. staged concurrency edges) are
        kept: they are re-registered from their objects."""
        keep = []
        for cnst in self.slot_cnst:
            if cnst is None:
                continue
            for elem in (list(cnst.enabled_element_set)
                         + list(cnst.disabled_element_set)):
                keep.append(elem)
        n_e = len(keep)
        E = _bucket(max(n_e, 1))
        e_var = np.zeros(E, np.int32)
        e_cnst = np.zeros(E, np.int32)
        e_w = np.zeros(E, self.dtype)
        for k, elem in enumerate(keep):
            elem._view_eslot = k
            e_var[k] = elem.variable._view_slot
            e_cnst[k] = elem.constraint._view_slot
            e_w[k] = elem.consumption_weight
        self.e_var, self.e_cnst, self.e_w = e_var, e_cnst, e_w
        self.n_elem = n_e
        self.dead_elems = 0
        self.version += 1          # element slots renumbered
        self.layout_epoch += 1
        self._mark("e_var")
        self._mark("e_cnst")
        self._mark("e_w")

    def maybe_compact(self) -> None:
        """Drop dead element slots once they outnumber live ones
        (amortized O(1) per free); bumps layout_epoch when it runs."""
        if self.dead_elems > max(64, self.n_elem - self.dead_elems):
            self._compact()

    def snapshot(self, dtype) -> LmmArrays:
        """Copy-on-write handout in the requested dtype: dirty fields
        get a fresh copy (new identity => device re-upload), clean
        fields keep their previous object (device cache hit)."""
        self.maybe_compact()
        key = np.dtype(dtype)
        if key not in self._handout:
            self._handout[key] = {}
            self._dirty[key] = set(_FIELDS)
        h, dirty = self._handout[key], self._dirty[key]
        for f in dirty:
            src = getattr(self, f)
            h[f] = src.astype(key) if f in self._CAST_FIELDS \
                else src.copy()
        dirty.clear()
        return LmmArrays(h["e_var"], h["e_cnst"], h["e_w"], h["c_bound"],
                         h["c_fatpipe"], h["v_penalty"], h["v_bound"],
                         self.n_elem, len(self.slot_cnst),
                         len(self.slot_var))

