"""Carry state from the JAX package into the port, through numpy only.

* :func:`lmm_arrays` turns a flattened system (the JAX package's
  ``LmmArrays`` or any object or mapping with the same fields, given as
  numpy or anything ``np.asarray`` reads) into the port's
  :class:`~simgrid_tpu_torch.ops.lmm_arrays.LmmArrays`.
* :func:`drain_state` reads a drain's committed mid-run state from a
  JAX ``DrainSim`` (by attribute, without importing it): flow penalties,
  remains, thresholds, rate bounds and ids, the compacted element
  arrays, the clock, events and counters.  :func:`resume_drain` builds a port
  :class:`~simgrid_tpu_torch.ops.lmm_drain.DrainSim` that continues from
  that state, so a drain can run N supersteps in JAX and finish here.
  :func:`port_drain_state` reads the same state from a port drain, so
  a drain on the card can hand over to the plain path on the CPU.
* :func:`port_warm_state` turns the JAX warm solver's resident masters
  and carried fixpoint state (numpy) into the port's, so that K6 and a
  warm solve can start from the state a JAX solve left.
* :func:`ell_arrays` turns a JAX ``LmmEllArrays`` (or anything with its
  fields) into the port's :class:`~simgrid_tpu_torch.ops.lmm_ell.
  LmmEllArrays`, and :func:`port_ell_warm_state` adds the JAX warm
  solver's resident ELL masters and its ELL carry (with ``cv_live``) to
  a port state, so that K7, K8 and K6's ELL arm can start from JAX's
  own state.
* :func:`tape_from_jax` copies a fault event tape triple (as the JAX
  package's ``ScenarioPlan.tape_for`` returns it) into the dtypes the
  port's ``DrainSim(tape=...)`` takes, and :func:`collective_from_jax`
  turns a JAX ``DeviceCollective`` (by attribute) into the port's, so
  that both packages drain the same compiled DAG.
* :func:`fleet_state` turns a JAX ``BatchDrainSim.committed_state()``
  (a dict of numpy arrays and host records) into the input of the
  port's ``BatchDrainSim.restore_state``, so a fleet can run N
  supersteps in JAX and finish here.

Nothing here imports ``simgrid_tpu`` or ``jax``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .kernels.common import IT, LIGHT
from .kernels.common import EllWork
from .collectives.tape import DeviceCollective
from .ops.lmm_arrays import LmmArrays
from .ops.lmm_drain import DrainSim
from .ops.lmm_ell import LmmEllArrays, ell_system
from .ops.lmm_warm import DtypeState, resident_state

_LMM_FIELDS = LmmArrays._fields


def lmm_arrays(src) -> LmmArrays:
    """An ``LmmArrays`` from any object or mapping with its fields."""
    get = src.get if isinstance(src, dict) else (lambda k: getattr(src, k))
    vals = {}
    for k in _LMM_FIELDS:
        v = get(k)
        vals[k] = int(v) if k in ("n_elem", "n_cnst", "n_var") \
            else np.asarray(v)
    return LmmArrays(**vals)


class DrainState(NamedTuple):
    """A drain's committed state between two advances or supersteps."""
    e_var: np.ndarray      # [E] int32, compacted (padded to 8)
    e_cnst: np.ndarray     # [E] int32
    e_w: np.ndarray        # [E] float
    c_bound: np.ndarray    # [C] float
    pen: np.ndarray        # [V] float — 0 = retired
    rem: np.ndarray        # [V] float
    thresh: np.ndarray     # [V] float
    ids: np.ndarray        # [V] int32 — slot -> original flow id
    vb: np.ndarray         # [V] float — rate bounds (-1 = none)
    has_bounds: bool       # the drain runs the fixpoint's bound arm
    sizes: np.ndarray      # [V] float64 (read by the host repack only)
    t: float
    live0: int
    host: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]
    events: List[Tuple[float, int]]
    advances: int
    rounds: int
    supersteps: int
    repacks: int


def drain_state(sim) -> DrainState:
    """Read the committed state of a JAX ``DrainSim`` (between
    supersteps or advances; a drain with a tape, collective or pipeline
    in flight is not supported by the port)."""
    flat = [np.asarray(a).reshape(-1) for a in sim._dev]
    flat_pen = np.asarray(sim._pen)
    host = None
    if getattr(sim, "_host", None) is not None:
        host = tuple(np.asarray(sim._host[k])
                     for k in ("e_var", "e_cnst", "e_w"))
    return DrainState(
        e_var=flat[0].astype(np.int32), e_cnst=flat[1].astype(np.int32),
        e_w=flat[2], c_bound=np.asarray(sim._cb),
        pen=flat_pen, rem=np.asarray(sim._rem),
        thresh=np.asarray(sim._thresh),
        ids=np.asarray(sim._ids_dev).astype(np.int32),
        vb=np.asarray(sim._vb), has_bounds=bool(sim.has_bounds),
        # the JAX drain stops maintaining sizes after a device repack;
        # only the host repack reads them, and it needs the host mirror
        sizes=(np.asarray(sim._sizes, np.float64) if host is not None
               else np.zeros(len(flat_pen), np.float64)),
        t=float(sim.t),
        live0=int(sim._live0), host=host, events=list(sim.events),
        advances=int(sim.advances), rounds=int(sim.rounds),
        supersteps=int(sim.supersteps), repacks=int(sim.repacks))


def port_drain_state(sim: DrainSim) -> DrainState:
    """The same committed state, read from one of the port's own
    ``DrainSim``s on any device: with :func:`resume_drain` it hands a
    drain over from the card to the CPU (or back) between supersteps."""
    def host(t):
        return t.detach().cpu().numpy().copy()
    s = sim.sys
    return DrainState(
        e_var=host(s.e_var), e_cnst=host(s.e_cnst), e_w=host(s.e_w),
        c_bound=host(s.c_bound), pen=host(sim._pen), rem=host(sim._rem),
        thresh=host(sim._thresh), ids=host(sim._ids_dev).astype(np.int32),
        vb=host(sim._vb), has_bounds=bool(sim.has_bounds),
        # as drain_state: the sizes are read by the host repack only
        sizes=(np.asarray(sim._sizes, np.float64).copy()
               if sim._host is not None else np.zeros(sim.n_v)),
        t=float(sim.t), live0=int(sim._live0),
        host=(None if sim._host is None else tuple(
            np.asarray(sim._host[k]).copy()
            for k in ("e_var", "e_cnst", "e_w"))),
        events=list(sim.events), advances=int(sim.advances),
        rounds=int(sim.rounds), supersteps=int(sim.supersteps),
        repacks=int(sim.repacks))


def resume_drain(state: DrainState, **kw) -> DrainSim:
    """A port ``DrainSim`` that continues from `state`.  Keyword
    arguments are the constructor's (``eps``, ``dtype``, ``superstep``,
    ``fused``, ``device``, ...); the flow and element arrays, clock,
    events and counters come from the state."""
    sim = DrainSim(state.e_var, state.e_cnst, state.e_w, state.c_bound,
                   np.asarray(state.sizes, np.float64),
                   penalty=state.pen, remains=state.rem, v_bound=state.vb,
                   **kw)
    # the JAX drain's flag, which a transition may have switched on
    sim.has_bounds = bool(state.has_bounds)
    dtype = sim.dtype
    sim._thresh = sim._put(np.asarray(state.thresh, dtype))
    sim._ids_dev = sim._put(np.asarray(state.ids, np.int32))
    sim._ids = np.asarray(state.ids, np.int64)
    sim._ids_stale = False
    if state.host is not None:
        sim._host = dict(e_var=np.asarray(state.host[0], np.int32),
                         e_cnst=np.asarray(state.host[1], np.int32),
                         e_w=np.asarray(state.host[2], dtype))
    else:
        sim._host = None
    sim._live0 = int(state.live0)
    sim.t = float(state.t)
    sim.events = list(state.events)
    sim.advances = int(state.advances)
    sim.rounds = int(state.rounds)
    sim.supersteps = int(state.supersteps)
    sim.repacks = int(state.repacks)
    return sim


def port_warm_state(masters: Sequence, carry: Sequence, dtype,
                    device: DeviceLike = None) -> DtypeState:
    """The port's resident state of one solve dtype from the JAX warm
    solver's: ``masters`` are its seven master arrays (``e_var``,
    ``e_cnst``, ``e_w``, ``c_bound``, ``c_fatpipe``, ``v_penalty``,
    ``v_bound``) and ``carry`` its converged fixpoint state
    (``v_value``, ``v_fixed``, ``remaining``, ``usage``, ``light``,
    ``it``), anything ``np.asarray`` reads.  The returned state holds the
    masters on ``device``, their row indexes, and a Work holding the
    carry (``carry_valid`` set)."""
    key = np.dtype(dtype)
    arrays = [np.asarray(m) for m in masters]
    for i in (2, 3, 5, 6):
        arrays[i] = arrays[i].astype(key)
    st = resident_state(arrays, resolve_device(device))
    w = st.work
    for name, src in zip(("v_value", "v_fixed", "remaining", "usage",
                          "light"), carry[:5]):
        t = getattr(w, name)
        t.copy_(torch.from_numpy(np.asarray(src).astype(
            np.bool_ if t.dtype == torch.bool else key)))
    w.ctrl[IT] = int(np.asarray(carry[5]))
    w.ctrl[LIGHT] = int(np.count_nonzero(np.asarray(carry[4])))
    w.carry_valid = True
    return st


def ell_arrays(src) -> LmmEllArrays:
    """A port ``LmmEllArrays`` from any object with its fields."""
    vals = {}
    for k in LmmEllArrays._fields:
        v = getattr(src, k)
        vals[k] = (int(v) if k in ("n_cnst", "n_var")
                   else None if v is None else np.asarray(v))
    return LmmEllArrays(**vals)


def port_ell_warm_state(st: DtypeState, ell: Sequence, carry: Sequence
                        ) -> DtypeState:
    """Add the JAX warm solver's ELL residency to the port state ``st``
    (from :func:`port_warm_state`): ``ell`` are its six ELL masters
    (``cv_var``, ``cv_w``, ``cv_valid``, ``vc_cnst``, ``vc_valid``,
    ``vc_w``) and ``carry`` its converged ELL fixpoint state
    (``v_value``, ``v_fixed``, ``remaining``, ``usage``, ``light``,
    ``it``, ``cv_live``).  The ELL system shares the COO masters' bounds
    and FATPIPE flags; the returned state's ``ell_work`` holds the carry
    (``carry_valid`` set)."""
    dev = st.masters[0].device
    key = st.masters[2].dtype
    t = [torch.from_numpy(np.array(a)).to(dev) for a in ell]
    t[1], t[5] = t[1].to(key), t[5].to(key)
    st.ell = ell_system(t[0], t[1], t[2], t[3], t[4], t[5], st.masters[3],
                        st.masters[4])
    n_c, wc = t[0].shape
    n_v, wv = t[3].shape
    st.ell_shape = (n_c, wc, n_v, wv)
    w = st.ell_work = EllWork(n_v, n_c, wc, key, dev)
    for name, src in zip(("v_value", "v_fixed", "remaining", "usage",
                          "light"), carry[:5]):
        d = getattr(w, name)
        d.copy_(torch.from_numpy(np.array(src)).to(d.dtype))
    w.cv_live.copy_(torch.from_numpy(np.asarray(carry[6], bool)))
    w.ctrl[IT] = int(np.asarray(carry[5]))
    w.ctrl[LIGHT] = int(np.count_nonzero(np.asarray(carry[4])))
    w.carry_valid = True
    return st


def tape_from_jax(triple) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A fault event tape ``(dates, slots, values)`` as f64, int32 and f64
    numpy copies (``DrainSim(tape=...)`` casts the values to its dtype,
    as the JAX drain does)."""
    t, s, v = triple
    return (np.array(t, np.float64), np.array(s, np.int32),
            np.array(v, np.float64))


_DC_FIELDS = ("e_var", "e_cnst", "e_w", "c_bound", "sizes", "penalty0",
              "pred0", "ready0", "edge_src", "edge_dst", "exec_cost")


def collective_from_jax(dc) -> DeviceCollective:
    """The port's ``DeviceCollective`` with the arrays of a JAX one (read
    by attribute; its schedule object is not carried over)."""
    return DeviceCollective.from_arrays(
        int(dc.n_c), *(np.asarray(getattr(dc, f)) for f in _DC_FIELDS))


def fleet_state(jax_state: dict) -> dict:
    """A JAX fleet's committed state (``BatchDrainSim.committed_state()``,
    unsharded: its padded width is its width) as the port's
    ``BatchDrainSim.restore_state`` takes it: numpy copies of every
    array (a collective fleet's ``coll_pred``, ``coll_ready`` and
    ``coll_clk`` rows and its ragged ``cev_*`` activation streams among
    them, as they are), the element weights flattened from the JAX
    fleet's ``[B, E/8, 8]`` table to ``[B, E]``, and the host records as
    they are."""
    arrays = {k: np.array(v) for k, v in jax_state["arrays"].items()}
    if "ew" in arrays:
        arrays["ew"] = arrays["ew"].reshape(arrays["ew"].shape[0], -1)
    return {"arrays": arrays,
            "errors": list(jax_state.get("errors") or []),
            "faults": [None if f is None else dict(f)
                       for f in jax_state.get("faults") or []],
            "counters": dict(jax_state.get("counters") or {})}
