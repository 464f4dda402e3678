"""Scenario fleets: B replicas of one shared system drained in lockstep.

Counterpart of ``simgrid_tpu/ops/lmm_batch.py``: Monte Carlo fault
campaigns, parameter sweeps and per-user what-ifs over one platform,
where every replica is a scenario that differs from the shared base by a
compact override record.  Each kernel launch serves every replica: the
per-replica state has a leading replica axis (``kernels.common.Work``
with ``B``), K1-K3 pick their replica by ``blockIdx.y`` and guard on its
own control words, and K11 (``kernels/fleet_materialize.py``) builds the
per-replica state on the card from the base arrays and the payloads.  A
fleet superstep therefore launches as many kernels as a solo superstep,
whatever B is: the amortisation the JAX package's ``vmap`` gives.

* **one shared system**: the COO structure, the row indexes and, by
  default, the element weights are uploaded once; per replica are the
  constraint bounds, penalties, remains and thresholds (and the weights
  when a replica overrides some, ``batch_w``);
* **compact payloads** (:class:`ReplicaOverrides`): global bandwidth and
  size scales, sparse link and flow factors, dead flows and element
  weights, materialised by K11 in ``derive_replica_arrays``'s order;
* **lockstep supersteps with an alive mask**: a dead replica gets k = 0,
  so its guards are false from entry and its state comes back unchanged
  by bits; it logs no ring entry (checked every superstep, counted in
  ``pad_events``);
* **one fetch per fleet superstep**: K3 packs ``[B, packed_size]``, and
  the host demultiplexes the rings into per-replica events, fault events
  and clocks (each clock folded in f64 per superstep, as the solo
  collect folds it);
* **collective fleets** (``collective=``, one compiled comm DAG ``(pred,
  ready, edge_src, edge_dst, exec_cost)``): the edges and exec costs are
  shared, and every replica walks the schedule with its own predecessor
  counts, activation dates ``[B, V]`` and Kahan clock pair ``[B, 2]``
  (K11 writes their birth rows).  Each advance slot runs K2's event arm
  on the replicas' dates, K3's collective arm and K10's replica arm;
  the rings carry absolute dates, activations are tagged ``-(n_c + v) -
  1``, a replica with no live flow stays alive while its schedule owes
  completions, and one that then makes no advance is quarantined as
  ``collective_deadlock``.

Each replica's events, fault events and clock equal by bits the same
scenario drained solo by :class:`~.lmm_drain.DrainSim` (``ScenarioPlan.
solo``): the replica runs the solo kernels' arithmetic in the solo fold
order, and the fleet never repacks.  A fleet superstep is one launch of
K16's graph (``kernels/superstep_loop.py``), the solo loop nest with each
condition taken over all B replicas (a slot runs while any replica's is
active, a round while any replica's fixpoint runs) and every kernel
gating on its own replica's control words, so the grouping of advances
into supersteps is JAX's for every replica.

The round budget of a superstep is the port's solo ``DrainSim``'s,
``superstep * 512`` on every device (the JAX fleet takes 256 off the
CPU); it changes no result, only when a budget rescue runs.

Not ported yet: ``pipeline`` (ROADMAP A2), ``mesh`` (A9), ``plan`` and
``watchdog`` (A8); each raises ``NotImplementedError`` naming its item.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels import fleet_materialize as k11
from ..kernels.dag_walk import dag_walk
from ..kernels.common import (DT, FLAG_BUDGET, FLAG_STALLED, IT, LIGHT,
                              LIVE_ACC, MAX_ROUNDS, LmmSystem, Work)
from ..kernels.drain_advance import drain_advance
from ..kernels.lmm_round import lmm_init, lmm_round, plan_of
from ..kernels.superstep_commit import (N_STATS, packed_size,
                                        superstep_commit, superstep_finish,
                                        superstep_reset)
from ..kernels.superstep_loop import (PRED_ROUND, PRED_SUPERSTEP,
                                      DeviceLoop, Loop, cached)
from . import opstats
from .csr import build_csr
from .lmm_arrays import to2d
from .lmm_drain import _torch_dtype, collective_arrays
from .lmm_torch import chunk_rounds


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class AdmissionError(RuntimeError):
    """A replica admission the fleet cannot honour within the capacity
    fixed at its birth: the row is alive or out of range, the overrides
    carry ``elem_w`` entries but the fleet shares one weight table, or
    the fault tape is wider than the fleet's tape rows, or the overrides
    kill flows of a collective schedule."""


class LaneFault:
    """Why one replica was quarantined: killed with a recorded cause
    while the rest of the fleet kept draining.  Causes: ``nan_solve``
    (a NaN clock advance, or NaN in the replica's state behind a stall),
    ``stall`` (no flow holds bandwidth), ``non_convergence`` (the budget
    rescue could not finish one advance), ``ring_overflow`` (more events
    than ring slots), ``collective_deadlock`` (no live flow and no pending
    activation while the schedule still owes completions).  Each bumps
    ``lane_quarantined_<cause>``."""

    __slots__ = ("cause", "detail", "lane", "superstep", "t")

    def __init__(self, cause: str, detail: str, lane: int,
                 superstep: int = 0, t: float = 0.0):
        self.cause = str(cause)
        self.detail = str(detail)
        self.lane = int(lane)
        self.superstep = int(superstep)
        self.t = float(t)

    def to_dict(self) -> Dict:
        return {"cause": self.cause, "detail": self.detail,
                "lane": self.lane, "superstep": self.superstep,
                "t": self.t}

    @classmethod
    def from_dict(cls, d: Dict) -> "LaneFault":
        return cls(d["cause"], d["detail"], d["lane"],
                   superstep=d.get("superstep", 0), t=d.get("t", 0.0))

    def __repr__(self) -> str:
        return (f"LaneFault(cause={self.cause!r}, lane={self.lane}, "
                f"t={self.t!r}, detail={self.detail!r})")


def _pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (>= 1): admission payload widths."""
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


class ReplicaOverrides:
    """One replica's deviation from the shared base scenario:
    ``bw_scale`` and ``size_scale`` (global link-capacity and flow-size
    multipliers), ``link_scale`` ({constraint slot: factor}),
    ``flow_scale`` ({variable slot: factor}), ``dead_flows`` (variable
    slots whose penalty is 0) and ``elem_w`` ({element slot: weight})."""

    __slots__ = ("bw_scale", "size_scale", "link_scale", "flow_scale",
                 "dead_flows", "elem_w")

    def __init__(self, bw_scale: float = 1.0, size_scale: float = 1.0,
                 link_scale: Optional[Dict[int, float]] = None,
                 flow_scale: Optional[Dict[int, float]] = None,
                 dead_flows: Iterable[int] = (),
                 elem_w: Optional[Dict[int, float]] = None):
        if bw_scale <= 0 or size_scale <= 0:
            raise ValueError("bw_scale and size_scale must be > 0")
        self.bw_scale = float(bw_scale)
        self.size_scale = float(size_scale)
        self.link_scale = dict(link_scale or {})
        self.flow_scale = dict(flow_scale or {})
        self.dead_flows = tuple(sorted(set(int(s) for s in dead_flows)))
        self.elem_w = dict(elem_w or {})


def derive_replica_arrays(c_bound, sizes, remains, penalty,
                          ov: ReplicaOverrides):
    """One replica's f64 arrays on the host, in K11's order: base times
    the global scale, then the sparse factors in sorted slot order;
    ``(c_bound, sizes, remains, penalty)``."""
    cb = np.asarray(c_bound, np.float64) * ov.bw_scale
    for slot in sorted(ov.link_scale):
        cb[slot] *= ov.link_scale[slot]
    sz = np.asarray(sizes, np.float64) * ov.size_scale
    rem = np.asarray(remains, np.float64) * ov.size_scale
    for slot in sorted(ov.flow_scale):
        sz[slot] *= ov.flow_scale[slot]
        rem[slot] *= ov.flow_scale[slot]
    pen = np.asarray(penalty, np.float64).copy()
    for slot in ov.dead_flows:
        pen[slot] = 0.0
    return cb, sz, rem, pen


def derive_replica_ew(e_w, ov: ReplicaOverrides, dtype) -> np.ndarray:
    """One replica's element weights on the host: the overridden slots
    SET in sorted order, then the dtype cast (K11's weight arm)."""
    ew = np.asarray(e_w, np.float64).copy()
    for slot in sorted(ov.elem_w):
        ew[slot] = ov.elem_w[slot]
    return ew.astype(dtype)


def _pack_overrides(specs: List[ReplicaOverrides], n_c: int, n_v: int,
                    widths: Optional[Tuple[int, int, int]] = None):
    """The fleet's payload rows ``(bw, fs, li, lf, fi, ff, di)``: index
    arrays padded with the out-of-range slot (dropped), factors with 1.0;
    ``widths`` fixes the three sparse widths (admission buckets)."""
    B = len(specs)
    sl, sf, sd = widths or (max(1, max(len(s.link_scale) for s in specs)),
                            max(1, max(len(s.flow_scale) for s in specs)),
                            max(1, max(len(s.dead_flows) for s in specs)))
    bw = np.array([s.bw_scale for s in specs], np.float64)
    fs = np.array([s.size_scale for s in specs], np.float64)
    li = np.full((B, sl), n_c, np.int32)
    lf = np.ones((B, sl), np.float64)
    fi = np.full((B, sf), n_v, np.int32)
    ff = np.ones((B, sf), np.float64)
    di = np.full((B, sd), n_v, np.int32)
    for b, s in enumerate(specs):
        for j, slot in enumerate(sorted(s.link_scale)):
            li[b, j] = slot
            lf[b, j] = s.link_scale[slot]
        for j, slot in enumerate(sorted(s.flow_scale)):
            fi[b, j] = slot
            ff[b, j] = s.flow_scale[slot]
        for j, slot in enumerate(s.dead_flows):
            di[b, j] = slot
    return bw, fs, li, lf, fi, ff, di


def _pack_elem_w(specs: List[ReplicaOverrides], pad_idx: int, dtype,
                 width: Optional[int] = None):
    """The fleet's element-weight payload ``(ei, ew)``, padded with the
    out-of-range slot ``pad_idx``."""
    B = len(specs)
    se = width or max(1, max(len(s.elem_w) for s in specs))
    ei = np.full((B, se), pad_idx, np.int32)
    ew = np.zeros((B, se), dtype)
    for b, s in enumerate(specs):
        for j, slot in enumerate(sorted(s.elem_w)):
            ei[b, j] = slot
            ew[b, j] = s.elem_w[slot]
    return ei, ew


# ---------------------------------------------------------------------------
# Batched flattened solve: B rate queries over one structure
# ---------------------------------------------------------------------------

def solve_arrays_batch(e_var, e_cnst, e_w, c_bound, c_fatpipe, v_penalty,
                       v_bound, eps: float, parallel_rounds: bool = True,
                       chunk: Optional[int] = None,
                       device: DeviceLike = None, mesh=None):
    """Solve B max-min systems sharing one COO structure; returns numpy
    ``(values [B, V], remaining [B, C], usage [B, C], rounds [B])``.

    ``e_w`` is ``[E]`` (shared) or ``[B, E]``; ``c_bound``,
    ``v_penalty`` and ``v_bound`` are ``[B, ·]``.  Every replica runs
    K1's rounds in the same launches and stops on its own convergence;
    after each chunk of at most ``chunk`` rounds (one K16 launch; the
    port's ``chunk_rounds``: 4096 on the CPU, 256 on the card, 32 from
    2**20 elements) one ``[B, 3 + V + 2C]`` fetch brings the round, light and fixed counts
    and the results, with the same stall and round-cap errors as the
    JAX package."""
    if mesh is not None:
        raise _not_ported("solve_arrays_batch(mesh=)",
                          "queue A item 9 (replica-sharded fleets)")
    dev = resolve_device(device)
    e_w = np.asarray(e_w)
    batch_w = e_w.ndim == 2
    dtype = e_w.dtype
    tdt = _torch_dtype(dtype)
    c_bound = np.asarray(c_bound, dtype)
    v_penalty = np.asarray(v_penalty, dtype)
    v_bound = np.asarray(v_bound, dtype)
    B, n_c = c_bound.shape
    n_v = v_penalty.shape[1]
    c_fatpipe = np.asarray(c_fatpipe, bool)
    has_bounds = bool(np.any((v_bound > 0) & (v_penalty > 0)))
    has_fatpipe = bool(c_fatpipe.any())
    if chunk is None:
        chunk = chunk_rounds(dev, len(np.asarray(e_var)))
    shared_bytes = (np.asarray(e_var).nbytes + np.asarray(e_cnst).nbytes
                    + c_fatpipe.nbytes + (0 if batch_w else e_w.nbytes))
    batched_bytes = (c_bound.nbytes + v_penalty.nbytes + v_bound.nbytes
                     + (e_w.nbytes if batch_w else 0))
    opstats.bump("uploaded_bytes_full", shared_bytes + batched_bytes)
    put = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(dev)
    ev = put(np.asarray(e_var, np.int32))
    ec = put(np.asarray(e_cnst, np.int32))
    ew = put(e_w)
    # the union of the replicas' positive weights: the kernels skip an
    # element a replica weighs 0, so every fold keeps its solo order
    ew_any = (ew > 0).any(0).to(tdt) if batch_w else ew
    sys = LmmSystem(ev, ec, ew, put(c_bound),
                    build_csr(ev, ec, ew_any, n_c, n_v), n_v,
                    put(c_fatpipe))
    pen, vb = put(v_penalty), put(v_bound)
    w = Work(n_v, n_c, tdt, dev, B=B)
    global_rounds = not parallel_rounds
    loop = DeviceLoop(
        [Loop(PRED_ROUND, w.ctrl, (lambda: lmm_round(
            sys, w, pen, eps, vb if has_bounds else None, has_bounds,
            has_fatpipe, global_rounds),), cap=chunk,
            tally="lmm_round_fleet")],
        "chunk_fleet", dev, refs=(sys, w, pen, vb),
        prepare=lambda: plan_of(sys, w))
    lmm_init(sys, w, pen, eps, has_fatpipe=has_fatpipe)
    prev_progress = None
    while True:
        loop.run()
        opstats.bump("dispatches")
        opstats.bump("batch_dispatches")
        head = torch.stack([w.ctrl[:, IT], w.ctrl[:, LIGHT],
                            w.v_fixed.sum(1, dtype=torch.int32)], 1)
        fetched = opstats.timed_fetch(torch.cat(
            [head.to(tdt), w.v_value, w.remaining, w.usage], 1))
        rounds_h = fetched[:, 0].astype(np.int64)
        n_light = fetched[:, 1].astype(np.int64)
        n_fixed = fetched[:, 2].astype(np.int64)
        if not n_light.any():
            break
        if (rounds_h >= MAX_ROUNDS).any():
            bad = int(np.argmax(rounds_h >= MAX_ROUNDS))
            raise RuntimeError(
                f"LMM batch solve: replica {bad} did not converge "
                f"within {MAX_ROUNDS} saturation rounds "
                f"({n_c} constraints, {n_v} variables, batch {B})")
        progress = (n_light.tobytes(), n_fixed.tobytes())
        if progress == prev_progress:
            bad = int(np.argmax(n_light > 0))
            raise RuntimeError(
                f"LMM batch solve stalled: replica {bad} made no "
                f"progress over {chunk} rounds ({int(n_light[bad])} "
                f"active constraints); the system does not converge "
                f"at eps={eps} in {np.dtype(dtype).name} precision")
        prev_progress = progress
    opstats.bump("fixpoint_rounds", int(rounds_h.sum()))
    return (fetched[:, 3:3 + n_v], fetched[:, 3 + n_v:3 + n_v + n_c],
            fetched[:, 3 + n_v + n_c:3 + n_v + 2 * n_c], rounds_h)


# ---------------------------------------------------------------------------
# The batched drain executor
# ---------------------------------------------------------------------------

class ReplicaState:
    """Host-side record of one replica in a fleet."""

    __slots__ = ("index", "events", "fault_events", "collective_events",
                 "t", "advances", "alive", "error", "fault")

    def __init__(self, index: int):
        self.index = index
        self.events: List[Tuple[float, int]] = []
        #: (time, constraint slot) per fired tape entry, fire order
        self.fault_events: List[Tuple[float, int]] = []
        #: (time, flow slot) per fired collective activation, fire order
        self.collective_events: List[Tuple[float, int]] = []
        self.t = 0.0              # f64 clock, folded on the host
        self.advances = 0
        self.alive = True
        self.error: Optional[str] = None
        #: why the replica was quarantined (None for a clean finish)
        self.fault: Optional[LaneFault] = None


class BatchDrainSim:
    """Drain B scenario replicas of one shared system to completion in
    lockstep fleet supersteps (module docstring).

    Arguments mirror the JAX ``BatchDrainSim``: COO elements, constraint
    capacities, flow sizes, one :class:`ReplicaOverrides` per replica,
    ``eps``, ``done_eps``/``done_mode``, ``dtype`` (default float64, as
    the JAX fleet), ``superstep=K`` and its round budget
    ``superstep_rounds`` (default ``K*512``), the device, shared
    ``v_bound``/``penalty``/``remains``, ``tapes`` (one ``(dates, slots,
    values)`` fault tape or None per replica), ``tape_slots`` (tape rows
    reserved for admissions, bucketed to a power of two), ``start_dead``
    (rows dead from birth, waiting for :meth:`admit_lane`), ``batch_w``
    (per-replica weight tables even when no initial replica overrides
    weights) and ``collective`` (one compiled comm DAG every replica
    walks, module docstring)."""

    def __init__(self, e_var, e_cnst, e_w, c_bound, sizes,
                 overrides: List[ReplicaOverrides],
                 eps: float = 1e-5, done_eps: float = 1e-4,
                 dtype=np.float64, done_mode: str = "rel",
                 superstep: int = 8, superstep_rounds: int = 0,
                 device: DeviceLike = None, v_bound=None, penalty=None,
                 remains=None, pipeline: int = 0, mesh=None, tapes=None,
                 plan=None, tape_slots: int = 0, start_dead=(),
                 batch_w: Optional[bool] = None, watchdog=None,
                 collective=None):
        for arg, what, item in (
                (pipeline, "BatchDrainSim(pipeline=)",
                 "queue A item 2 (the speculative issue/collect split)"),
                (mesh, "BatchDrainSim(mesh=)",
                 "queue A item 9 (replica-sharded fleets)"),
                (plan, "BatchDrainSim(plan=)",
                 "queue A item 8 (the AOT plan cache)"),
                (watchdog, "BatchDrainSim(watchdog=)",
                 "queue A item 8 (the serving layer)")):
            if arg:
                raise _not_ported(what, item)
        if not overrides:
            raise ValueError("BatchDrainSim needs at least one replica")
        if done_mode not in ("rel", "abs"):
            raise ValueError(f"Unknown done_mode {done_mode!r} "
                             "(expected rel or abs)")
        self.device = resolve_device(device)
        self.eps = float(eps)
        self.done_eps = float(done_eps)
        self.done_mode = done_mode
        self.dtype = np.dtype(dtype)
        self.tdtype = _torch_dtype(dtype)
        self.B = len(overrides)
        self.overrides = list(overrides)
        self.n_c = len(c_bound)
        self.n_v = len(sizes)
        self.superstep_k = int(superstep)
        if self.superstep_k <= 0:
            raise ValueError("BatchDrainSim is superstep-only "
                             "(superstep >= 1)")
        self.superstep_rounds = (int(superstep_rounds)
                                 or self.superstep_k * 512)
        dev, B = self.device, self.B

        self._base = [np.asarray(c_bound, np.float64),
                      np.asarray(sizes, np.float64)]
        self._base.append(np.asarray(remains, np.float64)
                          if remains is not None else self._base[1])
        self._base.append(np.asarray(penalty, np.float64)
                          if penalty is not None
                          else np.ones(self.n_v, np.float64))
        ev2 = to2d(np.asarray(e_var, np.int32)).reshape(-1)
        ec2 = to2d(np.asarray(e_cnst, np.int32)).reshape(-1)
        ew2 = to2d(np.asarray(e_w, self.dtype)).reshape(-1)
        self.batch_w = (any(ov.elem_w for ov in overrides)
                        if batch_w is None else bool(batch_w))
        if v_bound is not None:
            vb = np.asarray(v_bound, self.dtype)
            self.has_bounds = bool(np.any(vb > 0))
        else:
            vb = np.full(self.n_v, -1.0, self.dtype)
            self.has_bounds = False
        ids = np.arange(self.n_v, dtype=np.int32)
        opstats.bump("uploaded_bytes_full",
                     ev2.nbytes + ec2.nbytes + ew2.nbytes + vb.nbytes
                     + ids.nbytes + sum(a.nbytes for a in self._base))
        put = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a)).to(dev)
        ev, ec = put(ev2), put(ec2)
        self._base_ew = put(ew2)
        self._base_dev = [put(a) for a in self._base]
        self._vb = put(vb)
        self._ids = put(ids)
        n_e = len(ev2)
        if self.batch_w:
            ew = torch.empty((B, n_e), dtype=self.tdtype, device=dev)
            ei, ewv = _pack_elem_w(overrides, n_e, self.dtype)
            opstats.bump("uploaded_bytes_delta", ei.nbytes + ewv.nbytes)
            k11.materialize_ew(self._base_ew, ew, put(ei), put(ewv))
            opstats.bump("dispatches")
            opstats.bump("batch_dispatches")
            # every element in the row indexes: an admitted replica may
            # weigh any slot, and the kernels skip the ones it weighs 0
            csr = build_csr(ev, ec, torch.ones(n_e, device=dev), self.n_c,
                            self.n_v)
        else:
            ew = self._base_ew
            csr = build_csr(ev, ec, ew, self.n_c, self.n_v)
        payload = _pack_overrides(overrides, self.n_c, self.n_v)
        opstats.bump("uploaded_bytes_delta", sum(a.nbytes for a in payload))
        cb = torch.empty((B, self.n_c), dtype=self.tdtype, device=dev)
        self._pen, self._rem, self._thresh = (
            torch.empty((B, self.n_v), dtype=self.tdtype, device=dev)
            for _ in range(3))
        k11.materialize(self._base_dev, [put(a) for a in payload],
                        (cb, self._pen, self._rem, self._thresh),
                        self.done_eps, done_mode == "rel")
        opstats.bump("dispatches")
        opstats.bump("batch_dispatches")
        self.sys = LmmSystem(ev, ec, ew, cb, csr, self.n_v)
        self.w = Work(self.n_v, self.n_c, self.tdtype, dev, B=B)
        self._arm_tapes(tapes, tape_slots)
        self._arm_collective(collective)

        self.replicas = [ReplicaState(b) for b in range(B)]
        self._alive = np.ones(B, bool)
        for b in start_dead:
            self._alive[int(b)] = False
            self.replicas[int(b)].alive = False
        self.admitted = 0
        self.pad_events = 0
        self.rescues = 0
        self.supersteps = 0
        #: K16 graphs built (first use, and after a buffer they bake in
        #: was replaced)
        self.loop_builds = 0
        self._loops: dict = {}
        self._packed: Optional[torch.Tensor] = None
        self.syncs = 0
        self.rounds = 0
        opstats.bump("batch_replicas", B)

    # -- fault tapes -------------------------------------------------------

    def _tape_arrays(self, t, what: str, err=ValueError):
        dates = np.asarray(t[0], np.float64)
        slots = np.asarray(t[1], np.int32)
        vals = np.asarray(t[2], np.float64)
        if not (len(dates) == len(slots) == len(vals)):
            raise err(f"{what}tape arrays must have equal length")
        if np.any(np.diff(dates) < 0):
            raise err(f"{what}tape dates must be time-sorted")
        if np.any((slots < 0) | (slots >= self.n_c)):
            raise err(f"{what}tape slot out of range")
        return dates, slots, vals

    def _arm_tapes(self, tapes, tape_slots: int) -> None:
        """Per-replica fault tapes ``[B, T]`` (inf-padded dates never
        fire); ``tape_slots`` reserves rows for admitted tapes, and only
        then is the width bucketed to a power of two."""
        self.has_tape = False
        self._tape_width = 0
        self._tape: Optional[Tuple[torch.Tensor, ...]] = None
        #: per-replica tape cursors (entries fired), host view
        self._tpos = np.zeros(self.B, np.int32)
        if tapes is not None and any(t is not None and len(t[0])
                                     for t in tapes):
            need = max(len(t[0]) for t in tapes if t is not None)
        else:
            need = 0
            tapes = None
        reserving = int(tape_slots) > 0
        need = max(need, int(tape_slots))
        if not need:
            return
        tapes = [None] * self.B if tapes is None else list(tapes)
        if len(tapes) != self.B:
            raise ValueError(f"tapes must have one entry per replica "
                             f"({len(tapes)} != {self.B})")
        T = _pow2_bucket(need) if reserving else need
        self._tape_width = T
        tt = np.full((self.B, T), np.inf, np.float64)
        ts = np.full((self.B, T), self.n_c, np.int32)
        tv = np.zeros((self.B, T), np.float64)
        n_slots = 0
        for b, t in enumerate(tapes):
            if t is None or not len(t[0]):
                continue
            dates, slots, vals = self._tape_arrays(t, f"replica {b}: ")
            n = len(dates)
            tt[b, :n], ts[b, :n], tv[b, :n] = dates, slots, vals
            n_slots += n
        # the solo DrainSim's f64 -> dtype cast of the values
        tvd = tv.astype(self.dtype)
        self.has_tape = True
        self._tape = tuple(torch.from_numpy(a).to(self.device)
                           for a in (tt, ts, tvd))
        opstats.bump("fault_tape_slots", n_slots)
        opstats.bump("uploaded_bytes_delta", tt.nbytes + ts.nbytes
                     + tvd.nbytes)

    # -- the collective schedule ------------------------------------------

    def _arm_collective(self, collective) -> None:
        """One compiled comm DAG for the whole fleet, checked as the JAX
        fleet checks it: the edges and exec costs are shared, each
        replica's predecessor counts, activation dates and Kahan pair
        start from the schedule's birth rows (K11)."""
        self.has_coll = False
        #: (pred [B, V] int32, ready [B, V] f64, clk [B, 2] f64)
        self._coll: Optional[Tuple[torch.Tensor, ...]] = None
        if collective is None:
            return
        cp, cr, ces, ced, cec = collective_arrays(collective, self.n_v)
        if self.dtype != np.float64:
            raise ValueError("collective= needs dtype=float64 "
                             "(see DrainSim)")
        if any(ov.dead_flows for ov in self.overrides):
            raise ValueError("collective fleets cannot kill DAG "
                             "flows via dead_flows overrides")
        self.has_coll = True
        put = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a)).to(self.device)
        #: the schedule's birth rows (pred0, ready0) and the shared
        #: structure (edge_src, edge_dst, exec_cost)
        self._coll_base = (put(cp), put(cr))
        self._coll_edges = tuple(put(a) for a in (ces, ced, cec))
        B, V = self.B, self.n_v
        self._coll = (
            torch.empty((B, V), dtype=torch.int32, device=self.device),
            torch.empty((B, V), dtype=torch.float64, device=self.device),
            torch.empty((B, 2), dtype=torch.float64, device=self.device))
        k11.materialize_coll(self._coll, self._coll_base)
        opstats.bump("collective_tape_slots", V * B)
        opstats.bump("uploaded_bytes_delta", cp.nbytes + cr.nbytes
                     + ces.nbytes + ced.nbytes + cec.nbytes)

    def collective_clock_of(self, b: int) -> Tuple[float, float]:
        """Replica ``b``'s carried Kahan clock pair (t, compensation)."""
        return tuple(float(x) for x in
                     opstats.timed_fetch(self._coll[2][b]))

    # -- the fleet superstep -----------------------------------------------

    def _round(self) -> None:
        lmm_round(self.sys, self.w, self._pen, self.eps, self._vb,
                  self.has_bounds)

    def _loop(self, name: str, refs: tuple, steps, kind: str) -> DeviceLoop:
        """The K16 loop nest ``name`` (``DrainSim._loop``)."""
        def make():
            self.loop_builds += 1
            return DeviceLoop(steps, kind, self.device, refs,
                              prepare=lambda: plan_of(self.sys, self.w))
        return cached(self._loops, name, refs, make)

    def _refs(self) -> tuple:
        return (self.sys, self.w, self._pen, self._rem, self._thresh,
                self._ids, self._vb, self.eps, self.has_bounds, self.n_c,
                self.has_tape, self._tape, self.has_coll, self._coll,
                getattr(self, "_coll_edges", None))

    def _queue_advance(self, packed, k_max: int, ring_n: int) -> None:
        """K2, K3 and with a collective K10: the solo order
        (``lmm_drain.DrainSim._queue_advance``)."""
        ready = self._coll[1] if self.has_coll else None
        drain_advance(self._pen, self._rem, self._thresh, self.w,
                      gated=True,
                      tape_t=self._tape[0] if self.has_tape else None,
                      ready=ready)
        superstep_commit(self.w, self._ids, packed, k_max, ring_n,
                         tape=self._tape[1:] if self.has_tape else None,
                         c_bound=self.sys.c_bound, n_c=self.n_c,
                         ready=ready, pen=self._pen)
        if self.has_coll:
            dag_walk(self.w, *self._coll_edges[:2], self._coll[0], ready,
                     self._coll_edges[2])

    def _superstep_loop(self, packed, k_max: int,
                        ring_n: int) -> DeviceLoop:
        """The fleet superstep as one loop nest (``DrainSim.
        _superstep_loop``), each condition over all B replicas."""
        w = self.w
        slot = (lambda: lmm_init(self.sys, self.w, self._pen, self.eps,
                                 gated=True),
                Loop(PRED_ROUND, w.ctrl, (self._round,),
                     tally="lmm_round_fleet"),
                lambda: self._queue_advance(packed, k_max, ring_n))
        return self._loop("superstep",
                          self._refs() + (packed, k_max, ring_n),
                          [Loop(PRED_SUPERSTEP, w.ctrl, slot,
                                tally="slots")], "superstep_fleet")

    def _packed_buf(self, k_max: int, ring_n: int) -> torch.Tensor:
        """The fleet's ``[B, packed_size]`` result, zeroed; one buffer
        while its size holds."""
        shape = (self.B, packed_size(k_max, ring_n))
        if self._packed is None or tuple(self._packed.shape) != shape:
            self._packed = torch.zeros(shape, dtype=self.tdtype,
                                       device=self.device)
        else:
            self._packed.zero_()
        return self._packed

    def _finish(self, packed) -> np.ndarray:
        superstep_finish(self.sys.e_var, self.sys.e_w, self._pen, packed,
                         self.w,
                         clk=self._coll[2] if self.has_coll else None)
        p = opstats.timed_fetch(packed)
        self.syncs += 1
        return p

    def _reset(self, k: np.ndarray, budget: int, stop: int = 0) -> None:
        """The fleet's loop carry: per-replica k, tape cursor and f64
        base clock (the committed host clock), in two small uploads; a
        collective's Kahan pairs and pending dates are on the card."""
        ints = torch.from_numpy(np.stack([k.astype(np.int32),
                                          self._tpos])).to(self.device)
        t0 = torch.from_numpy(np.array([r.t for r in self.replicas],
                                       np.float64)).to(self.device)
        superstep_reset(self._pen, self.w, ints[0], budget, stop, t0=t0,
                        tpos=ints[1],
                        ready=self._coll[1] if self.has_coll else None,
                        clk=self._coll[2] if self.has_coll else None)

    def _superstep(self, k: Optional[int] = None, alive=None,
                   round_budget: int = 0, rescue: bool = False) -> int:
        """One fleet superstep of up to ``k`` advances per live replica
        (``alive``: an explicit restriction, the tape rescue's), one
        ``[B, ·]`` fetch, and the host demux."""
        k_max = self.superstep_k
        k = k_max if k is None else min(int(k), k_max)
        budget = int(round_budget) or self.superstep_rounds
        alive = (self._alive.copy() if alive is None
                 else np.asarray(alive, bool).copy())
        # completions, one tape entry per advance, one activation per flow
        ring_n = (self.n_v + (k_max if self.has_tape else 0)
                  + (self.n_v if self.has_coll else 0))
        packed = self._packed_buf(k_max, ring_n)
        loop = self._superstep_loop(packed, k_max, ring_n)
        self._reset(np.where(alive, k, 0), budget)
        loop.run()
        p = self._finish(packed)
        self.supersteps += 1
        opstats.bump("dispatches")
        opstats.bump("batch_dispatches")
        return self._collect(p, alive, k_max, ring_n, rescue)

    def _stall_cause(self, b: int, n_live: int) -> Tuple[str, str]:
        """A stall of a NaN-poisoned replica is a ``nan_solve``: one
        extra fetch of its state on this already fatal path."""
        for name, arr in (("remaining work", self._rem),
                          ("penalties", self._pen),
                          ("capacities", self.sys.c_bound)):
            if np.isnan(opstats.timed_fetch(arr[b])).any():
                return ("nan_solve",
                        f"drain solve consumed non-finite lane state "
                        f"(NaN in {name})")
        return ("stall",
                f"drain stalled: no flow holds bandwidth ({n_live} live)")

    def _quarantine(self, b: int, cause: str, detail: str) -> None:
        """Kill replica ``b`` with a recorded cause; every other replica
        runs on unchanged."""
        rep = self.replicas[b]
        rep.error = detail
        rep.fault = LaneFault(cause, detail, b, superstep=self.supersteps,
                              t=rep.t)
        rep.alive = False
        self._alive[b] = False
        opstats.bump("lane_quarantined_" + cause)

    def _collect(self, p: np.ndarray, alive: np.ndarray, k_max: int,
                 ring_n: int, rescue: bool) -> int:
        """Demultiplex one fleet superstep (``_superstep_collect_all``).
        With ``rescue`` (the tape rescue's own collect, run with the
        whole round budget) a replica still stuck is quarantined."""
        dead_ev = int(sum(int(p[b, 2]) for b in range(self.B)
                          if not alive[b]))
        self.pad_events += dead_ev
        if dead_ev:
            raise RuntimeError(
                f"fleet guard: dead replicas logged {dead_ev} completion "
                f"event(s): the frozen-replica invariant is broken")
        o = N_STATS + 2 * k_max
        stuck: List[int] = []
        fired = 0
        coll_fired = 0
        for b in range(self.B):
            if not alive[b]:
                continue
            rep = self.replicas[b]
            row = p[b]
            rounds, adv, n_ev = int(row[0]), int(row[1]), int(row[2])
            t_sum = float(row[3])
            n_live, flag = int(row[4]), int(row[5])
            self.rounds += rounds
            opstats.bump("fixpoint_rounds", rounds)
            if math.isnan(t_sum):
                self._quarantine(b, "nan_solve",
                                 "drain solve produced a non-finite clock "
                                 "advance (NaN)")
                continue
            if n_ev > ring_n:
                self._quarantine(b, "ring_overflow",
                                 f"completion ring overflow: {n_ev} events "
                                 f"for {ring_n} slots")
                continue
            ring_t = row[o:o + n_ev]
            ring_id = row[o + ring_n:o + ring_n + n_ev].astype(np.int64)
            rep.advances += adv
            # a collective replica's ring dates and clock are absolute
            # (its Kahan pair is carried on the card across supersteps)
            t_base = 0.0 if self.has_coll else rep.t
            for j in range(n_ev):
                fid = int(ring_id[j])
                tj = t_base + float(ring_t[j])
                if fid >= 0:
                    rep.events.append((tj, fid))
                    continue
                # a tagged entry: a fault fire (idx < n_c) or an
                # activation of flow idx - n_c
                idx = -fid - 1
                if idx >= self.n_c:
                    rep.collective_events.append((tj, idx - self.n_c))
                    coll_fired += 1
                else:
                    rep.fault_events.append((tj, idx))
                    fired += 1
            rep.t = t_base + t_sum
            coll_pending = self.has_coll and len(rep.events) < self.n_v
            if flag == FLAG_STALLED:
                self._quarantine(b, *self._stall_cause(b, n_live))
            elif n_live == 0 and not coll_pending:
                rep.alive = False
                self._alive[b] = False
            elif n_live == 0 and coll_pending and adv == 0:
                # no live flow, no progress, and the schedule still owes
                # completions (a cyclic or truncated DAG): kill exactly
                # this replica
                self._quarantine(
                    b, "collective_deadlock",
                    f"collective schedule deadlocked: "
                    f"{len(rep.events)}/{self.n_v} flows completed "
                    f"and nothing is pending")
            elif flag == FLAG_BUDGET and adv == 0:
                if rescue:
                    self._quarantine(b, "non_convergence",
                                     "drain solve did not converge")
                else:
                    stuck.append(b)
        for b in range(self.B):
            if alive[b]:
                self._tpos[b] = len(self.replicas[b].fault_events)
        if fired:
            opstats.bump("fault_tape_events", fired)
        if coll_fired:
            opstats.bump("collective_tape_fires", coll_fired)
        if stuck:
            # the round budget ran out inside a replica's first solve:
            # finish one advance for those replicas (a tape or collective
            # fleet on the superstep path, which sees the events; else
            # the fused rescue)
            if self.has_tape or self.has_coll:
                self._rescue_superstep(stuck)
            else:
                self._rescue_fused(stuck)
        return int(self._alive.sum())

    def superstep_all(self, k: Optional[int] = None) -> int:
        """One fleet superstep for every live replica; returns the
        number of replicas still alive."""
        return self._superstep(k)

    def _rescue_superstep(self, stuck: List[int]) -> None:
        """The tape-aware budget rescue: the stuck replicas alone (every
        other replica runs k = 0) for one advance with the whole round
        budget; a replica still stuck is quarantined."""
        self.rescues += 1
        restricted = np.zeros(self.B, bool)
        restricted[stuck] = True
        self._superstep(k=1, alive=restricted, round_budget=MAX_ROUNDS,
                        rescue=True)

    def _rescue_fused(self, stuck: List[int]) -> None:
        """The fused rescue (``_batch_fused_fresh``/``_cont``): K1 in
        chunks and K2 (``gated=2``) for the stuck replicas only, one
        ``[B, 4 + V]`` fetch per chunk, each replica committed once its
        solve converged."""
        self.rescues += 1
        active = np.zeros(self.B, bool)
        active[stuck] = True
        chunk = 16 if self.sys.n_e >= 1 << 20 else 64
        w = self.w
        first = True
        while True:
            # the guard: SS_ACTIVE is set exactly for the active replicas
            # (k 1, the whole budget), the fixpoint carry is untouched
            self._reset(active.astype(np.int32), MAX_ROUNDS)
            self._rescue_loop(first, chunk).run()
            first = False
            opstats.bump("dispatches")
            opstats.bump("batch_dispatches")
            head = torch.stack([w.ctrl[:, IT], w.ctrl[:, LIGHT]], 1)
            st = opstats.timed_fetch(torch.cat(
                [head.to(self.tdtype), w.fctrl[:, DT:DT + 1],
                 w.ctrl[:, LIVE_ACC:LIVE_ACC + 1].to(self.tdtype),
                 w.done.to(self.tdtype)], 1))
            self.syncs += 1
            for b in stuck:
                if not active[b]:
                    continue
                rounds, n_light = int(st[b, 0]), int(st[b, 1])
                if n_light:
                    if rounds >= MAX_ROUNDS:
                        self._quarantine(b, "non_convergence",
                                         "drain solve did not converge")
                        active[b] = False
                        self.rounds += rounds
                        opstats.bump("fixpoint_rounds", rounds)
                    continue
                self.rounds += rounds
                opstats.bump("fixpoint_rounds", rounds)
                rep = self.replicas[b]
                dt, n_live = float(st[b, 2]), int(st[b, 3])
                active[b] = False
                if math.isnan(dt):
                    self._quarantine(b, "nan_solve",
                                     "drain solve produced a non-finite "
                                     "clock advance (NaN)")
                    continue
                if not math.isfinite(dt):
                    self._quarantine(b, *self._stall_cause(b, n_live))
                    continue
                rep.t += dt
                rep.advances += 1
                for fid in np.flatnonzero(st[b, 4:] > 0):
                    rep.events.append((rep.t, int(fid)))
                if n_live == 0:
                    rep.alive = False
                    self._alive[b] = False
            if not active.any():
                break

    def _rescue_loop(self, first: bool, chunk: int) -> DeviceLoop:
        """One chunk of the fused rescue: one slot (the superstep's
        condition sets each replica's guard, and runs the slot once),
        with the gated init (``first``), at most ``chunk`` rounds and K2
        where the slot is active."""
        w = self.w
        slot = [lambda: lmm_init(self.sys, self.w, self._pen, self.eps,
                                 gated=True)] if first else []
        slot += [Loop(PRED_ROUND, w.ctrl, (self._round,), cap=chunk,
                      tally="lmm_round_fleet"),
                 lambda: drain_advance(self._pen, self._rem, self._thresh,
                                       self.w, gated=True)]
        return self._loop("rescue_first" if first else "rescue",
                          self._refs() + (chunk,),
                          [Loop(PRED_SUPERSTEP, w.ctrl, tuple(slot), cap=1)],
                          "rescue_fleet")

    def run(self, max_supersteps: int = 10_000_000, between=None) -> None:
        """Drain every replica to completion (or quarantine).
        ``between(sim)`` runs after every superstep (the admission
        window: :meth:`admit_lane`)."""
        while self._alive.any() and max_supersteps > 0:
            self.superstep_all()
            if between is not None:
                between(self)
            max_supersteps -= 1

    # -- admission ---------------------------------------------------------

    def admit_lane(self, b: int, overrides: ReplicaOverrides,
                   tape=None) -> None:
        """Revive dead row ``b`` with a new scenario between supersteps:
        K11 re-materialises its state row from the compact payload (the
        birth arithmetic, so the admitted replica equals its solo run by
        bits), replaces its tape row and its weight row, and the host
        record starts fresh at t = 0 with the tape cursor at 0.  Raises
        :class:`AdmissionError` when the fleet's birth capacity cannot
        take the scenario."""
        b = int(b)
        if not 0 <= b < self.B:
            raise AdmissionError(f"lane {b} out of range (fleet width "
                                 f"{self.B})")
        if self._alive[b]:
            raise AdmissionError(f"lane {b} is still alive")
        ov = overrides
        if self.has_coll and ov.dead_flows:
            raise AdmissionError("collective fleets cannot kill DAG flows "
                                 "via dead_flows overrides")
        if ov.elem_w and not self.batch_w:
            raise AdmissionError(
                "fleet shares one element-weight table (batch_w False); a "
                "spec with elem_w overrides needs a fleet built with "
                "batch_w=True")
        if tape is not None and not len(tape[0]):
            tape = None
        if tape is not None:
            if not self.has_tape:
                raise AdmissionError(
                    "fleet has no tape capacity (built without tapes or "
                    "tape_slots); a faulted spec cannot be admitted")
            if len(tape[0]) > self._tape_width:
                raise AdmissionError(
                    f"tape with {len(tape[0])} entries exceeds the fleet's "
                    f"reserved tape width {self._tape_width}")
        put = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a)).to(self.device)
        widths = (_pow2_bucket(len(ov.link_scale)),
                  _pow2_bucket(len(ov.flow_scale)),
                  _pow2_bucket(len(ov.dead_flows)))
        payload = _pack_overrides([ov], self.n_c, self.n_v, widths)
        opstats.bump("uploaded_bytes_delta",
                     sum(a.nbytes for a in payload[2:]))
        k11.admit_state(self._base_dev, [put(a) for a in payload],
                        (self.sys.c_bound, self._pen, self._rem,
                         self._thresh), b, self.done_eps,
                        self.done_mode == "rel")
        opstats.bump("dispatches")
        opstats.bump("batch_dispatches")
        if self.has_tape:
            # always rewrite the row: the previous occupant may have
            # left unfired entries behind
            T = self._tape_width
            row_t = np.full(T, np.inf, np.float64)
            row_s = np.full(T, self.n_c, np.int32)
            row_v = np.zeros(T, np.float64)
            if tape is not None:
                dates, slots, vals = self._tape_arrays(tape, "",
                                                       AdmissionError)
                n = len(dates)
                row_t[:n], row_s[:n], row_v[:n] = dates, slots, vals
                opstats.bump("fault_tape_slots", n)
            row_vd = row_v.astype(self.dtype)
            k11.admit_tape(self._tape, b, [put(row_t), put(row_s),
                                           put(row_vd)])
            self._tpos[b] = 0
            opstats.bump("uploaded_bytes_delta",
                         row_t.nbytes + row_s.nbytes + row_vd.nbytes)
            opstats.bump("dispatches")
            opstats.bump("batch_dispatches")
        if self.has_coll:
            # the admitted replica replays the shared schedule from its
            # own t = 0: fresh DAG-walk state, clock pair at zero
            k11.admit_coll(self._coll, b, self._coll_base)
            opstats.bump("collective_tape_slots", self.n_v)
            opstats.bump("dispatches")
            opstats.bump("batch_dispatches")
        if self.batch_w:
            ei, ewv = _pack_elem_w([ov], self.sys.n_e, self.dtype,
                                   _pow2_bucket(len(ov.elem_w)))
            k11.admit_ew(self._base_ew, self.sys.e_w, put(ei), put(ewv), b)
            opstats.bump("uploaded_bytes_delta", ei.nbytes + ewv.nbytes)
            opstats.bump("dispatches")
            opstats.bump("batch_dispatches")
        self.overrides[b] = ov
        self.replicas[b] = ReplicaState(b)
        self._alive[b] = True
        self.admitted += 1
        opstats.bump("lanes_admitted")
        opstats.bump("batch_replicas")

    def retire(self, b: int) -> None:
        """Stop live replica ``b`` between supersteps (a withdrawn
        query): its row goes dark with its committed record kept, and
        :meth:`admit_lane` may reuse it."""
        if not 0 <= int(b) < self.B or not self._alive[b]:
            raise AdmissionError(f"lane {b} is not a live lane")
        self._alive[b] = False
        self.replicas[b].alive = False

    # -- superstep-boundary checkpoint and resume --------------------------

    def committed_state(self) -> Dict:
        """The fleet's committed state between supersteps (the JAX
        ``committed_state`` layout; ``ew`` is ``[B, E]``)."""
        reps = self.replicas
        host = opstats.timed_fetch
        arrays = {
            "cb": host(self.sys.c_bound), "pen": host(self._pen),
            "rem": host(self._rem), "thresh": host(self._thresh),
            "alive": self._alive.copy(), "tpos": self._tpos.copy(),
            "clocks": np.array([r.t for r in reps], np.float64),
            "advances": np.array([r.advances for r in reps], np.int64),
            "ev_counts": np.array([len(r.events) for r in reps], np.int64),
            "ev_t": np.array([t for r in reps for t, _ in r.events],
                             np.float64),
            "ev_id": np.array([i for r in reps for _, i in r.events],
                              np.int64),
            "fev_counts": np.array([len(r.fault_events) for r in reps],
                                   np.int64),
            "fev_t": np.array([t for r in reps for t, _ in r.fault_events],
                              np.float64),
            "fev_slot": np.array([s for r in reps
                                  for _, s in r.fault_events], np.int64),
        }
        if self.has_tape:
            for name, t in zip(("tape_t", "tape_s", "tape_v"), self._tape):
                arrays[name] = host(t)
        if self.has_coll:
            for name, t in zip(("coll_pred", "coll_ready", "coll_clk"),
                               self._coll):
                arrays[name] = host(t)
            arrays["cev_counts"] = np.array(
                [len(r.collective_events) for r in reps], np.int64)
            arrays["cev_t"] = np.array(
                [t for r in reps for t, _ in r.collective_events],
                np.float64)
            arrays["cev_id"] = np.array(
                [i for r in reps for _, i in r.collective_events],
                np.int64)
        if self.batch_w:
            arrays["ew"] = host(self.sys.e_w)
        return {
            "arrays": arrays,
            "errors": [r.error for r in reps],
            "faults": [r.fault.to_dict() if r.fault is not None else None
                       for r in reps],
            "counters": {"admitted": self.admitted,
                         "supersteps": self.supersteps,
                         "syncs": self.syncs, "rounds": self.rounds,
                         "rescues": self.rescues,
                         "pad_events": self.pad_events},
        }

    def restore_state(self, st: Dict) -> None:
        """Adopt a :meth:`committed_state` snapshot (or
        ``convert.fleet_state`` of a JAX fleet's) into this fleet, built
        from the same plan: the device rows, the host replica records,
        the alive mask and the counters.  Raises ``ValueError`` on a
        geometry mismatch."""
        arrays = st["arrays"]
        B = self.B

        def _chk(name, dtype, shape):
            if name not in arrays:
                raise ValueError(f"fleet snapshot is missing array "
                                 f"{name!r}")
            a = np.asarray(arrays[name])
            if tuple(a.shape) != tuple(shape):
                raise ValueError(
                    f"fleet snapshot array {name!r} has shape {a.shape}, "
                    f"this fleet expects {tuple(shape)}: the snapshot is "
                    f"from a different plan")
            return np.ascontiguousarray(a, dtype)

        put = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        rows = {n: _chk(n, self.dtype, (B, m)) for n, m in (
            ("cb", self.n_c), ("pen", self.n_v), ("rem", self.n_v),
            ("thresh", self.n_v))}
        alive = _chk("alive", bool, (B,))
        tpos = _chk("tpos", np.int32, (B,))
        clocks = _chk("clocks", np.float64, (B,))
        advances = _chk("advances", np.int64, (B,))
        ev_counts = _chk("ev_counts", np.int64, (B,))
        fev_counts = _chk("fev_counts", np.int64, (B,))
        n_ev, n_fev = int(ev_counts.sum()), int(fev_counts.sum())
        ev_t = _chk("ev_t", np.float64, (n_ev,))
        ev_id = _chk("ev_id", np.int64, (n_ev,))
        fev_t = _chk("fev_t", np.float64, (n_fev,))
        fev_slot = _chk("fev_slot", np.int64, (n_fev,))
        if "tape_t" in arrays:
            if not self.has_tape:
                raise ValueError("fleet snapshot carries fault tapes but "
                                 "this fleet was built without tape "
                                 "capacity (pass tape_slots at build)")
            T = self._tape_width
            self._tape = (put(_chk("tape_t", np.float64, (B, T))),
                          put(_chk("tape_s", np.int32, (B, T))),
                          put(_chk("tape_v", self.dtype, (B, T))))
        cev_counts = None
        if "coll_pred" in arrays:
            if not self.has_coll:
                raise ValueError("fleet snapshot carries a collective "
                                 "schedule but this fleet was built "
                                 "without collective=")
            coll = (put(_chk("coll_pred", np.int32, (B, self.n_v))),
                    put(_chk("coll_ready", np.float64, (B, self.n_v))),
                    put(_chk("coll_clk", np.float64, (B, 2))))
            cev_counts = _chk("cev_counts", np.int64, (B,))
            n_cev = int(cev_counts.sum())
            cev_t = _chk("cev_t", np.float64, (n_cev,))
            cev_id = _chk("cev_id", np.int64, (n_cev,))
            self._coll = coll
        elif self.has_coll:
            raise ValueError("this fleet carries a collective schedule but "
                             "the snapshot has no collective arrays: it is "
                             "from a different plan")
        if "ew" in arrays:
            if not self.batch_w:
                raise ValueError("fleet snapshot carries per-replica "
                                 "weight tables but this fleet was built "
                                 "with a shared table (pass batch_w=True "
                                 "at build)")
            self.sys = self.sys._replace(e_w=put(_chk(
                "ew", self.dtype, tuple(self.sys.e_w.shape))))
        self.sys = self.sys._replace(c_bound=put(rows["cb"]))
        self._pen, self._rem, self._thresh = (put(rows[n]) for n in (
            "pen", "rem", "thresh"))
        self.w.ptr_cache.clear()
        self._tpos = tpos.copy()
        errors = st.get("errors") or [None] * B
        faults = st.get("faults") or [None] * B
        eo = fo = co = 0
        for b in range(B):
            rep = ReplicaState(b)
            n_e, n_f = int(ev_counts[b]), int(fev_counts[b])
            rep.events = [(float(ev_t[eo + j]), int(ev_id[eo + j]))
                          for j in range(n_e)]
            rep.fault_events = [(float(fev_t[fo + j]),
                                 int(fev_slot[fo + j])) for j in range(n_f)]
            eo += n_e
            fo += n_f
            if cev_counts is not None:
                n_cv = int(cev_counts[b])
                rep.collective_events = [(float(cev_t[co + j]),
                                          int(cev_id[co + j]))
                                         for j in range(n_cv)]
                co += n_cv
            rep.t = float(clocks[b])
            rep.advances = int(advances[b])
            rep.alive = bool(alive[b])
            rep.error = errors[b]
            rep.fault = (LaneFault.from_dict(faults[b]) if faults[b]
                         else None)
            self.replicas[b] = rep
        self._alive = alive.copy()
        c = st.get("counters") or {}
        for name in ("admitted", "supersteps", "syncs", "rounds",
                     "rescues", "pad_events"):
            setattr(self, name, int(c.get(name, 0)))

    # -- results -----------------------------------------------------------

    def events_of(self, b: int) -> List[Tuple[float, int]]:
        return self.replicas[b].events

    def clock_of(self, b: int) -> float:
        return self.replicas[b].t
