"""The flow-drain executor on the port's kernels.

Counterpart of ``simgrid_tpu/ops/lmm_drain.py`` ``DrainSim``: drain a
fixed flow set to completion,

    while flows remain:
        solve rates -> next completion time -> advance -> retire flows

keeping all solver and flow state on the device, in three shapes:

* **unfused**: solve chunks (one fetch each; a chunk is one K16 launch
  of at most ``solve_chunk`` rounds), then the dt/retire step (one
  fetch) — >= 2 host waits per advance;
* **fused** (``fused=True``): each solve chunk is followed by the
  dt/retire step, which commits only once the solve converged — one
  fetch per chunk;
* **supersteps** (``superstep=K``): up to K advances per host wait.  The
  JAX program is one ``lax.while_loop`` around a solve that is itself
  one; here both run on the card as K16's graph (``kernels/
  superstep_loop.py``): ``superstep_reset`` (the host's scalars), ONE
  graph launch (a WHILE node over advance slots, each ``lmm_init``, a
  WHILE node over ``lmm_round`` to convergence or the JAX round budget,
  ``drain_advance`` and ``superstep_commit``, under the JAX conditions),
  ``superstep_finish`` and one fetch of the packed result.  The grouping
  of advances into supersteps, and so every event time, is the JAX
  driver's by construction.  Completions land in the ring and the clock
  in a Kahan pair as in the JAX program, and when the live set halves
  the drain repacks on the device (``livefirst_repack``).  The graph is
  kept per executor and built again when a buffer it bakes in is
  replaced (a repack, transitions that rebuild the row index, new
  bounds): ``loop_builds`` counts the builds.

The host clock is ``t = t_base + t_sum`` once per superstep, exactly as
the JAX collect computes it.

Rate bounds (``v_bound``) switch the fixpoint's bound-first arm on in
every shape, decided as the JAX drain decides it: any positive bound,
not masked by penalty.  Beside ``run`` the executor takes the engine
plan's calls: ``apply_transitions`` (a scatter payload into the device
plan, K5), ``partial_advance`` (an advance by a delta the caller gives,
K2's forced mode) and ``solve_rates``.

Two event arms run inside the superstep, as in the JAX program:

* a **fault tape** (``tape=(dates, slots, values)``: f64 absolute sim
  dates, sorted, constraint slots and the absolute bound each entry
  installs): K2 clamps an advance to land on the next date, K3 logs a
  tagged ring entry ``-(1 + slot)``, scatters the bound into the drain's
  constraint bounds and bumps the cursor; the host demuxes those entries
  into ``fault_events``;
* a **collective schedule** (``collective=(pred, ready, edge_src,
  edge_dst, exec_cost)``, a compiled comm DAG): dormant flows (penalty
  0) activate when their predecessors completed and their exec cost
  passed; K2 clamps to the earliest activation date, K3 fires the
  activations (ring ids ``-(1 + n_c + flow)``, into
  ``collective_events``), K10 walks the DAG.  Its Kahan clock pair is
  carried across supersteps and its ring dates are absolute, so every
  event date is independent of the superstep grouping; float64 only,
  and the drain never repacks (the DAG indexes flow slots).

**Pipelined supersteps** (``pipeline=D`` with ``superstep=K``, the JAX
run loop's speculation): a superstep is issued (``superstep_reset``, the
graph launch, ``superstep_finish`` and a non-blocking copy of the packed
result into a pinned host buffer, with an event after it) and collected
later (the wait on that event, then the demux).  Up to D supersteps run
ahead of the one being collected, each on its own set of the buffers a
superstep writes (:class:`Carry`: the flow state, the tape's bounds, the
DAG carry, the result), filled by one in-stream copy of its
predecessor's set; its base clock is derived on the card by the f64 add
the host's collect makes.  A commit adopts the set; a collect that
changed the system (a repack, a decay of the stop trigger, a tape fire,
a stall, no live flow) discards the tail, and the drain goes on from
the committed state, which no speculative superstep ever writes.  So
events, fault and collective events and clock are those of
``pipeline=0`` by bits.  Each set keeps its own graph, so the graphs
built grow by D + 1 per repack and no more.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.common import (DT, FLAG_BUDGET, FLAG_OK, FLAG_STALLED, IT,
                              LIGHT, LIVE_ACC, MAX_ROUNDS, LmmSystem, Work)
from ..kernels.dag_walk import dag_csr, dag_walk
from ..kernels.drain_advance import drain_advance, drain_forced_advance
from ..kernels.livefirst_repack import livefirst_repack
from ..kernels.lmm_round import lmm_init, lmm_round, plan_of
from ..kernels.superstep_commit import (N_STATS, packed_size,
                                        superstep_commit, superstep_finish,
                                        superstep_reset)
from ..kernels.superstep_loop import (PRED_ROUND, PRED_SUPERSTEP,
                                      DeviceLoop, Loop, cached)
from ..kernels.transition_scatter import (TRANSITION_FIELDS,
                                          transition_scatter)
from . import opstats
from .csr import build_csr
from .lmm_arrays import to2d
from .lmm_torch import to_device_system

def _torch_dtype(dtype) -> torch.dtype:
    if np.dtype(dtype) == np.float64:
        return torch.float64
    if np.dtype(dtype) == np.float32:
        return torch.float32
    raise TypeError(f"drain dtype must be float32 or float64, not {dtype}")


def collective_arrays(collective, n_v: int):
    """A collective schedule's ``(pred, ready, edge_src, edge_dst,
    exec_cost)`` as int32/f64 numpy arrays, checked as the JAX drain
    checks them, and its edges held in range for K10."""
    cp, cr, ces, ced, cec = collective
    cp = np.asarray(cp, np.int32)
    cr = np.asarray(cr, np.float64)
    ces = np.asarray(ces, np.int32)
    ced = np.asarray(ced, np.int32)
    cec = np.asarray(cec, np.float64)
    if not (len(cp) == len(cr) == len(cec) == n_v):
        raise ValueError("collective arrays must be per-flow "
                         f"(n_v={n_v})")
    if len(ces) != len(ced):
        raise ValueError("collective edge arrays must have "
                         "equal length")
    # K10 reads done[src] and decrements pred[dst] where it is told
    # (dst == n_v marks a pad row)
    if np.any((ces < 0) | (ces >= n_v)) or np.any((ced < 0) | (ced > n_v)):
        raise ValueError("collective edge out of range (sources in "
                         f"[0, {n_v}), targets in [0, {n_v}])")
    return cp, cr, ces, ced, cec


class Ring:
    """A superstep's result vector on the device, its host twin (pinned
    on a card) and the event recorded after the copy between them."""

    def __init__(self, shape, dtype: torch.dtype, device: torch.device):
        self.dev = torch.zeros(shape, dtype=dtype, device=device)
        card = device.type == "cuda"
        self.host = torch.empty(shape, dtype=dtype, pin_memory=card)
        self.event = torch.cuda.Event() if card else None

    def send(self) -> None:
        """Queue the copy to the host and record its event; the host
        does not wait."""
        self.host.copy_(self.dev, non_blocking=self.event is not None)
        if self.event is not None:
            self.event.record()

    def fetch(self) -> np.ndarray:
        """The host twin once the copy has landed (``opstats.
        pinned_fetch``)."""
        return opstats.pinned_fetch(self.host, self.event)


class Carry:
    """One set of the buffers a solo superstep writes: the flow state,
    the system (with a fault tape its constraint bounds are the set's
    own), with a collective the DAG carry (predecessor counts, activation
    dates, Kahan pair), the f64 base clock of a speculative superstep
    (derived on the card), the result :class:`Ring` and the K16 graphs
    built over them (one per set)."""

    __slots__ = ("pen", "rem", "sys", "pred", "ready", "clk", "t0", "ring",
                 "loops")

    def __init__(self, pen, rem, sys: LmmSystem, pred=None, ready=None,
                 clk=None):
        self.pen, self.rem, self.sys = pen, rem, sys
        self.pred, self.ready, self.clk = pred, ready, clk
        self.t0 = torch.zeros(1, dtype=torch.float64, device=pen.device)
        self.ring: Optional[Ring] = None
        self.loops: dict = {}

    def spare(self, own_bounds: bool) -> "Carry":
        """A set of the same shapes, for speculative supersteps; with
        ``own_bounds`` (a fault tape scatters into them) its own
        constraint bounds."""
        e = lambda t: None if t is None else torch.empty_like(t)  # noqa
        sys = (self.sys._replace(c_bound=e(self.sys.c_bound)) if own_bounds
               else self.sys)
        return type(self)(e(self.pen), e(self.rem), sys, e(self.pred),
                          e(self.ready), e(self.clk))

    def copy_from(self, src: "Carry") -> None:
        """Queue the copy of ``src``'s state into this set."""
        for d, s in ((self.pen, src.pen), (self.rem, src.rem),
                     (self.pred, src.pred), (self.ready, src.ready),
                     (self.clk, src.clk)):
            if d is not None:
                d.copy_(s)
        if self.sys.c_bound is not src.sys.c_bound:
            self.sys.c_bound.copy_(src.sys.c_bound)

    def ring_for(self, shape: Tuple[int, ...], dtype: torch.dtype) -> Ring:
        """The result ring, zeroed; one while its shape holds."""
        r = self.ring
        if r is None or tuple(r.dev.shape) != shape:
            r = self.ring = Ring(shape, dtype, self.pen.device)
        else:
            r.dev.zero_()
        return r


class SuperstepToken:
    """One issued, perhaps still running, superstep (JAX
    ``SuperstepToken``, ``FleetToken``): its set, its k, whether it is
    speculative and its place in issue order; a solo one also the stop
    threshold it ran with and its base clock (the host's float, or the
    set's derived f64 tensor), a fleet's the alive mask it ran under."""

    __slots__ = ("carry", "k", "k_max", "ring_n", "speculative", "seq",
                 "want_stop", "t0", "alive")

    def __init__(self, carry: Carry, k: int, k_max: int, ring_n: int,
                 speculative: bool, seq: int, want_stop: int = 0, t0=None,
                 alive: Optional[np.ndarray] = None):
        self.carry = carry
        self.k, self.k_max, self.ring_n = k, k_max, ring_n
        self.speculative, self.seq = speculative, seq
        self.want_stop, self.t0, self.alive = want_stop, t0, alive


class CarryPool:
    """The buffer sets of one executor's supersteps: the committed one,
    the spares speculative supersteps run on (at depth D at most D + 2
    sets in all), pools dropped while the card may still run supersteps
    on them, the tokens in flight (the pipelined run's) and the count
    of supersteps issued."""

    def __init__(self, make):
        #: the set type (:class:`Carry` or its fleet form)
        self.make = make
        self.sets: list = []
        self.cur = None
        #: (supersteps issued when dropped, sets)
        self.limbo: list = []
        self.inflight: Deque = deque()
        self.seq = 0

    def committed(self, *state) -> Carry:
        """The set around the committed ``(pen, rem, sys, pred, ready,
        clk)``: the one already there while it holds exactly these
        buffers, else a new pool around them (a repack, transitions, new
        bounds or a restore replaced one between supersteps)."""
        c = self.cur
        if c is not None and all(a is b for a, b in zip(
                (c.pen, c.rem, c.sys, c.pred, c.ready, c.clk), state)):
            return c
        if self.sets:
            self.limbo.append((self.seq, self.sets))
        self.cur = self.make(*state)
        self.sets = [self.cur]
        return self.cur

    def spare(self, own_bounds: bool) -> Carry:
        """A set that neither the committed state nor an in-flight
        superstep holds, made when there is none."""
        busy = {id(self.cur)} | {id(t.carry) for t in self.inflight}
        for c in self.sets:
            if id(c) not in busy:
                return c
        c = self.cur.spare(own_bounds)
        self.sets.append(c)
        return c

    def landed(self, seq: int) -> None:
        """Superstep ``seq`` has landed on the host: the card is past
        every pool dropped before it was issued."""
        self.limbo = [x for x in self.limbo if x[0] > seq]

    def discard(self, sim, replays: bool = False) -> None:
        """Drop the uncollected supersteps: their sets go back to the
        pool; only the card's work is lost (and counted in ``sim``).
        With ``replays``, count them as the tail a tape fire or a
        collective makes the drain replay (JAX's ``fault_replays``,
        ``collective_replays``)."""
        n = len(self.inflight)
        if not n:
            return
        if replays and sim.has_tape and sim._last_fired:
            opstats.bump("fault_replays", n)
        if replays and sim.has_coll:
            opstats.bump("collective_replays", n)
        self.inflight.clear()
        sim.spec_rolled_back += n
        opstats.bump("speculations_rolled_back", n)

    def drive(self, sim, more, fits, issue, collect, unclean=None) -> None:
        """The superstep run loop of both executors at any depth (JAX
        ``run``/``_run_pipelined``): while ``more()``, a head superstep
        (``issue(None)``) and, while ``fits()``, up to ``sim.pipeline``
        speculative ones behind it, each chained from the last
        (``issue(prev)``), collected in issue order; a collect that
        returns False (not clean) discards the tail, then ``unclean()``
        runs.  At depth 0 it is the unpipelined loop."""
        inflight = self.inflight
        try:
            while more():
                while not inflight or (len(inflight) <= sim.pipeline
                                       and fits()):
                    inflight.append(issue(inflight[-1] if inflight
                                          else None))
                if not collect(inflight.popleft()):
                    self.discard(sim, replays=True)
                    if unclean is not None:
                        unclean()
        finally:
            self.discard(sim)


class DrainSim:
    """Drain a fixed flow set to completion on the port's kernels.

    Parameters mirror the JAX ``DrainSim``: COO elements (e_var, e_cnst,
    e_w), constraint capacities, per-flow sizes (bytes), ``eps`` of the
    solve, ``done_eps`` with ``done_mode`` "rel" (retire below
    ``done_eps * size``) or "abs", ``solve_chunk`` rounds per solve
    chunk, ``repack_at``/``repack_min`` for the repack trigger,
    ``fused``, ``superstep=K`` and its round budget
    ``superstep_rounds`` (default K*512), optional per-flow rate bounds
    ``v_bound`` (-1 or 0: none), and an optional mid-run
    ``penalty``/``remains``.  ``dtype`` defaults to float32, as the JAX
    ``DrainSim``'s does (so a call that leaves it out runs the same
    program in both packages).  ``tape``
    and ``collective`` arm the superstep's event arms (module
    docstring); both need ``superstep=K``.
    """

    def __init__(self, e_var, e_cnst, e_w, c_bound, sizes,
                 eps: float = 1e-5, done_eps: float = 1e-4,
                 dtype=np.float32, solve_chunk: int = 0,
                 repack_at: float = 0.5, device: DeviceLike = None,
                 v_bound=None, done_mode: str = "rel",
                 fused: bool = False, superstep: int = 0,
                 superstep_rounds: int = 0, repack_min: int = 1024,
                 penalty=None, remains=None, pipeline: int = 0,
                 tape=None, collective=None):
        if done_mode not in ("rel", "abs"):
            raise ValueError(f"Unknown done_mode {done_mode!r} "
                             "(expected rel or abs)")
        self.device = resolve_device(device)
        self.eps = float(eps)
        self.done_eps = float(done_eps)
        self.done_mode = done_mode
        self.dtype = np.dtype(dtype)
        self.tdtype = _torch_dtype(dtype)
        if not solve_chunk:
            solve_chunk = 16 if len(e_var) >= 1 << 20 else 64
        self.solve_chunk = int(solve_chunk)
        self.repack_at = float(repack_at)
        self.repack_min = int(repack_min)
        self.fused = bool(fused)
        self.superstep_k = int(superstep)
        self.superstep_rounds = (int(superstep_rounds)
                                 or self.superstep_k * 512
                                 if self.superstep_k else 0)

        self._host: Optional[dict] = dict(
            e_var=np.asarray(e_var, np.int32),
            e_cnst=np.asarray(e_cnst, np.int32),
            e_w=np.asarray(e_w, self.dtype))
        self.n_c = len(c_bound)
        self.n_v = len(sizes)
        self._c_bound = np.asarray(c_bound, self.dtype)
        self._sizes = np.asarray(sizes, np.float64)
        if self.n_v >= 1 << 24 and self.dtype == np.float32:
            raise ValueError(
                "flow ids beyond 2^24 are not exact in the f32 "
                "single-transfer fetch; use float64")
        self._ids = np.arange(self.n_v)
        self._ids_stale = False
        if done_mode == "rel":
            thresh = self.done_eps * self._sizes
        else:
            thresh = np.full(self.n_v, self.done_eps)
        pen0 = (np.asarray(penalty, self.dtype) if penalty is not None
                else np.ones(self.n_v, self.dtype))
        rem0 = (np.asarray(remains, self.dtype) if remains is not None
                else self._sizes.astype(self.dtype))
        self._pen = self._put(pen0)
        self._rem = self._put(rem0)
        self._thresh = self._put(thresh.astype(self.dtype))
        self._ids_dev = self._put(np.arange(self.n_v, dtype=np.int32))
        # as the JAX drain decides it: any positive bound, not masked by
        # penalty (a latency lane keeps its bound while its penalty is 0)
        if v_bound is not None:
            vb = np.asarray(v_bound, self.dtype)
            self.has_bounds = bool(np.any(vb > 0))
        else:
            vb = np.full(self.n_v, -1.0, self.dtype)
            self.has_bounds = False
        self._vb = self._put(vb)
        self._upload_elements(self._host["e_var"], self._host["e_cnst"],
                              self._host["e_w"])
        self._live0 = (int(np.count_nonzero(pen0 > 0))
                       if penalty is not None else self.n_v)
        self._arm_tape(tape, superstep)
        self._arm_collective(collective, superstep)

        self.t = 0.0
        self.events: List[Tuple[float, int]] = []
        self.advances = 0
        self.rounds = 0
        self.syncs = 0
        self.repacks = 0
        self.supersteps = 0
        #: K16 graphs (loop nests) built: at first use and after a
        #: buffer they bake in was replaced
        self.loop_builds = 0
        self._loops: dict = {}
        #: the result vector of the last superstep issued
        self._packed: Optional[torch.Tensor] = None
        self.pipeline = int(pipeline)
        if self.pipeline and not self.superstep_k:
            raise ValueError("pipeline=D needs superstep=K (speculation "
                             "is a property of the superstep run loop)")
        #: the superstep's buffer sets and the tokens in flight
        self._carries = CarryPool(Carry)
        self._last_fired = False
        #: speculation census of the pipelined run
        self.spec_issued = 0
        self.spec_committed = 0
        self.spec_rolled_back = 0
        #: optional consumer of each collected superstep's batches
        #: ``[(dt, [flow ids])]``, called inside the collect (so at depth
        #: D it overlaps the supersteps in flight): the host's own work
        #: per superstep
        self.on_batches = None

    # -- event arms --------------------------------------------------------

    def _upload_delta(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        opstats.bump("uploaded_bytes_delta", sum(a.nbytes for a in arrays))
        return [torch.from_numpy(np.array(a)).to(self.device)
                for a in arrays]

    def _arm_tape(self, tape, superstep: int) -> None:
        """The fault event tape: ``(dates, slots, values)``, f64 absolute
        dates (sorted), constraint slots, and the absolute bound each
        entry installs (so a recovery restores the exact pre-fault
        bound), checked as the JAX drain checks it."""
        self.has_tape = False
        #: (time, constraint slot) of every fired tape entry
        self.fault_events: List[Tuple[float, int]] = []
        #: tape entries fired so far (the device cursor, host view)
        self._tpos_host = 0
        self._tape: Optional[Tuple[torch.Tensor, ...]] = None
        if tape is None or not len(tape[0]):
            return
        tt = np.asarray(tape[0], np.float64)
        ts = np.asarray(tape[1], np.int32)
        tv = np.asarray(tape[2], np.float64).astype(self.dtype)
        if not (len(tt) == len(ts) == len(tv)):
            raise ValueError("tape arrays must have equal length")
        if np.any(np.diff(tt) < 0):
            raise ValueError("tape dates must be time-sorted")
        if np.any((ts < 0) | (ts >= self.n_c)):
            raise ValueError("tape slot out of range")
        if not superstep:
            raise ValueError("tape= needs superstep=K (faults fire "
                             "inside the superstep loop)")
        self.has_tape = True
        self._tape = tuple(self._upload_delta(tt, ts, tv))
        opstats.bump("fault_tape_slots", len(tt))

    def _arm_collective(self, collective, superstep: int) -> None:
        """The collective schedule tape: ``(pred, ready, edge_src,
        edge_dst, exec_cost)``, the compiled comm DAG
        (``collectives.tape.DeviceCollective.drain_args()``)."""
        self.has_coll = False
        #: (time, flow id) of every activation
        self.collective_events: List[Tuple[float, int]] = []
        self._coll_total = 0
        self._coll: Optional[List[torch.Tensor]] = None
        self._coll_csr = None
        self._coll_clk: Optional[torch.Tensor] = None
        if collective is None:
            return
        cp, cr, ces, ced, cec = collective_arrays(collective, self.n_v)
        if not superstep:
            raise ValueError("collective= needs superstep=K (the "
                             "DAG walks inside the superstep loop)")
        if self.dtype != np.float64:
            raise ValueError("collective= needs dtype=float64 (the "
                             "carried Kahan clock must match the "
                             "host-maestro oracle bit-for-bit)")
        self.has_coll = True
        # a repack would scramble the DAG's static slot indexing
        self.repack_min = 1 << 62
        #: pred counts, ready dates, edge_src, edge_dst, exec costs
        self._coll = self._upload_delta(cp, cr, ces, ced, cec)
        #: the edges as K10 walks them (built once per schedule)
        self._coll_csr = dag_csr(self._coll[2], self._coll[3], self.n_v)
        #: the carried Kahan clock pair (t, compensation), f64
        self._coll_clk = torch.zeros(2, dtype=torch.float64,
                                     device=self.device)
        self._coll_total = int(self.n_v)
        opstats.bump("collective_tape_slots", self.n_v)

    def _coll_open(self) -> bool:
        """True while an armed collective schedule still owes
        completions: a superstep may end with no live flow while dormant
        successors wait on pending activation dates."""
        return self.has_coll and len(self.events) < self._coll_total

    def _deadlock(self) -> RuntimeError:
        return RuntimeError(
            "collective schedule deadlocked: "
            f"{len(self.events)}/{self._coll_total} flows completed and "
            "nothing is pending")

    # -- device state ------------------------------------------------------

    def _put(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.array(a))
        opstats.bump("uploaded_bytes_full", t.numel() * t.element_size())
        return t.to(self.device)

    def _upload_elements(self, e_var, e_cnst, e_w) -> None:
        """Pad the element list to a multiple of 8 (as the JAX drain
        does: the repack's halved shapes depend on it), upload it with
        both row indexes, and size the fixpoint work buffers."""
        flat = [to2d(np.asarray(a)).reshape(-1) for a in (e_var, e_cnst,
                                                          e_w)]
        opstats.bump("uploaded_bytes_full",
                     self._c_bound.nbytes + sum(a.nbytes for a in flat))
        self.sys: LmmSystem = to_device_system(
            flat[0], flat[1], flat[2], self._c_bound, self.n_v,
            self.tdtype, self.device)
        self.w = Work(self.n_v, self.n_c, self.tdtype, self.device)

    def _host_ids(self) -> np.ndarray:
        if self._ids_stale:
            self._ids = opstats.timed_fetch(self._ids_dev).astype(np.int64)
            self.syncs += 1
            self._ids_stale = False
        return self._ids

    def _repack_host(self) -> None:
        """Drop retired flows' rows and elements on the host and upload
        the live system (unfused/fused paths)."""
        pen = opstats.timed_fetch(self._pen)
        rem = opstats.timed_fetch(self._rem)
        thresh = opstats.timed_fetch(self._thresh)
        self.syncs += 1
        live = pen > 0
        keep = np.flatnonzero(live)
        old2new = np.full(self.n_v, -1, np.int32)
        old2new[keep] = np.arange(len(keep), dtype=np.int32)
        emask = live[self._host["e_var"]]
        self._host = dict(
            e_var=old2new[self._host["e_var"][emask]],
            e_cnst=self._host["e_cnst"][emask],
            e_w=self._host["e_w"][emask])
        self._ids = self._host_ids()[keep]
        self._sizes = self._sizes[keep]
        self.n_v = len(keep)
        self._pen = self._put(pen[keep])
        self._rem = self._put(rem[keep])
        self._thresh = self._put(thresh[keep])
        self._ids_dev = self._put(self._ids.astype(np.int32))
        self._vb = self._put(opstats.timed_fetch(self._vb)[keep])
        c_bound = self.sys.c_bound
        self._upload_elements(self._host["e_var"], self._host["e_cnst"],
                              self._host["e_w"])
        # the bounds the device holds now (transitions may have moved
        # them), not the constructor's
        self.sys = self.sys._replace(c_bound=c_bound)
        self._live0 = self.n_v
        self.repacks += 1

    def _repack_device(self, n_live: int, live_elems: int) -> bool:
        """Halve the device arrays with the live-first repack kernel,
        when the live flows and live elements fit the halves."""
        E = self.sys.n_e
        vh = self.n_v // 2
        eh = -(-(E // 2) // 8) * 8
        if n_live > vh or live_elems > eh:
            return False
        rp = livefirst_repack(self.sys, self._pen, self._rem, self._thresh,
                              self._ids_dev, vh, eh, live_elems,
                              self._vb if self.has_bounds else None)
        self.sys = rp.sys
        self._pen, self._rem, self._thresh = rp.pen, rp.rem, rp.thresh
        self._ids_dev = rp.ids
        self._vb = (rp.vb if self.has_bounds else
                    torch.full((vh,), -1.0, dtype=self.tdtype,
                               device=self.device))
        self.n_v = vh
        self.w = Work(vh, self.n_c, self.tdtype, self.device)
        self._live0 = n_live
        self._ids_stale = True
        self._host = None
        self.repacks += 1
        return True

    def _should_repack(self, n_live: int) -> bool:
        return bool(n_live and n_live <= self._live0 * self.repack_at
                    and n_live >= self.repack_min)

    def _live_elems(self) -> int:
        ev = self.sys.e_var.long()
        n = int(((self.sys.e_w > 0) & (self._pen[ev] > 0)).sum())
        self.syncs += 1
        return n

    # -- per-advance paths -------------------------------------------------

    def _loop(self, name: str, refs: tuple, steps, kind: str) -> DeviceLoop:
        """The K16 loop nest ``name``, built again when any of ``refs``
        (what its graph bakes in) was replaced."""
        def make():
            self.loop_builds += 1
            return DeviceLoop(steps, kind, self.device, refs,
                              prepare=lambda: plan_of(self.sys, self.w))
        return cached(self._loops, name, refs, make)

    def _round(self) -> None:
        lmm_round(self.sys, self.w, self._pen, self.eps, self._vb,
                  self.has_bounds)

    def _refs(self) -> tuple:
        return (self.sys, self.w, self._pen, self._rem, self._thresh,
                self._ids_dev, self._vb, self.eps, self.has_bounds,
                self.n_c)

    def _chunk_loop(self, fused: bool = False) -> DeviceLoop:
        """At most ``solve_chunk`` rounds while the fixpoint runs (then,
        ``fused``, the dt/retire step): one K16 launch."""
        steps = [Loop(PRED_ROUND, self.w.ctrl, (self._round,),
                      cap=self.solve_chunk, tally="lmm_round", ends=True)]
        if fused:
            steps.append(lambda: drain_advance(self._pen, self._rem,
                                               self._thresh, self.w))
        return self._loop("fused" if fused else "chunk",
                          self._refs() + (self.solve_chunk,), steps,
                          "chunk")

    def _solve_chunks(self, fused: bool) -> np.ndarray:
        """Solve to convergence in chunks of at most ``solve_chunk``
        rounds (one K16 launch each), one fetch per chunk; with ``fused``
        the dt/retire step follows every chunk in the same launch (it
        commits only after convergence) and rides the same fetch.
        Returns the last fetch: [rounds, n_light] (+ [dt, n_live,
        done...] when fused)."""
        w = self.w
        loop = self._chunk_loop(fused)
        lmm_init(self.sys, w, self._pen, self.eps)
        while True:
            loop.run()
            parts = [w.ctrl[IT:LIGHT + 1].to(self.tdtype)]
            if fused:
                parts += [w.fctrl[DT:DT + 1],
                          w.ctrl[LIVE_ACC:LIVE_ACC + 1].to(self.tdtype),
                          w.done.to(self.tdtype)]
            st = opstats.timed_fetch(torch.cat(parts))
            self.syncs += 1
            rounds, n_light = int(st[0]), int(st[1])
            if n_light == 0:
                break
            if rounds >= MAX_ROUNDS:
                raise RuntimeError("drain solve did not converge")
        self.rounds += rounds
        opstats.bump("dispatches")
        opstats.bump("fixpoint_rounds", rounds)
        return st

    def advance(self) -> int:
        """One solve + time advance; returns the remaining live count."""
        if self.fused:
            return self._advance_fused()
        self._solve_chunks(fused=False)
        w = self.w
        drain_advance(self._pen, self._rem, self._thresh, w)
        out = opstats.timed_fetch(torch.cat([
            w.fctrl[DT:DT + 1], w.ctrl[LIVE_ACC:LIVE_ACC + 1].to(self.tdtype),
            w.done.to(self.tdtype)]))
        self.syncs += 1
        return self._commit_advance(float(out[0]), int(out[1]),
                                    out[2:] > 0)

    def _advance_fused(self) -> int:
        st = self._solve_chunks(fused=True)
        return self._commit_advance(float(st[2]), int(st[3]), st[4:] > 0)

    def _commit_advance(self, dt: float, n_live: int,
                        done: np.ndarray) -> int:
        if not np.isfinite(dt):
            raise RuntimeError(
                f"drain stalled: no flow holds bandwidth ({n_live} live)")
        self.t += dt
        self.advances += 1
        ids = self._host_ids()
        for fid in ids[np.flatnonzero(done)]:
            self.events.append((self.t, int(fid)))
        if self._should_repack(n_live):
            if self._host is not None:
                self._repack_host()
            else:
                self._repack_device(n_live, self._live_elems())
        return n_live

    # -- engine plan calls -------------------------------------------------

    def solve_rates(self) -> np.ndarray:
        """Solve the current flow state to convergence and fetch the rate
        vector (no time advance)."""
        self._solve_chunks(fused=False)
        rates = opstats.timed_fetch(self.w.v_value)
        self.syncs += 1
        return rates

    def partial_advance(self, delta: float):
        """Solve the current flow state to convergence, then advance it
        by a ``delta`` the caller chose (an engine advance won by another
        model or a latency expiry; delta <= this plan's own next dt),
        retiring flows with the same strict-< rule.  Returns
        ``(done_slots, n_live)``; ``t`` and ``events`` are left alone
        (the clock is the caller's on this path)."""
        self._solve_chunks(fused=False)
        w = self.w
        drain_forced_advance(self._pen, self._rem, self._thresh, w, delta)
        out = opstats.timed_fetch(torch.cat([
            w.ctrl[LIVE_ACC:LIVE_ACC + 1].to(self.tdtype),
            w.done.to(self.tdtype)]))
        self.syncs += 1
        self.advances += 1
        return np.flatnonzero(out[1:] > 0), int(out[0])

    def apply_transitions(self, updates: dict) -> int:
        """Absorb a batch of engine transitions into the device plan:
        ``updates`` maps ``TRANSITION_FIELDS`` names to ``(slot_indices,
        values)`` pairs, shipped as ONE float64 payload of exact runs
        and scattered on the device (K5).  A change to the element
        arrays re-derives both row indexes on the device, so every row
        stays in element order.  Returns the number of slots
        scattered."""
        s = self.sys
        targets = [s.e_var, s.e_cnst, s.e_w, s.c_bound, self._pen,
                   self._rem, self._thresh, self._vb]
        layout = []
        chunks = []
        off = 0
        slots = 0
        for ti, field in enumerate(TRANSITION_FIELDS):
            pair = updates.get(field)
            if pair is None or len(pair[0]) == 0:
                continue
            ix = np.asarray(pair[0], np.float64)
            vals = np.asarray(pair[1], np.float64)
            if len(ix) != len(vals):
                raise ValueError(f"{field}: {len(ix)} slots, "
                                 f"{len(vals)} values")
            # the kernel writes where it is told: check every slot here
            n = int(targets[ti].shape[0])
            if np.any((ix < 0) | (ix >= n) | (ix != np.floor(ix))):
                raise ValueError(f"{field}: slot out of range [0, {n})")
            slots += len(ix)
            layout.append((ti, off, len(ix)))
            chunks += [ix, vals]
            off += 2 * len(ix)
        if not layout:
            return 0
        vb_pair = updates.get("v_bound")
        if vb_pair is not None and len(vb_pair[0]) \
                and np.any(np.asarray(vb_pair[1]) > 0):
            self.has_bounds = True
        payload = torch.from_numpy(np.concatenate(chunks)).to(self.device)
        transition_scatter(payload, layout, targets)
        if any(ti < 3 for ti, _, _ in layout):
            self.sys = s._replace(csr=build_csr(s.e_var, s.e_cnst, s.e_w,
                                                s.n_c, s.n_v))
        self._host = None      # host element mirrors are stale now
        opstats.bump("dispatches")
        opstats.bump("uploaded_bytes_delta", payload.numel() * 8)
        return slots

    # -- superstep path ----------------------------------------------------

    def _committed_carry(self) -> Carry:
        coll = self._coll
        return self._carries.committed(
            self._pen, self._rem, self.sys,
            *((coll[0], coll[1], self._coll_clk) if self.has_coll
              else (None, None, None)))

    def _adopt(self, c: Carry) -> None:
        """Make a committed speculative superstep's set the committed
        state."""
        self._pen, self._rem, self.sys = c.pen, c.rem, c.sys
        if self.has_coll:
            self._coll[0], self._coll[1] = c.pred, c.ready
            self._coll_clk = c.clk
        self._carries.cur = c

    def _superstep_loop(self, c: Carry, k_max: int,
                        ring_n: int) -> DeviceLoop:
        """The superstep on set ``c`` as one loop nest: while a slot is
        active, the gated init, the rounds to convergence (or the
        budget), K2, K3 and with a collective K10.  One graph per set,
        kept on it."""
        w = self.w
        packed = c.ring.dev
        slot = (lambda: lmm_init(c.sys, self.w, c.pen, self.eps,
                                 gated=True),
                Loop(PRED_ROUND, w.ctrl, (lambda: lmm_round(
                    c.sys, self.w, c.pen, self.eps, self._vb,
                    self.has_bounds),), tally="lmm_round", ends=True),
                lambda: self._queue_advance(c, packed, k_max, ring_n))
        refs = (c.sys, w, c.pen, c.rem, self._thresh, self._ids_dev,
                self._vb, self.eps, self.has_bounds, self.n_c, packed,
                k_max, ring_n, self.has_tape, self._tape, self.has_coll,
                self._coll, self._coll_csr, c.pred, c.ready, c.clk)

        def make():
            self.loop_builds += 1
            return DeviceLoop([Loop(PRED_SUPERSTEP, w.ctrl, slot,
                                    tally="slots")], "superstep",
                              self.device, refs,
                              prepare=lambda: plan_of(c.sys, self.w))
        return cached(c.loops, "superstep", refs, make)

    def _queue_advance(self, c: Carry, packed, k_max: int,
                       ring_n: int) -> None:
        tape_t = self._tape[0] if self.has_tape else None
        drain_advance(c.pen, c.rem, self._thresh, self.w, gated=True,
                      tape_t=tape_t, ready=c.ready)
        superstep_commit(self.w, self._ids_dev, packed, k_max, ring_n,
                         tape=self._tape[1:] if self.has_tape else None,
                         c_bound=c.sys.c_bound, n_c=self.n_c,
                         ready=c.ready, pen=c.pen)
        if self.has_coll:
            _, _, ces, ced, cec = self._coll
            dag_walk(self.w, ces, ced, c.pred, c.ready, cec,
                     self._coll_csr)

    def _ring_n(self, k_max: int) -> int:
        """Completions, plus one tape entry per advance, plus one
        activation per flow."""
        return (self.n_v + (k_max if self.has_tape else 0)
                + (self.n_v if self.has_coll else 0))

    def _superstep_issue(self, k: Optional[int] = None, stop_live: int = 0,
                         round_budget: int = 0,
                         prev: Optional[SuperstepToken] = None
                         ) -> SuperstepToken:
        """Queue ONE superstep of up to `k` advances and the copy of its
        result to the host, and return at once.  Without ``prev`` it runs
        in place on the committed state; with ``prev`` (an in-flight
        token) it is speculative: one in-stream copy of ``prev``'s
        output set into a spare set, the base clock derived on the card
        as the collect of ``prev`` will derive it on the host, and the
        superstep on that set, so the committed state is never written
        by speculation."""
        if not self.superstep_k and k is None:
            raise ValueError("superstep_batch needs superstep=K "
                             "(constructor) or an explicit k")
        k_max = self.superstep_k or int(k)
        k = k_max if k is None else min(int(k), k_max)
        budget = (int(round_budget) or self.superstep_rounds
                  or k_max * 512)
        want_stop = (stop_live if stop_live
                     else (int(self._live0 * self.repack_at)
                           if self._live0 * self.repack_at
                           >= self.repack_min else 0))
        ring_n = self._ring_n(k_max)
        committed = self._committed_carry()
        if prev is None:
            c, t0 = committed, self.t
        else:
            c = self._carries.spare(self.has_tape)
            c.copy_from(prev.carry)
            # the clock the collect of prev leaves in self.t: the same
            # f64 add (a collective's ring dates are absolute: base 0)
            base = 0.0 if self.has_coll else prev.t0
            torch.add(prev.carry.ring.dev[3:4].to(torch.float64), base,
                      out=c.t0)
            t0 = c.t0
        c.ring_for((packed_size(k_max, ring_n),), self.tdtype)
        loop = self._superstep_loop(c, k_max, ring_n)
        # the tape cursor of the committed state: a superstep that fired
        # an entry makes its collect unclean, so every speculative
        # superstep that commits starts from the cursor it was given
        superstep_reset(c.pen, self.w, k, budget, want_stop, t0=t0,
                        tpos=self._tpos_host, ready=c.ready, clk=c.clk)
        loop.run()
        superstep_finish(c.sys.e_var, c.sys.e_w, c.pen, c.ring.dev, self.w,
                         clk=c.clk)
        c.ring.send()
        self._packed = c.ring.dev
        self.supersteps += 1
        self._carries.seq += 1
        opstats.bump("dispatches")
        if prev is not None:
            self.spec_issued += 1
            opstats.bump("speculations_issued")
        return SuperstepToken(c, k, k_max, ring_n, prev is not None,
                              self._carries.seq, want_stop=want_stop, t0=t0)

    def _superstep_collect(self, tok: SuperstepToken):
        """Wait for one issued superstep's result on the host, commit it
        (a speculative one by adopting its set) and demux its ring.
        Returns ``(n_live, batches, clean)``: ``clean`` says that the
        state is what an in-flight successor assumed (flag OK, live
        flows left, no repack, no decay, no tape fire)."""
        p = tok.carry.ring.fetch()
        self.syncs += 1
        self._carries.landed(tok.seq)
        if tok.speculative:
            self._adopt(tok.carry)
        k_max, ring_n = tok.k_max, tok.ring_n
        rounds, adv = int(p[0]), int(p[1])
        t_sum = float(p[3])
        if math.isnan(t_sum):
            raise RuntimeError(
                "drain solve produced a non-finite clock advance (NaN)")
        n_live, flag = int(p[4]), int(p[5])
        live_elems = int(p[6])
        o = N_STATS
        adv_dt = p[o:o + k_max]
        adv_nev = p[o + k_max:o + 2 * k_max].astype(np.int64)
        o += 2 * k_max
        ring_t = p[o:o + ring_n]
        ring_id = p[o + ring_n:o + 2 * ring_n].astype(np.int64)

        self.rounds += rounds
        opstats.bump("fixpoint_rounds", rounds)
        self.advances += adv
        batches: List[Tuple[float, List[int]]] = []
        start = 0
        # collective rings carry absolute dates (the Kahan pair is
        # carried across supersteps), so the base folds to zero
        t_base = 0.0 if self.has_coll else self.t
        fired = 0
        coll_fired = 0
        for i in range(adv):
            end = int(adv_nev[i])
            batch_ids: List[int] = []
            for j in range(start, end):
                fid = int(ring_id[j])
                tj = t_base + float(ring_t[j])
                if fid >= 0:
                    batch_ids.append(fid)
                    self.events.append((tj, fid))
                    continue
                # a tagged entry: a fault fire (idx < n_c) or an
                # activation of flow idx - n_c
                idx = -fid - 1
                if idx >= self.n_c:
                    self.collective_events.append((tj, idx - self.n_c))
                    coll_fired += 1
                else:
                    self.fault_events.append((tj, idx))
                    fired += 1
            batches.append((float(adv_dt[i]), batch_ids))
            start = end
        self._tpos_host += fired
        self._last_fired = fired > 0
        if fired:
            opstats.bump("fault_tape_events", fired)
        if coll_fired:
            opstats.bump("collective_tape_fires", coll_fired)
        self.t = t_base + t_sum

        if flag == FLAG_STALLED:
            raise RuntimeError(
                f"drain stalled: no flow holds bandwidth ({n_live} live)")
        if flag == FLAG_BUDGET and adv == 0 and rounds >= MAX_ROUNDS:
            raise RuntimeError("drain solve did not converge")
        repacked = decayed = False
        if self._should_repack(n_live):
            repacked = self._repack_device(n_live, live_elems)
        if not repacked and tok.want_stop and n_live <= tok.want_stop:
            # the stop-for-repack threshold fired but no repack was
            # possible: decay the trigger
            self._live0 = max(n_live, 1)
            decayed = True
        if tok.speculative:
            self.spec_committed += 1
            opstats.bump("speculations_committed")
        # a tape fire ends the clean window: the successor chained from
        # the fired bounds, but replaying from the committed state keeps
        # the cursor the host gives it right (_superstep_issue)
        clean = (flag == FLAG_OK and n_live > 0 and not repacked
                 and not decayed and not fired)
        if self.on_batches is not None and batches:
            self.on_batches(batches)
        return n_live, batches, clean

    def superstep_batch(self, k: Optional[int] = None, stop_live: int = 0,
                        round_budget: int = 0, fetch: bool = True):
        """Run ONE superstep of up to `k` advances and collect it.
        Returns (n_live, batches), batches a list of (dt, [original flow
        ids]) per executed advance.  With ``fetch=False`` (a replay of
        advances already served, the engine plan's rollback) the
        superstep only runs on the committed state: nothing is fetched,
        no event, clock or counter is committed, and (None, None) is
        returned."""
        tok = self._superstep_issue(k, stop_live=stop_live,
                                    round_budget=round_budget)
        if not fetch:
            return None, None
        n_live, batches, _ = self._superstep_collect(tok)
        return n_live, batches

    def _rescue_one(self) -> int:
        """Finish ONE advance after the superstep round budget expired
        inside its first solve.  With an event arm the rescue stays on
        the superstep path (the fused advance would step over an event):
        one advance with the whole round budget.  Without, the chunked
        fused path converges across fetches."""
        if self.has_tape or self.has_coll:
            n, _ = self.superstep_batch(k=1, round_budget=MAX_ROUNDS)
            return n
        return self._advance_fused()

    def superstep_step(self, k: Optional[int] = None) -> int:
        """One step of the superstep path at depth 0, for a caller that
        steps the drain itself: one superstep of up to ``k`` advances,
        and one rescued advance if it could not finish any (``run``'s
        rule).  Returns the live count."""
        before = self.advances
        n, _ = self.superstep_batch(k=k)
        if (n or self._coll_open()) and self.advances == before:
            n = self._rescue_one()
            if self.advances == before and self._coll_open():
                # no live flow, no pending activation, but the schedule
                # still owes completions (a cyclic or truncated DAG)
                raise self._deadlock()
        return n

    def _run_supersteps(self, max_advances: int) -> None:
        """The superstep run loop at any depth (JAX ``DrainSim.run`` and
        ``_run_pipelined``, :meth:`CarryPool.drive`): the head superstep
        takes ``min(K, budget)``, a speculative one a full K only while
        it fits the budget whatever the supersteps ahead of it consume;
        an unclean collect that advanced nothing is followed by the
        budget rescue, and a collective that still advances nothing is
        deadlocked."""
        budget, n, stuck = max_advances, self.n_v, False
        inflight = self._carries.inflight

        def issue(prev):
            k = self.superstep_k if prev else min(self.superstep_k, budget)
            return self._superstep_issue(k, prev=prev)

        def collect(tok):
            nonlocal budget, n, stuck
            before = self.advances
            n, _, clean = self._superstep_collect(tok)
            budget -= self.advances - before
            stuck = bool(n or self._coll_open()) and self.advances == before
            return clean

        def rescue():
            # the round budget expired inside the first solve
            nonlocal budget, n
            if not stuck:
                return
            after = self.advances
            n = self._rescue_one()
            budget -= 1
            if self.advances == after and self._coll_open():
                raise self._deadlock()

        self._carries.drive(
            self, lambda: bool(n or self._coll_open()) and budget > 0,
            lambda: (budget - sum(t.k for t in inflight)
                     >= self.superstep_k),
            issue, collect, rescue)

    def run(self, max_advances: int = 10_000_000) -> None:
        if self.superstep_k:
            self._run_supersteps(max_advances)
            return
        n = self.n_v
        while n and max_advances:
            n = self.advance()
            max_advances -= 1
