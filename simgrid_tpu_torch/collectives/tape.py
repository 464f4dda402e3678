"""Schedule -> device tape compilation.

The port's own copy of ``simgrid_tpu/collectives/tape.py``; ``make_sim``
builds the port's :class:`~simgrid_tpu_torch.ops.lmm_drain.DrainSim`.

``DeviceCollective`` lowers a :class:`~.schedule.CollectiveSchedule`
onto a :class:`~.topology.Topology`: every comm record becomes one
LMM flow slot (variable = record id), its route the element rows, and
the dependency sets become the (pred-count, successor-edge, exec-cost)
arrays the superstep walks on the device: a tape row is (pred, src,
dst, route slots, size, exec cost).

Activation protocol (mirrored exactly by maestro.HostMaestro):

* records with no predecessors and no exec cost start LIVE
  (penalty 1, no activation event);
* records with predecessors start DORMANT (penalty 0, full remains,
  pred count = |preds|, ready = +inf).  When the last predecessor
  completes at clock t, the device schedules ready = t + exec_cost
  and a LATER advance lands on that date, scatters penalty 1.0 and
  logs the tagged ring entry ``id = -(1 + n_c + flow)``;
* root records WITH exec cost start dormant with ready = exec_cost —
  the compute leg of a compute/comm phase runs before the wire.

Zero-byte payloads (a barrier's b"" token) are clamped to one byte:
a zero-size flow can never cross the relative retirement threshold,
and both the tape and the host maestro apply the same clamp, so
bit-identity is unaffected.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .schedule import CollectiveSchedule
from .topology import Topology


class DeviceCollective:
    """The compiled tape: platform arrays + DAG walk arrays."""

    __slots__ = ("schedule", "topology", "n_v", "n_c", "e_var",
                 "e_cnst", "e_w", "c_bound", "sizes", "penalty0",
                 "pred0", "ready0", "edge_src", "edge_dst", "exec_cost")

    def __init__(self, schedule: CollectiveSchedule,
                 topology: Topology,
                 exec_cost: Optional[np.ndarray] = None):
        if topology.ranks != schedule.ranks:
            raise ValueError(
                f"topology is for {topology.ranks} ranks, schedule "
                f"for {schedule.ranks}")
        self.schedule = schedule
        self.topology = topology
        recs = schedule.records
        n_v = len(recs)
        if n_v == 0:
            raise ValueError("schedule has no communications")
        self.n_v = n_v
        self.n_c = topology.n_c
        if exec_cost is None:
            ex = np.zeros(n_v)
        else:
            ex = np.asarray(exec_cost, np.float64)
            if ex.shape != (n_v,):
                raise ValueError(f"exec_cost must have one entry per "
                                 f"record ({n_v}), got {ex.shape}")
        self.exec_cost = ex

        ev, ec = [], []
        for rec in recs:
            for c in topology.route(rec.src, rec.dst):
                ev.append(rec.rid)
                ec.append(c)
        self.e_var = np.asarray(ev, np.int32)
        self.e_cnst = np.asarray(ec, np.int32)
        self.e_w = np.ones(len(ev))
        self.c_bound = np.asarray(topology.c_bound, np.float64)
        self.sizes = np.maximum(
            np.asarray([r.size for r in recs], np.float64), 1.0)

        self.pred0 = np.asarray([len(r.preds) for r in recs], np.int32)
        roots = self.pred0 == 0
        timed_root = roots & (ex > 0)
        self.penalty0 = np.where(roots & ~timed_root, 1.0, 0.0)
        self.ready0 = np.where(timed_root, ex, np.inf)
        es, ed = [], []
        for rec in recs:
            for p in sorted(r.rid for r in rec.preds):
                es.append(p)
                ed.append(rec.rid)
        if not es:
            # keep the edge arrays non-empty: a single dropped-slot
            # row (dst = n_v scatters into the drop lane)
            es, ed = [0], [n_v]
        self.edge_src = np.asarray(es, np.int32)
        self.edge_dst = np.asarray(ed, np.int32)

    @classmethod
    def from_arrays(cls, n_c: int, e_var, e_cnst, e_w, c_bound, sizes,
                    penalty0, pred0, ready0, edge_src, edge_dst, exec_cost,
                    schedule: Optional[CollectiveSchedule] = None,
                    topology: Optional[Topology] = None
                    ) -> "DeviceCollective":
        """A compiled tape from its arrays as they are (another build's,
        e.g. the JAX package's through ``convert.collective_from_jax``)."""
        self = cls.__new__(cls)
        self.schedule = schedule
        self.topology = topology
        self.n_c = int(n_c)
        self.e_var = np.asarray(e_var, np.int32).copy()
        self.e_cnst = np.asarray(e_cnst, np.int32).copy()
        self.e_w = np.asarray(e_w, np.float64).copy()
        self.c_bound = np.asarray(c_bound, np.float64).copy()
        self.sizes = np.asarray(sizes, np.float64).copy()
        self.n_v = len(self.sizes)
        self.penalty0 = np.asarray(penalty0, np.float64).copy()
        self.pred0 = np.asarray(pred0, np.int32).copy()
        self.ready0 = np.asarray(ready0, np.float64).copy()
        self.edge_src = np.asarray(edge_src, np.int32).copy()
        self.edge_dst = np.asarray(edge_dst, np.int32).copy()
        self.exec_cost = np.asarray(exec_cost, np.float64).copy()
        return self

    @property
    def n_edges(self) -> int:
        return int(np.count_nonzero(self.edge_dst < self.n_v))

    def drain_args(self):
        """The ``collective=`` 5-tuple for DrainSim/BatchDrainSim."""
        return (self.pred0, self.ready0, self.edge_src, self.edge_dst,
                self.exec_cost)

    def make_sim(self, superstep: int = 16, pipeline: int = 0,
                 tape=None, device=None, **kw):
        """A ready-to-run tape-driven DrainSim over this collective (on
        the card unless ``device`` says otherwise)."""
        from ..ops.lmm_drain import DrainSim
        return DrainSim(self.e_var, self.e_cnst, self.e_w,
                        self.c_bound, self.sizes, dtype=np.float64,
                        superstep=superstep, pipeline=pipeline,
                        penalty=self.penalty0, tape=tape,
                        device=device, collective=self.drain_args(),
                        **kw)

    def key(self) -> tuple:
        return ("dcoll", self.n_v, self.n_c, self.topology.key(),
                float(self.sizes.sum()), int(self.pred0.sum()))
