"""Host-maestro oracle for collective tapes, on the port's kernels.

The port's counterpart of ``simgrid_tpu/collectives/maestro.py``
``HostMaestro``: it runs the SAME compiled comm DAG as the device tape,
but the way the SMPI maestro would.  All schedule bookkeeping (pred
counts, ready dates, fault cursor, the clock) lives on the host, and the
device is asked once per advance for the rate fixpoint and once for the
forced decrement, with every fault and every batch of activations an
extra scatter.  It is the baseline the tape path's one-dispatch-per-K
supersteps are measured against, and the bit-identity reference of the
tape path.

It replays the exact per-advance recurrence of the superstep's event
arms:

* rates from the drain's fixpoint (K1: init, then rounds to
  convergence; the JAX ``_maestro_solve``);
* ``dt_plan = min(rem / rate)`` in f64 on the host (numpy's elementwise
  IEEE division and min match the device reduction);
* the event peek: ``next_t = min(fault date, min(ready))``, fire iff
  ``next_t <= now + dt_plan`` (ties to the event), dt clamped to land
  on the date;
* remains decremented on the device by K2's forced mode (the rounded
  product is not re-derived on the host);
* the fault bound and the activations' penalties scattered by K5;
* the clock accumulated by the same compensated (Kahan) pair, one
  Python-float step per advance.

Event streams come out in the device's order: completions by flow slot,
then the fault entry, then activations by flow slot, all at the
advance's Kahan clock.  ``dispatches`` and ``fetches`` count as the
JAX class counts them: one dispatch per solve, per forced advance and
per transition batch.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..device import DeviceLike
from ..kernels.common import IT, LIGHT, LIVE_ACC, MAX_ROUNDS
from ..kernels.drain_advance import drain_forced_advance
from ..kernels.lmm_round import lmm_init
from ..ops import opstats
from ..ops.lmm_drain import DrainSim
from .tape import DeviceCollective


def _maestro_solve(sim: DrainSim) -> None:
    """One solve to convergence of the drain's current flow state: K1's
    init and rounds, checked once per chunk of at most ``solve_chunk``
    rounds (one K16 launch).  The rates are left in ``sim.w.v_value``."""
    w = sim.w
    loop = sim._chunk_loop()
    lmm_init(sim.sys, w, sim._pen, sim.eps)
    while True:
        loop.run()
        rounds, n_light = (int(x) for x in w.ctrl[IT:LIGHT + 1].tolist())
        if n_light == 0:
            return
        if rounds >= MAX_ROUNDS:
            raise RuntimeError("maestro solve did not converge")


class HostMaestro:
    """Drive a DeviceCollective one advance per dispatch, host-side (on
    the card unless ``device`` says otherwise)."""

    def __init__(self, dc: DeviceCollective, tape=None,
                 device: DeviceLike = None, eps: float = 1e-5,
                 done_eps: float = 1e-4):
        self.dc = dc
        self.n_v = dc.n_v
        self.n_c = dc.n_c
        self.sim = DrainSim(dc.e_var, dc.e_cnst, dc.e_w, dc.c_bound,
                            dc.sizes, dtype=np.float64, device=device,
                            eps=eps, done_eps=done_eps,
                            penalty=dc.penalty0, repack_min=1 << 62)
        self.pred = dc.pred0.astype(np.int64).copy()
        self.ready = dc.ready0.astype(np.float64).copy()
        self.exec_cost = dc.exec_cost
        em = dc.edge_dst < dc.n_v          # drop the pad row
        self.edge_src = dc.edge_src[em]
        self.edge_dst = dc.edge_dst[em]
        if tape is not None and len(tape[0]):
            self.tape_t = np.asarray(tape[0], np.float64)
            self.tape_slot = np.asarray(tape[1], np.int32)
            self.tape_val = np.asarray(tape[2], np.float64)
        else:
            self.tape_t = np.zeros(0)
            self.tape_slot = np.zeros(0, np.int32)
            self.tape_val = np.zeros(0)
        self.tpos = 0
        self.t = 0.0
        self.comp = 0.0                    # Kahan compensation term
        self.events: List[Tuple[float, int]] = []
        self.collective_events: List[Tuple[float, int]] = []
        self.fault_events: List[Tuple[float, int]] = []
        self.advances = 0
        self.dispatches = 0
        self.fetches = 0

    # -- one maestro advance ----------------------------------------------

    def _advance(self) -> None:
        s = self.sim
        _maestro_solve(s)
        self.dispatches += 1
        opstats.bump("dispatches")
        rates = opstats.timed_fetch(s.w.v_value)
        pen = opstats.timed_fetch(s._pen)
        rem = opstats.timed_fetch(s._rem)
        self.fetches += 3

        live = pen > 0
        rate = np.where(live, rates, 0.0)
        flowing = live & (rate > 0)
        q = rem / np.where(flowing, rate, 1.0)
        dt_plan = float(np.min(np.where(flowing, q, np.inf))) \
            if len(q) else float("inf")

        next_ft = (float(self.tape_t[self.tpos])
                   if self.tpos < len(self.tape_t) else float("inf"))
        next_at = float(np.min(self.ready))
        now = self.t
        next_t = min(next_ft, next_at)
        fire = bool(np.isfinite(next_t)) and next_t <= now + dt_plan
        dt = max(next_t - now, 0.0) if fire else dt_plan
        if not np.isfinite(dt):
            raise RuntimeError(
                f"collective schedule deadlocked: "
                f"{len(self.events)}/{self.n_v} flows completed and "
                f"nothing is pending")

        w = s.w
        drain_forced_advance(s._pen, s._rem, s._thresh, w, dt)
        self.dispatches += 1
        opstats.bump("dispatches")
        out = opstats.timed_fetch(torch.cat([
            w.ctrl[LIVE_ACC:LIVE_ACC + 1].to(torch.float64),
            w.done.to(torch.float64)]))
        self.fetches += 1
        done = out[1:] > 0
        self.advances += 1

        # Kahan clock, one Python-float step: the same compensated
        # recurrence the superstep commits on the device
        y = dt - self.comp
        t_new = self.t + y
        self.comp = (t_new - self.t) - y
        self.t = t_new

        for fid in np.flatnonzero(done):
            self.events.append((t_new, int(fid)))

        if fire and next_ft <= next_at:          # fault entry
            slot = int(self.tape_slot[self.tpos])
            val = float(self.tape_val[self.tpos])
            s.apply_transitions({"c_bound": ([slot], [val])})
            self.dispatches += 1
            self.fault_events.append((t_new, slot))
            self.tpos += 1

        acts = np.zeros(0, np.int64)
        if fire and next_at <= next_ft:          # activations
            acts = np.flatnonzero(self.ready <= next_t)
            for fid in acts:
                self.collective_events.append((t_new, int(fid)))
            self.ready[acts] = np.inf

        # DAG walk: completions decrement successors; flows reaching
        # zero get ready = t_new + exec on a LATER advance
        if done.any():
            m = done[self.edge_src]
            pred_before = self.pred.copy()
            np.add.at(self.pred, self.edge_dst[m], -1)
            newly = (self.pred <= 0) & (pred_before > 0)
            self.ready[newly] = t_new + self.exec_cost[newly]
        if len(acts):
            s.apply_transitions(
                {"v_penalty": (acts, np.ones(len(acts)))})
            self.dispatches += 1

    def run(self, max_advances: int = 10_000_000) -> None:
        budget = max_advances
        while len(self.events) < self.n_v and budget > 0:
            self._advance()
            budget -= 1
        if len(self.events) < self.n_v:
            raise RuntimeError("maestro exceeded its advance budget")

    @property
    def clock(self) -> Tuple[float, float]:
        """(t, compensation): compare bitwise against the tape drain's
        carried pair."""
        return (self.t, self.comp)
