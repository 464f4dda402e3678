"""Topology flavors for compiled collective schedules.

The port's own copy of ``simgrid_tpu/collectives/topology.py``.

A topology maps a (src, dst) rank pair to the constraint slots the
transfer's LMM variable rides — the route half of the tape record.
Three flavors cover the sweep axes the campaign layer exposes:

* ``nic``  — per-rank full-duplex NICs over a non-blocking fabric:
  route = [tx(src), rx(dst)].  The distributed-ML default (a pod's
  ICI/optical fabric is provisioned so endpoints, not the core, are
  the contended resource).
* ``star`` — per-rank NICs plus ONE shared core constraint:
  route = [tx(src), core, rx(dst)] — an oversubscribed aggregation
  switch, the adversarial case for ring-free algorithms.
* ``ring`` — R physical links; a transfer crosses every link on the
  shorter arc from src to dst (ties go clockwise).  Ring allreduce is
  contention-free here; rdb hop distances grow with the mask.

Every flavor also provisions a per-rank LOOPBACK constraint: the lr
allreduce posts a literal sendrecv-to-self (allreduce-lr.cpp:69-73)
and self-transfers must ride a dedicated resource, mirroring the
reference platform's loopback link, not the fabric.
"""

from __future__ import annotations

from typing import List

import numpy as np

FLAVORS = ("nic", "star", "ring")


class Topology:
    """Constraint layout + route function for one flavor instance."""

    __slots__ = ("flavor", "ranks", "bw", "loop_bw", "core_bw", "n_c",
                 "c_bound")

    def __init__(self, ranks: int, flavor: str = "nic",
                 bw: float = 1e9, loop_bw: float = 0.0,
                 core_bw: float = 0.0):
        if flavor not in FLAVORS:
            raise ValueError(f"unknown topology flavor {flavor!r} "
                             f"(expected one of {FLAVORS})")
        if ranks < 1:
            raise ValueError("topology needs at least one rank")
        self.flavor = flavor
        self.ranks = int(ranks)
        self.bw = float(bw)
        # loopback rides memory, not the fabric: default 4x the NIC
        self.loop_bw = float(loop_bw) if loop_bw else 4.0 * self.bw
        # star core: R/4 NICs' worth of aggregate (oversubscription 4)
        self.core_bw = (float(core_bw) if core_bw
                        else self.bw * max(self.ranks // 4, 1))
        R = self.ranks
        if flavor == "nic":
            self.n_c = 3 * R
            cb = np.full(self.n_c, self.bw)
            cb[2 * R:] = self.loop_bw
        elif flavor == "star":
            self.n_c = 3 * R + 1
            cb = np.full(self.n_c, self.bw)
            cb[2 * R] = self.core_bw
            cb[2 * R + 1:] = self.loop_bw
        else:  # ring
            self.n_c = 2 * R
            cb = np.full(self.n_c, self.bw)
            cb[R:] = self.loop_bw
        self.c_bound = cb

    def route(self, src: int, dst: int) -> List[int]:
        R = self.ranks
        if src == dst:
            if self.flavor == "nic":
                return [2 * R + src]
            if self.flavor == "star":
                return [2 * R + 1 + src]
            return [R + src]
        if self.flavor == "nic":
            return [src, R + dst]
        if self.flavor == "star":
            return [src, 2 * R, R + dst]
        # ring: walk the shorter arc, clockwise on ties; link i spans
        # rank i -> i+1 (mod R)
        cw = (dst - src) % R
        ccw = (src - dst) % R
        if cw <= ccw:
            return [(src + j) % R for j in range(cw)]
        return [(src - 1 - j) % R for j in range(ccw)]

    def key(self) -> tuple:
        return ("topo", self.flavor, self.ranks, self.bw,
                self.loop_bw, self.core_bw)
