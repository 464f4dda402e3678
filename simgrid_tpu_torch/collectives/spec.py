"""CollectiveSpec: one collective workload, content-addressed.

The port's own copy of ``simgrid_tpu/collectives/spec.py`` (the sweep
dimension the reference's campaigns and serving put on a scenario).

A spec names (op, algo, ranks, topology flavor, payload) — everything
needed to regenerate the schedule and compile the tape — in the same
content-addressed style as ScenarioSpec: canonical dict form, stable
sha256 ``key()``, JSON round trip.  ``build()`` materializes the
DeviceCollective (schedule generation + topology lowering); plan
construction caches it, so fleets sweeping rank counts × algorithms ×
topologies pay one compile per distinct spec.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict

from .schedule import GENERATORS, generate
from .tape import DeviceCollective
from .topology import FLAVORS, Topology


class CollectiveSpec:
    """One collective workload: algorithm × rank count × topology."""

    __slots__ = ("op", "algo", "ranks", "topo", "payload", "bw",
                 "loop_bw", "core_bw")

    def __init__(self, op: str = "allreduce", algo: str = "rdb",
                 ranks: int = 8, topo: str = "nic",
                 payload: float = 1 << 20, bw: float = 1e9,
                 loop_bw: float = 0.0, core_bw: float = 0.0):
        if (op, algo) not in GENERATORS:
            raise ValueError(f"unknown collective {op}/{algo}; known: "
                             f"{sorted(GENERATORS)}")
        if topo not in FLAVORS:
            raise ValueError(f"unknown topology flavor {topo!r}")
        if ranks < 2:
            raise ValueError("a collective needs at least 2 ranks")
        self.op = str(op)
        self.algo = str(algo)
        self.ranks = int(ranks)
        self.topo = str(topo)
        #: payload bytes (elements for lr — see schedule.GENERATORS)
        self.payload = float(payload)
        self.bw = float(bw)
        self.loop_bw = float(loop_bw)
        self.core_bw = float(core_bw)

    # -- stable serialization / content addressing -------------------------

    def to_dict(self) -> Dict:
        return {"op": self.op, "algo": self.algo, "ranks": self.ranks,
                "topo": self.topo, "payload": self.payload,
                "bw": self.bw, "loop_bw": self.loop_bw,
                "core_bw": self.core_bw}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_dict(cls, d: Dict) -> "CollectiveSpec":
        return cls(op=d.get("op", "allreduce"),
                   algo=d.get("algo", "rdb"),
                   ranks=d.get("ranks", 8),
                   topo=d.get("topo", "nic"),
                   payload=d.get("payload", 1 << 20),
                   bw=d.get("bw", 1e9),
                   loop_bw=d.get("loop_bw", 0.0),
                   core_bw=d.get("core_bw", 0.0))

    @classmethod
    def from_json(cls, text: str) -> "CollectiveSpec":
        return cls.from_dict(json.loads(text))

    def key(self) -> str:
        """Stable sha256 of the collective identity (same convention
        as ScenarioSpec.key)."""
        return hashlib.sha256(self.to_json().encode("utf-8")).hexdigest()

    def label(self) -> str:
        return (f"{self.op}/{self.algo} r{self.ranks} {self.topo} "
                f"{self.payload:g}B")

    # -- materialization ---------------------------------------------------

    def topology(self) -> Topology:
        return Topology(self.ranks, self.topo, bw=self.bw,
                        loop_bw=self.loop_bw, core_bw=self.core_bw)

    def build(self, exec_cost=None) -> DeviceCollective:
        sched = generate(self.op, self.algo, self.ranks, self.payload)
        return DeviceCollective(sched, self.topology(),
                                exec_cost=exec_cost)
