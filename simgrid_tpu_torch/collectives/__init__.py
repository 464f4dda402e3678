"""Collective schedule tapes of the port: device-resident comm DAGs.

The port's copy of ``simgrid_tpu/collectives``: static communication
schedules of the SMPI collective algorithms (``schedule``), lowered onto
a topology flavor (``topology``) into the ``(pred, ready, edges, exec)``
tape the drain's superstep walks on the card (``tape``,
``DrainSim(collective=...)``), the host-driven bit-identity oracle
(``maestro``), and the content-addressed workload spec (``spec``).
"""

from .maestro import HostMaestro
from .schedule import (CollectiveSchedule, CommRec, GENERATORS, Prog,
                       build_schedule, generate, seq_allreduce_lr,
                       seq_allreduce_rdb, seq_allreduce_redbcast,
                       seq_alltoall_bruck, seq_alltoall_pairwise,
                       seq_bcast_binomial, seq_reduce_flat)
from .spec import CollectiveSpec
from .tape import DeviceCollective
from .topology import FLAVORS, Topology

__all__ = [
    "CollectiveSchedule", "CollectiveSpec", "CommRec",
    "DeviceCollective", "FLAVORS", "GENERATORS", "HostMaestro",
    "Prog", "Topology", "build_schedule", "generate",
    "seq_allreduce_lr", "seq_allreduce_rdb", "seq_allreduce_redbcast",
    "seq_alltoall_bruck", "seq_alltoall_pairwise",
    "seq_bcast_binomial", "seq_reduce_flat",
]
