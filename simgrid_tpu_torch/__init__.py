"""simgrid_tpu_torch: the max-min flow drain in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

This package stands beside ``simgrid_tpu`` (the JAX reference) and
imports nothing from it.  Its first slice is the BASELINE config-#4
drain: post a flow set on a dragonfly, then solve rates, advance the
clock to the next completion, retire finished flows, and repeat until
none are left.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper runs its plain PyTorch version.

* :func:`simgrid_tpu_torch.ops.lmm_torch.solve_arrays` — one max-min
  solve of a flattened system (local or global rounds; on the card in
  the ELL layout and its compaction chain where the JAX package takes
  them on an accelerator);
* :class:`simgrid_tpu_torch.ops.lmm_drain.DrainSim` — the drain
  executor (unfused, fused and superstep shapes; a fault event tape and
  a collective schedule inside the superstep);
* :class:`simgrid_tpu_torch.faults.FaultCampaign` and
  :func:`simgrid_tpu_torch.workloads.fault_drain.tape_for` — seeded link
  failure campaigns and their device tapes;
* :class:`simgrid_tpu_torch.collectives.CollectiveSpec` (``build()``,
  then ``make_sim``) and :class:`~simgrid_tpu_torch.collectives.
  HostMaestro` — compiled MPI collective schedules and their host oracle;
* :class:`simgrid_tpu_torch.parallel.Campaign` (over
  :class:`~simgrid_tpu_torch.ops.lmm_batch.BatchDrainSim`) and
  :func:`simgrid_tpu_torch.ops.lmm_batch.solve_arrays_batch` — scenario
  fleets: B replicas of one system drained or solved in lockstep, one
  kernel launch serving every replica;
* :func:`simgrid_tpu_torch.workloads.dragonfly.build_system` — the
  config-#4 system generator;
* :class:`simgrid_tpu_torch.s4u.Engine` — the engine's resource half:
  a platform loaded, flows and executions posted through its models,
  ``surf_solve`` advancing the clock, pure-drain and compute/comm phases
  served by the drain fast path (``ops/drain_path.py``) on the card.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
