"""Process-wide counters of the port (the subset of the JAX package's
``ops/opstats.py`` that its solve, warm-solve and drain paths report
into, under the same names).

* ``dispatches``       — solve chunks / advances / supersteps /
  transition batches dispatched (the host maestro: one per solve, per
  forced advance and per transition batch)
* ``fixpoint_rounds``  — saturation rounds executed
* ``fetches`` / ``fetched_bytes`` / ``host_block_ms`` — device->host
  result transfers made through :func:`timed_fetch` and
  :func:`pinned_fetch`, and the host milliseconds spent in them
* ``blocking_fetches`` — the subset of ``fetches`` whose device work
  had not completed when the host asked (a CUDA event's ``query()``
  false): the host stalled on the card instead of overlapping it.  A
  fetch of a tensor on the CPU is always ready
* ``uploaded_bytes_full`` — host->device bytes shipped as whole arrays
* ``uploaded_bytes_delta`` — host->device bytes shipped as indexed
  payloads (drain transitions, warm-solver deltas and modified-constraint
  indexes)
* ``solves`` / ``warm_solves`` / ``cold_solves`` — warm-solver solves,
  by restart kind; ``warm_bound_restarts`` — warm restarts whose whole
  delta was constraint bounds
* ``solver_fallbacks`` — solves on the host CPU path the list solver
  took over (a card solve never falls back)
* ``row_index_builds`` — row-index rebuilds of the warm solver's
  resident system and K8's constraint index over ELL variable rows
  (port only: the JAX package has no row indexes)
* ``warm_ell_fallbacks`` — warm-solver solves in an ELL run that the
  width and fill caps served in COO
* ``ell_solves`` / ``ell_chain_solves`` / ``ell_chain_stages`` /
  ``ell_chain_fallbacks`` — dense ELL solves, compaction-chain solves,
  their stages, and chain solves that overflowed a stage or stalled and
  were re-solved dense (port only: the path a solve took)

* ``fault_tape_slots`` / ``fault_tape_events`` — fault-tape entries
  uploaded with a drain or a fleet, and entries that fired inside its
  supersteps
* ``batch_dispatches`` / ``batch_replicas`` / ``lanes_admitted`` —
  fleet dispatches (also counted in ``dispatches``), replicas built or
  admitted, admissions; ``lane_quarantined_<cause>`` — fleet replicas
  quarantined, by cause
* ``collective_tape_slots`` / ``collective_tape_fires`` — flows of a
  collective schedule uploaded with a drain, and activations fired
* ``speculations_issued`` / ``speculations_committed`` /
  ``speculations_rolled_back`` — speculative supersteps the pipelined
  drains (``pipeline=D``) issued in flight, committed as they were, and
  discarded because collecting the superstep before them changed the
  system; ``fault_replays`` / ``collective_replays`` — discarded
  supersteps behind a tape fire, and behind any unclean collect of a
  collective drain
* ``native_advances`` — engine advances served by the generic host
  sweep (``models/cpu.py``, ``models/network.py``) instead of a device
  drain plan; ``fastpath_advances`` — engine advances fully served by
  the drain plan (``ops/drain_path.py`` serve/apply at the planned dt,
  or a partial advance on the device)
* ``drain_transitions`` / ``drain_transition_slots`` — drain-plan
  transition absorptions (dirty deltas scattered into the live device
  state instead of invalidating the plan) and the slots they touched
* ``drain_cause_<cause>`` — drain-plan invalidation/absorption causes
  (``partial_advance``, ``transition``, ``stall``, ``profile_event``,
  ``unrecognized``): one bump per event, keyed by cause;
  ``phase_<kind>`` — drain-plan builds keyed by the classified phase
  kind (``drain_path.classify_phase``)

Per-kernel launch counts live on the kernel wrappers
(:mod:`simgrid_tpu_torch.kernels`); :func:`launch_counts` reads them.
Counters only ever increase; snapshot before a phase and diff after, or
bracket it with :func:`scoped`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator

import numpy as np
import torch

_counters: Dict[str, float] = {}
#: the counter deltas of each completed :func:`scoped` stage, by name
stage_stats: Dict[str, Dict[str, float]] = {}


def bump(name: str, n=1) -> None:
    _counters[name] = _counters.get(name, 0) + n


def _count_fetch(t0: float, nbytes: int, ready: bool) -> None:
    bump("host_block_ms", (time.perf_counter() - t0) * 1e3)
    bump("fetches")
    bump("fetched_bytes", nbytes)
    if not ready:
        bump("blocking_fetches")


def timed_fetch(t: torch.Tensor) -> np.ndarray:
    """Copy one tensor to the host, counting the transfer, whether the
    card's work before it had completed (an event recorded and queried
    just before the copy) and the milliseconds the host spent blocked in
    it.  The copy never aliases the tensor, also when it already lies on
    the host."""
    ready = True
    if t.is_cuda:
        ev = torch.cuda.Event()
        ev.record()
        ready = ev.query()
    t0 = time.perf_counter()
    out = t.detach().to("cpu", copy=True).numpy()
    _count_fetch(t0, out.nbytes, ready)
    return out


def pinned_fetch(host: torch.Tensor, event) -> np.ndarray:
    """The numpy view of ``host``, a host buffer that an in-stream copy
    fills, once ``event`` (recorded after that copy; None when the copy
    ran on the CPU) has completed: counted as :func:`timed_fetch` counts,
    blocking when the event had not completed when the host asked."""
    ready = event is None or event.query()
    t0 = time.perf_counter()
    if not ready:
        event.synchronize()
    out = host.numpy()
    _count_fetch(t0, out.nbytes, ready)
    return out


def snapshot() -> Dict[str, float]:
    return dict(_counters)


def diff(before: Dict[str, float]) -> Dict[str, float]:
    """Counter deltas since `before` (keys with zero delta omitted)."""
    out = {}
    for k, v in _counters.items():
        d = v - before.get(k, 0)
        if d:
            out[k] = d
    return out


@contextlib.contextmanager
def scoped(name: str) -> Iterator[Dict[str, float]]:
    """Bracket a phase: yields a dict that receives the phase's counter
    deltas on exit (also kept in ``stage_stats[name]``)."""
    before = snapshot()
    stats: Dict[str, float] = {}
    stage_stats[name] = stats
    try:
        yield stats
    finally:
        stats.update(diff(before))


def get_stage(name: str) -> Dict[str, float]:
    """The recorded deltas of a completed ``scoped`` stage ({} when the
    stage never ran)."""
    return dict(stage_stats.get(name, {}))


def reset() -> None:
    """Clear every counter and the recorded stage deltas."""
    _counters.clear()
    stage_stats.clear()


def launch_counts() -> Dict[str, int]:
    """Launches of each hand-written kernel since the last reset."""
    from ..kernels import launch_counts as _lc
    return _lc()
