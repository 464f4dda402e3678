"""Process-wide counters of the port (the subset of the JAX package's
``ops/opstats.py`` that its solve, warm-solve and drain paths report
into, under the same names).

* ``dispatches``       — solve chunks / advances / supersteps /
  transition batches dispatched (the host maestro: one per solve, per
  forced advance and per transition batch)
* ``fixpoint_rounds``  — saturation rounds executed
* ``fetches`` / ``fetched_bytes`` / ``host_block_ms`` — device->host
  result transfers made through :func:`timed_fetch`
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


def timed_fetch(t: torch.Tensor) -> np.ndarray:
    """Copy one tensor to the host, counting the transfer and the
    milliseconds the host spent blocked in it.  The copy never aliases
    the tensor, also when it already lies on the host."""
    t0 = time.perf_counter()
    out = t.detach().to("cpu", copy=True).numpy()
    bump("host_block_ms", (time.perf_counter() - t0) * 1e3)
    bump("fetches")
    bump("fetched_bytes", out.nbytes)
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
