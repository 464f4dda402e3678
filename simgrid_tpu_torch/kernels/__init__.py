"""The hand-written CUDA kernels (``csrc/*.cu``), their wrappers and
their plain PyTorch versions.

* K1 :mod:`.lmm_round`        — fixpoint init and one saturation round
  (local or global, with or without bounds and FATPIPE constraints)
* K2 :mod:`.drain_advance`    — dt to the next completion, retirement;
  forced mode: retirement at a given delta; event arm: dt clamped to
  the next fault-tape date or collective activation date
* K3 :mod:`.superstep_commit` — superstep control, Kahan clock, ring;
  tape arm (fault entries, bound scatter, cursor) and collective arm
  (activations)
* K4 :mod:`.livefirst_repack` — stable live-first repack, row indexes
* K5 :mod:`.transition_scatter` — an indexed-run payload into device
  arrays (the drain's transitions, the warm solver's deltas)
* K6 :mod:`.warm_init`        — the restart state of a warm solve (COO
  and ELL arms)
* K7 :mod:`.ell_round`        — the ELL fixpoint's init, its prep once a
  chunk and one round on the constraint-row tables (local with the
  bound-first rule, global)
* K8 :mod:`.vc_round`         — the bound-free local round on the
  variable-row tables
* K9 :mod:`.ell_chain`        — the compaction chain's live count, stage
  partition, row gather and fetch
* K10 :mod:`.dag_walk`        — a collective schedule's DAG walk: the
  completions' successor decrements and the activation dates they free,
  over the schedule's out-edge CSR
* K11 :mod:`.fleet_materialize` — a fleet's per-replica state from the
  base arrays and compact payloads, at birth and at the admission of
  one replica (one launch each)
* K16 :mod:`.superstep_loop`  — the superstep's and the fixpoint's while
  loops on the card: CUDA graphs with conditional WHILE nodes around
  K1-K3, K7, K8 and K10 (one graph launch a superstep, a solve chunk or
  a chain stage)

The op-cost probe's kernels (``simgrid_tpu_torch/probes/``; on no
package path, in place of the Pallas probes P1-P8 under ``tools/``):

* K12 :mod:`.probe_gather`    — ``tab[idx]`` (global and shared-memory
  arms)
* K13 :mod:`.probe_segsum`    — a segment sum or min (global atomics,
  shared-memory atomics, an in-order fold over a CSR)
* K14 :mod:`.probe_scan`      — an inclusive scan along the lanes of each
  row (a sequential fold per row, a block-parallel scan)
* K15 :mod:`.probe_loop`      — K dependent gather rounds (one
  cooperative launch, K launches, a replayed CUDA graph, a conditional
  WHILE node of K16) and P8's ``x * 2``

K1-K3 also take a replica axis (a fleet :class:`~.common.Work`): one
launch serves every replica of a fleet, counted under ``<name>_fleet``.

A wrapper runs the plain version only for CPU tensors; for CUDA tensors
it launches its kernel or raises.  Each wrapper counts its launches
(:func:`launch_counts`); a wrapper called while K16 captures a graph
launches nothing and counts nothing, and its kernel's launches inside
the graph are counted on the card (:func:`path_counts`).
"""

from typing import Dict

from .common import COUNTERS


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel wrapper since the last reset."""
    from . import (dag_walk, drain_advance, ell_chain,  # noqa: F401
                   ell_round, fleet_materialize, livefirst_repack,
                   lmm_round, probe_gather, probe_loop, probe_scan,
                   probe_segsum, superstep_commit, superstep_loop,
                   transition_scatter, vc_round, warm_init)
    return {name: c.n for name, c in COUNTERS.items()}


def path_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset, wherever they were
    launched: by its wrapper from the host, or inside K16's graphs
    (``superstep_loop.graph_launches``: each loop's body launches times
    the iterations its word counted on the card).  One fetch a card."""
    from .superstep_loop import graph_launches
    out = launch_counts()
    for name, n in graph_launches().items():
        out[name] = out.get(name, 0) + n
    return out


def reset_launch_counts() -> None:
    """Zero every launch count and K16's device tally."""
    from .superstep_loop import reset_tally
    for c in COUNTERS.values():
        c.n = 0
    reset_tally()
