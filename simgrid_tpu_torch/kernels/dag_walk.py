"""K10: one advance of a collective schedule's DAG walk.

Replaces the walk of ``simgrid_tpu/ops/lmm_drain.py``
``_superstep_program``'s ``has_coll`` arm (``:457-463``): the advance's
completions (``w.done``) decrement their successors' outstanding
predecessor counts ``pred`` over the edge list ``(edge_src, edge_dst)``
(pad rows with ``edge_dst == n_v`` are dropped), and each flow whose
count crossed to zero gets ``ready = t_new + exec_cost``, ``t_new`` being
the Kahan clock K3 just committed.  Nothing moves unless K3 committed
the advance (``w.ctrl[ADV_OK]``).  The count of flows freed is added to
the superstep's pending-activation word.  The CUDA source is
``csrc/dag_walk.cu``.

The walk reads the edges as an out-edge CSR (:class:`DagCsr`, built by
:func:`dag_csr` once per schedule when it is uploaded): it visits the
out-edges of the flows that completed in this advance, not the whole
edge list.  The decrements are integers and each date is written once,
at its count's crossing to zero, so the result is JAX's whatever order
the completions are visited in; the plain version walks the same CSR.

With a fleet :class:`Work` (``B`` replicas, the vmapped walk of
``lmm_batch.py``'s ``_batch_superstep_program``, ``:479-529``) one
launch walks every replica: ``pred`` and ``ready`` are ``[B, V]`` and
each replica reads its own completions and control words, while the
CSR and exec costs are shared.  The plain version runs the solo plain
walk on each replica in turn; a fleet launch counts as
``dag_walk_fleet``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import build
from .common import (ADV_OK, PENDING, T_SUM, I, P, Work, check, counter,
                     on_cpu, ptr, stream)

COUNT = counter("dag_walk")
FLEET_COUNT = counter("dag_walk_fleet")

_SIG = {"dag_walk": [I, I] + [P] * 9}


class DagCsr(NamedTuple):
    """A schedule's edges grouped by source: flow ``f``'s successors are
    ``out_dst[src_ptr[f]:src_ptr[f + 1]]`` (int32), in edge-list order;
    pad rows are dropped."""
    src_ptr: torch.Tensor   # [n_v + 1] int32
    out_dst: torch.Tensor   # [E] int32


def dag_csr(edge_src: torch.Tensor, edge_dst: torch.Tensor,
            n_v: int) -> DagCsr:
    """The out-edge CSR of the edge list, on the device that holds it."""
    keep = edge_dst < n_v
    src = edge_src[keep].long()
    order = torch.argsort(src, stable=True)
    out_dst = edge_dst[keep][order].to(torch.int32).contiguous()
    src_ptr = torch.zeros(n_v + 1, dtype=torch.int64, device=src.device)
    src_ptr[1:] = torch.cumsum(torch.bincount(src, minlength=n_v), 0)
    return DagCsr(src_ptr.to(torch.int32), out_dst)


def dag_walk_plain(w: Work, csr: DagCsr, pred: torch.Tensor,
                   ready: torch.Tensor, exec_cost: torch.Tensor) -> bool:
    c = w.ctrl
    if not int(c[ADV_OK]):
        return False
    n_v = pred.shape[0]
    # the out-edges of this advance's completions
    done = torch.nonzero(w.done).reshape(-1)
    beg = csr.src_ptr[done].long()
    deg = csr.src_ptr[done + 1].long() - beg
    first = torch.cumsum(deg, 0) - deg
    at = torch.arange(int(deg.sum()), dtype=torch.int64, device=deg.device)
    j = torch.repeat_interleave(beg - first, deg) + at
    dec = torch.bincount(csr.out_dst[j].long(), minlength=n_v)
    before = pred.clone()
    pred.sub_(dec.to(pred.dtype))
    newly = (pred <= 0) & (before > 0)
    t_new = float(w.fctrl[T_SUM])
    ready[newly] = t_new + exec_cost[newly]
    c[PENDING] = int(c[PENDING]) + int(newly.sum())
    return True


def dag_walk(w: Work, edge_src: torch.Tensor, edge_dst: torch.Tensor,
             pred: torch.Tensor, ready: torch.Tensor,
             exec_cost: torch.Tensor, csr: Optional[DagCsr] = None):
    """Walk the advance K3 just committed (int32 ``pred``, edges and
    f64 ``ready``/``exec_cost``, updated in place; a fleet's ``pred``
    and ``ready`` are ``[B, V]``), over ``csr``, the CSR of the edges
    (built from them here when None: a caller that walks a schedule
    again passes the one it built on upload)."""
    n_v = int(pred.shape[-1])
    if csr is None:
        csr = dag_csr(edge_src, edge_dst, n_v)
    if on_cpu(w.ctrl, csr.src_ptr, csr.out_dst, pred, ready, exec_cost):
        if w.B is not None:
            return any([dag_walk_plain(w.replica(b), csr, pred[b], ready[b],
                                       exec_cost) for b in range(w.B)])
        return dag_walk_plain(w, csr, pred, ready, exec_cost)
    if w.fctrl.dtype != torch.float64:
        raise TypeError("dag_walk needs a float64 drain (the clock of a "
                        "collective schedule is f64)")
    shape = tuple(w.done.shape)
    if tuple(pred.shape) != shape or tuple(ready.shape) != shape \
            or pred.dtype != torch.int32 or ready.dtype != torch.float64:
        raise ValueError(f"dag_walk's pred (int32) and ready (float64) "
                         f"must be shaped like the completions {shape}")
    if tuple(csr.src_ptr.shape) != (n_v + 1,) \
            or csr.src_ptr.dtype != torch.int32 \
            or csr.out_dst.dtype != torch.int32:
        raise ValueError(f"dag_walk's CSR must be int32 with {n_v + 1} "
                         f"row pointers")
    lib = build.load("dag_walk", _SIG)
    rc = lib.dag_walk(w.nb, n_v, ptr(w.done), ptr(csr.src_ptr),
                      ptr(csr.out_dst), ptr(pred), ptr(ready),
                      ptr(exec_cost), ptr(w.ctrl), ptr(w.fctrl), stream())
    check(rc, "dag_walk")
    (COUNT if w.B is None else FLEET_COUNT).n += 1
    return None
