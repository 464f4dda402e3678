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
"""

from __future__ import annotations

import torch

from . import build
from .common import (ADV_OK, PENDING, T_SUM, I, P, Work, check, counter,
                     on_cpu, ptr, stream)

COUNT = counter("dag_walk")

_SIG = {"dag_walk": [I, I] + [P] * 9}


def dag_walk_plain(w: Work, edge_src: torch.Tensor, edge_dst: torch.Tensor,
                   pred: torch.Tensor, ready: torch.Tensor,
                   exec_cost: torch.Tensor) -> bool:
    c = w.ctrl
    if not int(c[ADV_OK]):
        return False
    n_v = pred.shape[0]
    keep = edge_dst < n_v
    dec = w.done[edge_src[keep].long()].to(pred.dtype)
    before = pred.clone()
    pred.index_add_(0, edge_dst[keep].long(), -dec)
    newly = (pred <= 0) & (before > 0)
    t_new = float(w.fctrl[T_SUM])
    ready[newly] = t_new + exec_cost[newly]
    c[PENDING] = int(c[PENDING]) + int(newly.sum())
    return True


def dag_walk(w: Work, edge_src: torch.Tensor, edge_dst: torch.Tensor,
             pred: torch.Tensor, ready: torch.Tensor,
             exec_cost: torch.Tensor):
    """Walk the advance K3 just committed (int32 ``pred``, edges and
    f64 ``ready``/``exec_cost``, updated in place)."""
    if on_cpu(w.ctrl, edge_src, edge_dst, pred, ready, exec_cost):
        return dag_walk_plain(w, edge_src, edge_dst, pred, ready,
                              exec_cost)
    if w.fctrl.dtype != torch.float64:
        raise TypeError("dag_walk needs a float64 drain (the clock of a "
                        "collective schedule is f64)")
    lib = build.load("dag_walk", _SIG)
    rc = lib.dag_walk(int(edge_src.shape[0]), int(pred.shape[0]),
                      ptr(w.done), ptr(edge_src), ptr(edge_dst), ptr(pred),
                      ptr(ready), ptr(exec_cost), ptr(w.ctrl), ptr(w.fctrl),
                      stream())
    check(rc, "dag_walk")
    COUNT.n += 1
    return None
