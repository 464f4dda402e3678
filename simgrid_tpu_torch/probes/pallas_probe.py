"""P1-P3 on the card: the counterpart of ``tools/tpu_pallas_probe.py``.

* P1 (``gk``, ``:59``): the gather ``tab[idx]``, ``tab [C=16384]``,
  ``idx [V=131072, 4]``, on K12's two arms, beside ``torch.take``;
* P2 (``sk``, ``:80``): the segment sum ``zeros(C).at[idx].add(w)`` on
  K13's three arms, beside ``index_add_``; the want is the tool's
  ``np.add.at``;
* P3 (``lk``, ``:105``): 16 dependent gather rounds on K15's four arms
  (the tool checks nothing there; the want is the same loop in numpy).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..kernels.probe_gather import ARMS as GATHER_ARMS
from ..kernels.probe_gather import probe_gather
from ..kernels.probe_loop import ROUNDS, CondLoop, LoopGraph, probe_loop
from ..kernels.probe_segsum import probe_segsum, segment_csr
from . import data
from .common import DTYPES, Table, reorder_tol, torch_dtype


def loop_want(tab: np.ndarray, idx: np.ndarray, rounds: int) -> np.ndarray:
    """P3's loop in numpy, in the table's dtype: [8, 1]."""
    acc = np.zeros(8, tab.dtype)
    tiny = tab.dtype.type(1e-30)
    for _ in range(rounds):
        g = (tab + acc[0] * tiny)[idx]
        acc = acc + g[:8, 0]
    return acc.reshape(8, 1)


def loop_arms(tab: torch.Tensor, idx: torch.Tensor, rounds: int) -> dict:
    """K15's arms as callables (the graph and cond arms built once
    here)."""
    arms = {a: (lambda a=a: probe_loop(tab, idx, rounds, a))
            for a in ("coop", "launch")}
    if tab.is_cuda:
        arms["graph"] = LoopGraph(tab, idx, rounds).replay
        arms["cond"] = CondLoop(tab, idx, rounds).replay
    else:
        for a in ("graph", "cond"):
            arms[a] = lambda a=a: probe_loop(tab, idx, rounds, a)
    return arms


def loop_bytes(tab: torch.Tensor, idx: torch.Tensor, rounds: int) -> int:
    """The loop's bytes: the table and the index read once, the whole g
    written each round (the probe keeps every gather live), acc once."""
    es = tab.element_size()
    return tab.numel() * es + idx.numel() * 4 + rounds * idx.numel() * es \
        + 8 * es


def segsum_terms(c_ptr: torch.Tensor) -> np.ndarray:
    """Terms of each segment's sum (at least 1)."""
    return np.maximum(np.diff(c_ptr.cpu().numpy()), 1)


def run(table: Table, scale: float = 1.0,
        dtypes: Sequence[str] = DTYPES) -> List[dict]:
    dev = table.device
    d = data.pallas_probe(scale)
    C = d["C"]
    idx_np = d["idx"]
    idx = torch.from_numpy(idx_np).to(dev)
    idx_l = idx.long()
    csr = segment_csr(idx, C)
    terms = segsum_terms(csr[0])
    out = []
    for name in dtypes:
        dt = torch_dtype(name)
        tab_np, w_np = data.as_dtype(d["tab"], dt), data.as_dtype(d["w"], dt)
        tab = torch.from_numpy(tab_np).to(dev)
        w = torch.from_numpy(w_np).to(dev)
        es = tab.element_size()
        out += table.measure(
            "pallas_probe", "P1_gather", dt,
            {a: (lambda a=a: probe_gather(tab, idx, a)) for a in GATHER_ARMS},
            tab_np[idx_np], tab.numel() * es + idx.numel() * (4 + es),
            library=lambda: torch.take(tab, idx_l), library_name="torch.take")
        want = np.zeros(C, tab_np.dtype)
        np.add.at(want, idx_np.ravel(), w_np.ravel())
        wf = w.reshape(-1)
        out += table.measure(
            "pallas_probe", "P2_segsum", dt,
            {a: (lambda a=a: probe_segsum(idx, w, C, a, csr=csr))
             for a in ("atomic", "smem_atomic", "inorder")},
            want, idx.numel() * (4 + es) + C * es,
            inexact={a: reorder_tol(want, terms, dt)
                     for a in ("atomic", "smem_atomic")},
            library=lambda: torch.zeros(C, dtype=dt, device=dev).index_add_(
                0, idx_l.reshape(-1), wf),
            library_name="index_add_")
        out += table.measure(
            "pallas_probe", "P3_loop16", dt, loop_arms(tab, idx, ROUNDS),
            loop_want(tab_np, idx_np, ROUNDS), loop_bytes(tab, idx, ROUNDS))
    return out
