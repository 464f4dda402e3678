"""The op-cost probe's inputs, drawn as the TPU tools draw them.

Each function reproduces one tool's draws from
``np.random.default_rng(7)``, in the tool's order, so that at
``scale=1`` the arrays are the tool's own and the port's checks hold
against the tool's numpy ``want``.  ``scale`` shrinks every size (the
CPU tests run at 1/64 and below); at ``scale < 1`` the draws keep their
order but not their values.  Floats are returned as the float64 draws:
``as_dtype(a, torch.float32)`` rounds them as the tools' ``astype``
does, and float64 (the port's solver dtype) keeps them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

SEED = 7
#: the table widths of P5 (tools/tpu_pallas_gather3.py:64)
WIDTHS = (128, 2048, 16384)
#: the element counts of tools/tpu_scaling_probe.py:47
SCALING_N = (65536, 131072, 262144, 524288, 1048576, 2097152)


def size(full: int, scale: float, mult: int) -> int:
    """``full * scale`` rounded down to a multiple of ``mult`` (at least
    ``mult``)."""
    return max(mult, int(full * scale) // mult * mult)


def as_dtype(a: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    return a.astype(torch.empty(0, dtype=dtype).numpy().dtype)


def _probe_draws(scale: float, with_w: bool) -> Dict:
    C, V, DEG = size(16384, scale, 8), size(131072, scale, 32), 4
    rng = np.random.default_rng(SEED)
    out = dict(C=C, V=V, DEG=DEG)
    out["idx"] = rng.integers(0, C, (V, DEG)).astype(np.int32)
    out["tab"] = rng.uniform(1, 2, C)
    if with_w:
        out["w"] = rng.uniform(0.5, 1.5, (V, DEG))
    return out


def pallas_probe(scale: float = 1.0) -> Dict:
    """tools/tpu_pallas_probe.py:38-42: ``idx [V, 4]``, ``tab [C]``,
    ``w [V, 4]``."""
    return _probe_draws(scale, True)


def pallas_gather2(scale: float = 1.0) -> Dict:
    """tools/tpu_pallas_gather2.py:35-37: ``idx [V, 4]``, ``tab [C]``."""
    return _probe_draws(scale, False)


def pallas_gather3(scale: float = 1.0) -> Dict:
    """tools/tpu_pallas_gather3.py:34-36, 88, 104-105: ``tab [C]``,
    ``idx [E]``, the cumsum input ``w_cum [32, C]`` and the one-hot
    segment-sum's weights ``w_seg [E]``; ``widths`` are P5's widths
    capped at C."""
    C, E = size(16384, scale, 128), size(524288, scale, 1024)
    rng = np.random.default_rng(SEED)
    out = dict(C=C, E=E, widths=tuple(sorted({min(w, C) for w in WIDTHS})))
    out["tab"] = rng.uniform(1, 2, C)
    out["idx"] = rng.integers(0, C, E).astype(np.int32)
    out["w_cum"] = rng.uniform(0.5, 1.5, (32, C))
    out["w_seg"] = rng.uniform(0.5, 1.5, E)
    return out


def opcost(scale: float = 1.0) -> Dict:
    """tools/tpu_opcost.py:51-73, the 100k-flow shapes bucketed: sorted
    ``e_cnst [Eb]``, ``e_var [Eb]``, ``e_w [Eb]`` (float64, padding 0),
    ``vc_cnst [Vb, 4]``, ``rou [C]`` and the host-precomputed segment
    ends ``seg_end [C+1]``."""
    C, V, DEG = size(16384, scale, 8), size(100_000, scale, 8), 4
    E = V * DEG
    Eb, Vb = size(524288, scale, 1024), size(131072, scale, 256)
    rng = np.random.default_rng(SEED)
    e_cnst = np.zeros(Eb, np.int32)
    e_cnst[:E] = np.sort(rng.integers(0, C, E).astype(np.int32))
    e_var = np.zeros(Eb, np.int32)
    e_var[:E] = np.repeat(np.arange(V, dtype=np.int32), DEG)
    e_w = np.zeros(Eb, np.float64)
    e_w[:E] = rng.uniform(0.5, 1.5, E)
    vc_cnst = np.zeros((Vb, DEG), np.int32)
    vc_cnst[:V] = rng.integers(0, C, (V, DEG)).astype(np.int32)
    rou = rng.uniform(1.0, 2.0, C)
    seg_end = np.searchsorted(e_cnst[:E], np.arange(1, C + 1), side="left")
    seg_end = np.concatenate([[0], seg_end]).astype(np.int32)
    return dict(C=C, V=V, DEG=DEG, E=E, Eb=Eb, Vb=Vb, e_cnst=e_cnst,
                e_var=e_var, e_w=e_w, vc_cnst=vc_cnst, rou=rou,
                seg_end=seg_end)


def scaling(scale: float = 1.0) -> Dict:
    """tools/tpu_scaling_probe.py:38-56: ``tab [C]``; for each N, ``idx``
    and ``w`` of ``[N/4, 4]``; the op-count probe's ``idx_ops [V, 4]``
    (V = 131,072 at full scale)."""
    C = size(16384, scale, 8)
    rng = np.random.default_rng(SEED)
    out = dict(C=C, tab=rng.uniform(1, 2, C), sizes={})
    for n_full in SCALING_N:
        n = size(n_full, scale, 128)
        idx = rng.integers(0, C, (n // 4, 4)).astype(np.int32)
        w = rng.uniform(0.5, 1.5, (n // 4, 4))
        out["sizes"][n] = (idx, w)
    out["idx_ops"] = rng.integers(0, C, (size(131072, scale, 32), 4)) \
        .astype(np.int32)
    return out
