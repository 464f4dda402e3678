"""Rows of the op-cost probe: each kernel arm checked against the
tool's numpy ``want`` and timed beside its library call.

A row is one dict: ``probe``, ``name``, ``arm``, ``dtype``, ``ms`` (the
card's time per call), ``paced_ms`` (per call as the host paces it),
``enqueue_us``, ``queued`` (see :mod:`.timing`), ``bound_ms``,
``max_abs_err`` (against the want),
``exact`` (the arm claims bit equality), ``tol`` (the largest absolute
tolerance an inexact arm was held to), ``ok``, ``library`` (what the
library call is), ``library_ms`` and ``library_err``.

Tolerance of an arm whose additions are reordered (the atomic segment
sums, the block-parallel scan), :func:`reorder_tol`: each output is a
sum of ``m`` positive terms, and any order of summation of m positive
terms lies within ``(m - 1) u`` of the exact sum in relative terms (u
the unit roundoff, 2^-24 in float32, 2^-53 in float64), so two orders
differ by at most ``2 m u`` of the value.  That is the bound each output
is held to, with its own ``m``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .timing import time_op

DTYPES = ("float32", "float64")
UNIT_ROUNDOFF = {torch.float32: 2.0 ** -24, torch.float64: 2.0 ** -53}


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[name]


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def max_abs_err(got: np.ndarray, want: np.ndarray) -> float:
    got = np.asarray(got, np.float64).reshape(want.shape)
    want = np.asarray(want, np.float64)
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    if same.all():
        return 0.0
    return float(np.abs(got - want)[~same].max())


def reorder_tol(want: np.ndarray, terms, dtype: torch.dtype) -> np.ndarray:
    """``2 * terms * u * |want|``: how far two orders of a sum of
    ``terms`` positive values can lie apart."""
    return 2.0 * np.asarray(terms, np.float64) * UNIT_ROUNDOFF[dtype] \
        * np.abs(np.asarray(want, np.float64))


def check(got: np.ndarray, want: np.ndarray, tol: Optional[np.ndarray]):
    """(ok, max_abs_err, tol): bit equality when ``tol`` is None, else
    ``|got - want| <= tol`` elementwise."""
    err = max_abs_err(got, want)
    if tol is None:
        same = np.array_equal(np.asarray(got).reshape(want.shape), want,
                              equal_nan=True)
        return bool(same), err, 0.0
    g = np.asarray(got, np.float64).reshape(want.shape)
    w = np.asarray(want, np.float64)
    ok = bool(np.all((np.abs(g - w) <= tol) | (g == w)))
    return ok, err, float(np.max(tol))


class Table:
    """The rows of one run on one device."""

    def __init__(self, device: torch.device):
        self.device = device
        self.rows: List[Dict] = []

    def measure(self, probe: str, name: str, dtype: torch.dtype,
                arms: Dict[str, Callable[[], torch.Tensor]],
                want: np.ndarray, n_bytes: float,
                inexact: Dict[str, np.ndarray] = None,
                library: Optional[Callable[[], torch.Tensor]] = None,
                library_name: Optional[str] = None,
                library_want: Optional[np.ndarray] = None,
                **extra) -> List[Dict]:
        """One row per arm: ``arms[arm]()`` checked against ``want`` (by
        bits, or for an arm in ``inexact`` to that arm's absolute
        tolerances) and timed; the library call timed once beside
        them."""
        inexact = inexact or {}
        lib_ms = lib_err = None
        if library is not None:
            lw = want if library_want is None else library_want
            lib_err = max_abs_err(to_np(library()), lw)
            lib_ms = time_op(library, self.device)["ms"]
        out = []
        for arm, fn in arms.items():
            ok, err, tol = check(to_np(fn()), want, inexact.get(arm))
            t = time_op(fn, self.device, n_bytes)
            row = dict(probe=probe, name=name, arm=arm,
                       dtype=str(dtype).replace("torch.", ""), **t,
                       max_abs_err=err, exact=arm not in inexact,
                       tol=tol, ok=ok, library=library_name,
                       library_ms=lib_ms, library_err=lib_err, **extra)
            out.append(row)
        self.rows += out
        return out
