"""The headline solve of the JAX package's ``bench.py``: "LMM solve ms @
100k concurrent flows" (``bench.py:1411-1421``: 16,384 constraints,
100,000 variables, 4 constraints a variable, seed 42), on the port.

:func:`build_arrays` is ``bench.py``'s generator (``:112-131``) with
power-of-two padding; :func:`run_bench_solve` is the local arm of its
``stage_device`` (``:141-188``): a first solve, then the median of
``reps`` timed solves of the same arrays (the uploads are cached by
identity, as in JAX, so only the first solve uploads).  ``stage_device``
sets ``lmm/pad:tight`` (exact row widths); the port pads to powers of
two, as every simulation path does.

On the card the default ``layout="auto"``/``chain="auto"`` is the JAX
package's accelerator path for this system: ELL, and the compaction
chain (the system is local, bound-free and has 131,072 variable slots).
"""

from __future__ import annotations

import time

import numpy as np

from ..device import DeviceLike, resolve_device
from ..kernels import path_counts, reset_launch_counts
from ..kernels import superstep_loop as k16
from ..ops import opstats
from ..ops.lmm_arrays import LmmArrays, bucket
from ..ops.lmm_torch import solve_arrays

#: bench.py's headline class
HEADLINE = dict(n_c=16384, n_v=100_000, deg=4, seed=42)


def build_arrays(rng, n_c: int, n_v: int, deg: int, dtype) -> LmmArrays:
    """``n_v`` variables of penalty 1, each on ``deg`` constraints drawn
    uniformly (with repeats) from ``n_c`` of bound U(1, 10), weights
    U(0.5, 1.5), no FATPIPE constraint, no rate bound."""
    n_e = n_v * deg
    eb, cb, vb = bucket(n_e), bucket(n_c), bucket(n_v)
    e_var = np.zeros(eb, np.int32)
    e_cnst = np.zeros(eb, np.int32)
    e_w = np.zeros(eb, dtype)
    e_var[:n_e] = np.repeat(np.arange(n_v, dtype=np.int32), deg)
    e_cnst[:n_e] = rng.integers(0, n_c, size=n_e).astype(np.int32)
    e_w[:n_e] = rng.uniform(0.5, 1.5, size=n_e).astype(dtype)
    c_bound = np.zeros(cb, dtype)
    c_bound[:n_c] = rng.uniform(1.0, 10.0, size=n_c).astype(dtype)
    v_penalty = np.zeros(vb, dtype)
    v_penalty[:n_v] = 1.0
    return LmmArrays(e_var, e_cnst, e_w, c_bound, np.zeros(cb, bool),
                     v_penalty, np.full(vb, -1.0, dtype), n_e, n_c, n_v)


def run_bench_solve(n_c: int = 16384, n_v: int = 100_000, deg: int = 4,
                    seed: int = 42, device: DeviceLike = None,
                    reps: int = 3, layout: str = "auto",
                    chain: str = "auto", dtype=np.float64,
                    eps: float = 1e-9, arrays: LmmArrays = None):
    """Solve the class ``1 + reps`` times in local rounds (float64 at
    eps 1e-9, the list-solver oracle precision ``stage_device`` uses
    off the TPU).  Returns ``(result, row)``: the first solve's
    ``(values, remaining, usage, rounds)`` and a row with the rounds,
    the first solve's ms, the median ms of the ``reps`` later ones, the
    launches of each kernel over all solves, the path
    (``chain``/``dense``/``coo``), whether the chain overflowed or
    stalled into the dense path, and the first solve's uploaded bytes.
    ``arrays`` replaces the generated system."""
    dev = resolve_device(device)
    if arrays is None:
        arrays = build_arrays(np.random.default_rng(seed), n_c, n_v, deg,
                              dtype)
    reset_launch_counts()
    before = opstats.snapshot()
    t0 = time.perf_counter()
    first = solve_arrays(arrays, eps, dev, parallel_rounds=True,
                         layout=layout, chain=chain)
    first_ms = (time.perf_counter() - t0) * 1e3
    d = opstats.diff(before)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        solve_arrays(arrays, eps, dev, parallel_rounds=True, layout=layout,
                     chain=chain)
        times.append((time.perf_counter() - t0) * 1e3)
    chained = int(d.get("ell_chain_solves", 0))
    fell_back = int(d.get("ell_chain_fallbacks", 0))
    path = ("chain" if chained and not fell_back
            else "dense" if d.get("ell_solves", 0) else "coo")
    row = dict(n_c=n_c, n_v=n_v, deg=deg, seed=seed, layout=layout,
               chain=chain, rounds=int(first[3]), first_ms=first_ms,
               ms=float(np.median(times)) if times else None,
               reps_ms=times, path=path, chain_fell_back=bool(fell_back),
               uploaded_bytes_first=int(d.get("uploaded_bytes_full", 0)),
               launches=path_counts(), loop=k16.summary())
    return first, row
