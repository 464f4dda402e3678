"""The max-min solve of a flattened system, on the port's kernels.

Counterpart of ``simgrid_tpu/ops/lmm_jax.py`` ``solve_arrays``
(``:1316-1506``) and ``check_convergence`` (``:1509``) over the COO
elements, in local rounds (the default, as ``lmm/rounds`` defaults to
``local``) or global rounds (``parallel_rounds=False``), with the
bound-first rule and the FATPIPE usage max switched on exactly where the
JAX solve switches them on.  Rounds run in chunks; after each chunk the
host fetches the round count, the light and fixed counts and the result
vectors in one transfer, and raises the same non-convergence and stall
errors as the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.common import IT, LIGHT, MAX_ROUNDS, LmmSystem, Work
from ..kernels.lmm_round import lmm_init, lmm_round
from . import opstats
from .csr import build_csr
from .lmm_arrays import LmmArrays

#: rounds per chunk: the JAX CPU default on the host; on the card the
#: JAX accelerator default (a chunk queues this many guarded launches)
_CHUNK_ROUNDS = 4096
_CHUNK_ROUNDS_CUDA = 256


def to_device_system(e_var, e_cnst, e_w, c_bound, n_v: int,
                     dtype: torch.dtype, device: torch.device,
                     c_fatpipe=None) -> LmmSystem:
    """Upload COO elements, bounds and (optionally) the FATPIPE flags,
    and build both row indexes."""
    ev = torch.from_numpy(np.array(e_var, np.int32))
    ec = torch.from_numpy(np.array(e_cnst, np.int32))
    ew = torch.from_numpy(np.array(e_w)).to(dtype)
    cb = torch.from_numpy(np.array(c_bound)).to(dtype)
    fat = (None if c_fatpipe is None
           else torch.from_numpy(np.array(c_fatpipe, bool)))
    csr = build_csr(ev, ec, ew, len(cb), n_v)
    put = lambda t: t.to(device)
    opstats.bump("uploaded_bytes_full",
                 sum(t.numel() * t.element_size()
                     for t in (ev, ec, ew, cb, *csr)
                     + ((fat,) if fat is not None else ())))
    return LmmSystem(put(ev), put(ec), put(ew), put(cb),
                     type(csr)(*(put(t) for t in csr)), int(n_v),
                     None if fat is None else put(fat))


def solve_arrays(arrays: LmmArrays, eps: float,
                 device: DeviceLike = None,
                 parallel_rounds: Optional[bool] = None,
                 chunk: Optional[int] = None):
    """Run the fixpoint in bounded-round chunks with host-side
    convergence checks between them; returns numpy
    ``(values, remaining, usage, rounds)``.  ``parallel_rounds`` None or
    True runs local rounds, False global rounds."""
    global_rounds = parallel_rounds is False
    # decided on the host exactly as lmm_jax.py:1399-1401 decides its
    # static flags: a bound counts only on an enabled variable
    has_bounds = bool(np.any((arrays.v_bound[:arrays.n_var] > 0)
                             & (arrays.v_penalty[:arrays.n_var] > 0)))
    has_fatpipe = bool(np.any(arrays.c_fatpipe[:arrays.n_cnst]))
    dev = resolve_device(device)
    dtype = torch.float32 if arrays.e_w.dtype == np.float32 \
        else torch.float64
    if chunk is None:
        chunk = _CHUNK_ROUNDS if dev.type == "cpu" else _CHUNK_ROUNDS_CUDA
    n_v, n_c = len(arrays.v_penalty), len(arrays.c_bound)
    sys = to_device_system(arrays.e_var, arrays.e_cnst, arrays.e_w,
                           arrays.c_bound, n_v, dtype, dev,
                           arrays.c_fatpipe if has_fatpipe else None)
    pen = torch.from_numpy(np.array(arrays.v_penalty)).to(dtype).to(dev)
    vb = (torch.from_numpy(np.array(arrays.v_bound)).to(dtype).to(dev)
          if has_bounds else None)
    w = Work(n_v, n_c, dtype, dev)
    lmm_init(sys, w, pen, eps, has_fatpipe=has_fatpipe)
    prev_progress = None
    while True:
        for _ in range(chunk):
            if lmm_round(sys, w, pen, eps, vb, has_bounds, has_fatpipe,
                         global_rounds) is False:
                break
        opstats.bump("dispatches")
        head = torch.stack([w.ctrl[IT], w.ctrl[LIGHT],
                            w.v_fixed.sum(dtype=torch.int32)]).to(dtype)
        fetched = opstats.timed_fetch(
            torch.cat([head, w.v_value, w.remaining, w.usage]))
        rounds, n_light, n_fixed = (int(fetched[0]), int(fetched[1]),
                                    int(fetched[2]))
        if n_light == 0:
            values = fetched[3:3 + n_v]
            remaining = fetched[3 + n_v:3 + n_v + n_c]
            usage = fetched[3 + n_v + n_c:3 + n_v + 2 * n_c]
            break
        if rounds >= MAX_ROUNDS:
            raise RuntimeError(
                f"LMM torch solve did not converge within {MAX_ROUNDS} "
                f"saturation rounds ({arrays.n_cnst} constraints, "
                f"{arrays.n_var} variables, {n_light} still active); "
                f"check maxmin/precision vs the system's magnitudes")
        progress = (n_light, n_fixed)
        if progress == prev_progress:
            raise RuntimeError(
                f"LMM torch solve stalled after {rounds} rounds: "
                f"{n_light} active constraints and {n_fixed} fixed "
                f"variables unchanged over {chunk} rounds "
                f"({arrays.n_cnst} constraints, {arrays.n_var} variables); "
                f"the system does not converge at eps={eps} in "
                f"{arrays.e_w.dtype} precision")
        prev_progress = progress
    opstats.bump("fixpoint_rounds", rounds)
    return values, remaining, usage, rounds


def check_convergence(rounds: int, n_cnst, n_var) -> None:
    """Raise if a fixpoint hit the round cap."""
    if rounds >= MAX_ROUNDS:
        raise RuntimeError(
            f"LMM torch solve did not converge within {MAX_ROUNDS} "
            f"saturation rounds ({n_cnst} constraints, {n_var} "
            f"variables); check maxmin/precision vs the system's "
            f"magnitudes")
