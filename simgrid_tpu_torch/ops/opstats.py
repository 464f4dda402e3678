"""Process-wide counters of the drain path (the subset of the JAX
package's ``ops/opstats.py`` that the drain reports into).

* ``dispatches``       — solve / advance / superstep dispatches
* ``fixpoint_rounds``  — saturation rounds executed
* ``fetches`` / ``fetched_bytes`` / ``host_block_ms`` — device->host
  result transfers made through :func:`timed_fetch`
* ``uploaded_bytes_full`` — host->device bytes shipped as whole arrays

Per-kernel launch counts live on the kernel wrappers
(:mod:`simgrid_tpu_torch.kernels`); :func:`launch_counts` reads them.
Counters only ever increase; snapshot before a phase and diff after.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

_counters: Dict[str, float] = {}


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


def reset() -> None:
    _counters.clear()


def launch_counts() -> Dict[str, int]:
    """Launches of each hand-written kernel since the last reset."""
    from ..kernels import launch_counts as _lc
    return _lc()
