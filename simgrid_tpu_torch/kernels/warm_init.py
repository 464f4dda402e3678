"""K6: the restart state of a warm-started selective solve.

Replaces ``simgrid_tpu/ops/lmm_warm.py`` ``_warm_init`` (``:201-242``).
The CUDA source is ``csrc/warm_init.cu``.

From the resident masters (the system and penalties), the previous
converged solve held in the fixpoint :class:`~.common.Work` (its
``v_value``, ``remaining`` and ``usage``) and the padded indexes of the
modified constraints ``mc_idx``, it writes the state from which K1's
rounds re-solve only the modified component, in place into the same
``Work``: modified constraints get the cold init (``remaining = bound``,
the in-order ``usage0``, the light test), their variables are unfixed
with the cold initial value; every other slot keeps the previous
solution, fixed and dark.  ``ctrl`` is armed as K1's init arms it
(``IT=0``, ``LIGHT``, ``ARMED=1``, ``LIMIT``), so K1's rounds run from
it unchanged.

Its ELL arm, :func:`warm_init_ell`, replaces ``_warm_init_ell``
(``lmm_warm.py:157-198``): the same state from the ELL masters, its
``usage0`` folded over the constraint rows in XLA:CPU's row order (as
K7's init folds it), and the carry's extra leg ``cv_live``: modified
rows re-derived from the new fixed flags, untouched rows keeping the
previous converged mask.  It is counted as ``warm_init_ell``.

On CPU tensors the wrappers run the plain PyTorch version (a
line-by-line transcription of the JAX program, which takes ``mc_idx``
in any order) and return True; on CUDA tensors they launch the kernel,
one launch a call in either arm, and return None.  ``mc_idx`` is given
on the host (an int32 numpy array or CPU tensor).  The kernel decides
"modified" by binary search, so on the card ``mc_idx`` must be sorted
(non-decreasing, padded by repeating its last entry, as
``ops/lmm_warm.py`` ``modified_index`` builds it): the card route checks
its order on the host (:func:`host_index`) and raises ``ValueError``
before any launch, then its C entry uploads it from a pinned buffer in
the launch's stream (the kernel's trap on a descending pair stays as a
backstop).  Its ELL arm reads "has a live element" and v_mod
from the variable-row tables ``vc_*`` and writes a modified row's
``cv_live`` as its enabled mask; both rest on invariants of the ELL
masters (the ``cv_*`` and ``vc_*`` tables hold the same live elements
with the same weights, and a valid entry has a positive weight) that
the build and K5's ELL deltas keep.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import numpy as np
import torch

from . import build
from .common import (ARMED, IT, LIGHT, LIGHT_ACC, LIMIT, MAX_ROUNDS, D, I,
                     EllSystem, EllWork, LmmSystem, P, Staging, Work, check,
                     counter, is_double, on_cpu, ptr_array, stream)
from .ell_round import arm_ctrl, fold_rows, row_max0
from .lmm_round import _any_by, _max_by

COUNT = counter("warm_init")
ELL_COUNT = counter("warm_init_ell")

#: buffers handed to the C entry as one pointer array, in this order
N_PTRS = 18

_SIG = {"warm_init": [I, I, I, I, P, I, D, I, P, P],
        "warm_init_ell": [I, I, I, I, I, I, P, I, D, I, P, P]}

#: buffers of the ELL arm's C entry, in this order
N_PTRS_ELL = 20

#: the modified constraints as the wrappers take them
Index = Union[np.ndarray, torch.Tensor]

_STAGE = Staging("K6's index")


def host_index(mc_idx: Index) -> np.ndarray:
    """The card route's ``mc_idx`` as the kernel searches it: int32 on
    the host, one entry or more, non-decreasing.  Raises ``ValueError``
    on a descending pair and ``TypeError`` on a device tensor (its
    order could not be checked without a sync)."""
    if isinstance(mc_idx, torch.Tensor):
        if mc_idx.device.type != "cpu":
            raise TypeError("on the card K6 takes mc_idx on the host, "
                            "where its order is checked before the upload")
        mc_idx = mc_idx.numpy()
    mc = np.ascontiguousarray(mc_idx)
    if mc.dtype != np.int32 or mc.ndim != 1 or not len(mc):
        raise TypeError("mc_idx is a non-empty int32 vector")
    if (mc[1:] < mc[:-1]).any():
        raise ValueError("K6's card route takes mc_idx sorted "
                         "(non-decreasing, as ops/lmm_warm.py "
                         "modified_index builds it)")
    return mc


def _plain_index(mc_idx: Index) -> torch.Tensor:
    mc = torch.as_tensor(mc_idx)
    if mc.dtype != torch.int32:
        raise TypeError("mc_idx is int32")
    return mc


def _launch(entry: str, dev: torch.device, mc: np.ndarray, tensors,
            dims, eps: float, limit: int) -> None:
    """Launch ``entry`` (``dims`` its leading ints) with the index ``mc``
    staged: the C entry uploads it into the index slot (None) of
    ``tensors``."""
    host, host_t, dev_t, capturing = _STAGE.take(dev, mc.nbytes)
    host[:] = mc.view(np.uint8)
    ptrs = ptr_array([dev_t[:mc.nbytes].view(torch.int32) if t is None
                      else t for t in tensors])
    lib = build.load("warm_init", _SIG)
    try:
        rc = getattr(lib, entry)(*dims, ptrs, len(tensors), float(eps),
                                 int(limit),
                                 ctypes.c_void_p(host_t.data_ptr()),
                                 stream())
    finally:
        _STAGE.launched(dev, capturing)
    check(rc, entry)


def warm_init_plain(sys: LmmSystem, w: Work, pen: torch.Tensor,
                    mc_idx: torch.Tensor, eps: float,
                    limit: int = MAX_ROUNDS) -> bool:
    ev, ec, ew = sys.e_var.long(), sys.e_cnst.long(), sys.e_w
    n_c, n_v = sys.n_c, sys.n_v
    eps_t = torch.tensor(eps, dtype=ew.dtype, device=ew.device)
    c_mod = torch.zeros(n_c, dtype=torch.bool, device=ew.device)
    c_mod[mc_idx.long()] = True
    e_live = ew > 0
    v_mod = _any_by(ev, e_live & c_mod[ec], n_v)
    has_live_elem = _any_by(ev, e_live, n_v)
    v_enabled = pen > 0
    e_valid = e_live & v_enabled[ev]
    safe_pen = torch.where(v_enabled, pen, 1.0)
    e_upen = torch.where(e_valid, ew / safe_pen[ev], 0.0)
    usage_sum = torch.zeros_like(sys.c_bound).index_add_(0, ec, e_upen)
    usage0 = torch.where(sys.c_fatpipe, _max_by(ec, e_upen, n_c), usage_sum)
    v_value0 = torch.where(torch.isfinite(pen), pen, 0.0) * 0.0
    keep_prev = ~v_mod & v_enabled & has_live_elem
    w.v_value.copy_(torch.where(keep_prev, w.v_value, v_value0))
    w.v_fixed.copy_(torch.where(v_mod, pen < 0, True))
    w.remaining.copy_(torch.where(c_mod, sys.c_bound, w.remaining))
    w.usage.copy_(torch.where(c_mod, usage0, w.usage))
    w.light.copy_(c_mod & (sys.c_bound > sys.c_bound * eps_t)
                  & (usage0 > 0))
    w.c_mod.copy_(c_mod)
    c = w.ctrl
    c[IT] = 0
    c[LIGHT_ACC] = 0
    c[ARMED] = 1
    c[LIMIT] = limit
    c[LIGHT] = int(w.light.sum())
    return True


def warm_init(sys: LmmSystem, w: Work, pen: torch.Tensor, mc_idx: Index,
              eps: float, limit: int = MAX_ROUNDS) -> Optional[bool]:
    """Write the warm restart state of the modified constraints
    ``mc_idx`` (int32 on the host, padded by repeating an entry; sorted
    on the card, else ``ValueError``) into ``w``.
    ``sys.c_fatpipe`` must be set: the usage of a FATPIPE row is the max
    of its elements, of a SHARED row their in-order sum."""
    if sys.c_fatpipe is None:
        raise ValueError("warm_init needs sys.c_fatpipe")
    if on_cpu(pen, sys.e_w, w.ctrl):
        return warm_init_plain(sys, w, pen, _plain_index(mc_idx), eps,
                               limit)
    mc = host_index(mc_idx)
    csr = sys.csr
    _launch("warm_init", pen.device, mc, [
        pen, sys.e_var, sys.e_cnst, sys.e_w, sys.c_bound, sys.c_fatpipe,
        csr.c_ptr, csr.c_idx, csr.v_ptr, csr.v_idx, None, w.v_value,
        w.v_fixed, w.remaining, w.usage, w.light, w.c_mod, w.ctrl],
        (is_double(pen.dtype), sys.n_v, sys.n_c, len(mc)), eps, limit)
    COUNT.n += 1
    return None


def warm_init_ell_plain(sys: EllSystem, w: EllWork, pen: torch.Tensor,
                        mc_idx: torch.Tensor, eps: float,
                        limit: int = MAX_ROUNDS) -> bool:
    n_c, n_v = sys.n_c, sys.n_v
    dev = pen.device
    eps_t = torch.tensor(eps, dtype=pen.dtype, device=dev)
    cv_var = sys.cv_var.long()
    c_mod = torch.zeros(n_c, dtype=torch.bool, device=dev)
    c_mod[mc_idx.long()] = True
    live = sys.cv_valid & (sys.cv_w > 0)
    flat = cv_var.reshape(-1)
    v_mod = _any_by(flat, (live & c_mod[:, None]).reshape(-1), n_v)
    has_live_elem = _any_by(flat, live.reshape(-1), n_v)
    v_enabled = pen > 0
    cv_evalid = sys.cv_valid & v_enabled[cv_var]
    safe_pen = torch.where(v_enabled, pen, 1.0)
    cv_upen = torch.where(cv_evalid, sys.cv_w / safe_pen[cv_var], 0.0)
    usage0 = torch.where(sys.c_fatpipe, row_max0(cv_upen),
                         fold_rows(cv_upen))
    v_value0 = torch.where(torch.isfinite(pen), pen, 0.0) * 0.0
    keep_prev = ~v_mod & v_enabled & has_live_elem
    v_fixed = torch.where(v_mod, pen < 0, True)
    w.v_value.copy_(torch.where(keep_prev, w.v_value, v_value0))
    w.v_fixed.copy_(v_fixed)
    w.remaining.copy_(torch.where(c_mod, sys.c_bound, w.remaining))
    w.usage.copy_(torch.where(c_mod, usage0, w.usage))
    w.light.copy_(c_mod & (sys.c_bound > sys.c_bound * eps_t)
                  & (usage0 > 0))
    w.cv_live.copy_(torch.where(c_mod[:, None],
                                cv_evalid & ~v_fixed[cv_var], w.cv_live))
    w.c_mod.copy_(c_mod)
    w.v_mod.copy_(v_mod)
    w.v_has.copy_(has_live_elem)
    arm_ctrl(w.ctrl, w.light, limit)
    return True


def warm_init_ell(sys: EllSystem, w: EllWork, pen: torch.Tensor,
                  mc_idx: Index, eps: float,
                  limit: int = MAX_ROUNDS) -> Optional[bool]:
    """Write the warm restart state of the modified constraints
    ``mc_idx`` (int32 on the host, padded by repeating an entry; sorted
    on the card, else ``ValueError``) into the ELL fixpoint state ``w``,
    from the ELL tables of ``sys`` and the previous converged solve ``w``
    holds (values, remaining, usage and the ``cv_live`` mask)."""
    if on_cpu(pen, sys.cv_w, w.ctrl):
        return warm_init_ell_plain(sys, w, pen, _plain_index(mc_idx), eps,
                                   limit)
    mc = host_index(mc_idx)
    _launch("warm_init_ell", pen.device, mc, [
        pen, sys.cv_var, sys.cv_w, sys.cv_valid, sys.vc_cnst, sys.vc_valid,
        sys.vc_w, sys.c_bound, sys.c_fatpipe, None, w.v_value, w.v_fixed,
        w.remaining, w.usage, w.light, w.cv_live, w.c_mod, w.v_mod, w.v_has,
        w.ctrl], (is_double(pen.dtype), sys.n_v, sys.n_c, sys.wc, sys.wv,
                  len(mc)), eps, limit)
    ELL_COUNT.n += 1
    return None
