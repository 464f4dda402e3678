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
line-by-line transcription of the JAX program) and return True; on
CUDA tensors they launch the kernel and return None.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build
from .common import (ARMED, IT, LIGHT, LIGHT_ACC, LIMIT, MAX_ROUNDS, D, I,
                     EllSystem, EllWork, LmmSystem, P, Work, check, counter,
                     is_double, on_cpu, ptr_array, stream)
from .ell_round import arm_ctrl, fold_rows, row_max0
from .lmm_round import _any_by, _max_by

COUNT = counter("warm_init")
ELL_COUNT = counter("warm_init_ell")

#: buffers handed to the C entry as one pointer array, in this order
N_PTRS = 18

_SIG = {"warm_init": [I, I, I, I, P, I, D, I, P],
        "warm_init_ell": [I, I, I, I, I, P, I, D, I, P]}

#: buffers of the ELL arm's C entry, in this order
N_PTRS_ELL = 17


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


def warm_init(sys: LmmSystem, w: Work, pen: torch.Tensor,
              mc_idx: torch.Tensor, eps: float,
              limit: int = MAX_ROUNDS) -> Optional[bool]:
    """Write the warm restart state of the modified constraints
    ``mc_idx`` (int32, padded by repeating an entry) into ``w``.
    ``sys.c_fatpipe`` must be set: the usage of a FATPIPE row is the max
    of its elements, of a SHARED row their in-order sum."""
    if sys.c_fatpipe is None:
        raise ValueError("warm_init needs sys.c_fatpipe")
    if mc_idx.dtype != torch.int32:
        raise TypeError("mc_idx is int32")
    if on_cpu(pen, sys.e_w, w.ctrl, mc_idx):
        return warm_init_plain(sys, w, pen, mc_idx, eps, limit)
    lib = build.load("warm_init", _SIG)
    csr = sys.csr
    ptrs = ptr_array([
        pen, sys.e_var, sys.e_cnst, sys.e_w, sys.c_bound, sys.c_fatpipe,
        csr.c_ptr, csr.c_idx, csr.v_ptr, csr.v_idx, mc_idx, w.v_value,
        w.v_fixed, w.remaining, w.usage, w.light, w.c_mod, w.ctrl])
    rc = lib.warm_init(is_double(pen.dtype), sys.n_v, sys.n_c,
                       int(mc_idx.shape[0]), ptrs, N_PTRS, float(eps),
                       int(limit), stream())
    check(rc, "warm_init")
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
                  mc_idx: torch.Tensor, eps: float,
                  limit: int = MAX_ROUNDS) -> Optional[bool]:
    """Write the warm restart state of the modified constraints
    ``mc_idx`` (int32, padded by repeating an entry) into the ELL
    fixpoint state ``w``, from the ELL tables of ``sys`` and the
    previous converged solve ``w`` holds (values, remaining, usage and
    the ``cv_live`` mask)."""
    if mc_idx.dtype != torch.int32:
        raise TypeError("mc_idx is int32")
    if on_cpu(pen, sys.cv_w, w.ctrl, mc_idx):
        return warm_init_ell_plain(sys, w, pen, mc_idx, eps, limit)
    lib = build.load("warm_init", _SIG)
    ptrs = ptr_array([
        pen, sys.cv_var, sys.cv_w, sys.cv_valid, sys.c_bound,
        sys.c_fatpipe, mc_idx, w.v_value, w.v_fixed, w.remaining, w.usage,
        w.light, w.cv_live, w.c_mod, w.v_mod, w.v_has, w.ctrl])
    rc = lib.warm_init_ell(is_double(pen.dtype), sys.n_v, sys.n_c, sys.wc,
                           int(mc_idx.shape[0]), ptrs, N_PTRS_ELL,
                           float(eps), int(limit), stream())
    check(rc, "warm_init_ell")
    ELL_COUNT.n += 1
    return None
