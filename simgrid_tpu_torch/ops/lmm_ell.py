"""The ELL layout: the JAX package's solve on an accelerator.

Counterpart of ``simgrid_tpu/ops/lmm_jax.py``'s ELL parts:

* :class:`LmmEllArrays`, :func:`ell_from_arrays` and :func:`ell_cached`
  (``:90-169``, ``:1004-1019``): the host repack of the COO arrays into
  padded constraint rows [C, Wc] and variable rows [V, Wv] (lanes in
  stable element order, power-of-two widths from 4, refused above a row
  width of 512 or a fill of 8), memoised by identity;
* :func:`device_args` (``:969-1001``): the identity-keyed LRU of eight
  uploads, counting ``uploaded_bytes_full`` on a miss only;
* :func:`solve_ell_dense` (``_solve_ell_chunk``, ``:944-966``, as
  ``solve_arrays`` drives it): K7's init, then K8 rounds (local,
  bound-free) or K7 rounds (with bounds, or global), in chunks;
* :func:`solve_ell_chain` (``:819-941``): the device-resident compaction
  chain: a host numpy init (as the JAX package computes it, numpy's
  pairwise row sums included), stages of K8 rounds (a K16 loop a stage,
  under ``_ell_chain_stage``'s condition) that end once at most half
  the variable rows are live, each followed by K9's stable live-first
  partition into half the rows, then finisher chunks (under
  ``_vc_chunk``'s condition) with one fetch each.  On the card the
  stages and the first chunk are one graph launch, over buffers kept
  per chain shape (:func:`chain_state`), and each further chunk one
  more.  Overflow or a stall returns None, and the caller re-solves on
  the dense path, as the reference does.

The constants are module attributes, as in the JAX package, so a test
can shrink the chain's stage cap.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels.common import MAX_ROUNDS, EllSystem, EllWork, Work
from ..kernels.ell_chain import (ChainState, chain_arm, chain_fetch,
                                 chain_stage)
from ..kernels.ell_round import ell_init
from ..kernels.superstep_loop import PRED_VC_ROUND, DeviceLoop, Loop, cached
from ..kernels.vc_round import vc_prep, vc_round
from . import opstats
from .lmm_arrays import LmmArrays, bucket
from .lmm_torch import SolveError, run_chunks


class LmmEllArrays(NamedTuple):
    """ELL (padded-row) layout of an LMM system: every constraint owns a
    fixed-width row of (variable, weight) slots and every variable a
    fixed-width row of constraint slots."""
    cv_var: np.ndarray    # [C, Wc] int32 — variable slot per element
    cv_w: np.ndarray      # [C, Wc] float — weight (0 padding)
    cv_valid: np.ndarray  # [C, Wc] bool
    vc_cnst: np.ndarray   # [V, Wv] int32 — constraint slot per element
    vc_valid: np.ndarray  # [V, Wv] bool
    c_bound: np.ndarray
    c_fatpipe: np.ndarray
    v_penalty: np.ndarray
    v_bound: np.ndarray
    n_cnst: int
    n_var: int
    #: [V, Wv] float — element weight in variable-row layout
    vc_w: Optional[np.ndarray] = None


#: conversion is refused when a row would exceed this width
_ELL_MAX_WIDTH = 512
#: ...or when padding would inflate the slots by more than this factor
#: over the element count
_ELL_MAX_FILL = 8.0
#: chain stages stop once the halved shape would fall below this
_CHAIN_MIN_V = 8192
#: per-stage round cap
_CHAIN_STAGE_CAP = 64


def ell_widths(e_var: np.ndarray, e_cnst: np.ndarray, n_c: int,
               n_v: int, pad: str = "pow2") -> Optional[tuple]:
    """(c_deg, v_deg, Wc, Wv) of the live elements, or None when the
    caps refuse the system (a row wider than ``_ELL_MAX_WIDTH``, or more
    than ``_ELL_MAX_FILL`` times the element count in slots).  ``pad``
    is the JAX package's ``lmm/pad``: power-of-two widths from 4, or the
    exact widths (``"tight"``)."""
    n_e = len(e_var)
    c_deg = np.bincount(e_cnst, minlength=n_c)
    v_deg = np.bincount(e_var, minlength=n_v)
    wc = int(c_deg.max()) if n_e else 1
    wv = int(v_deg.max()) if n_e else 1
    if wc > _ELL_MAX_WIDTH or wv > _ELL_MAX_WIDTH:
        return None
    wc_b = bucket(max(wc, 1), floor=4, pad=pad)
    wv_b = bucket(max(wv, 1), floor=4, pad=pad)
    if n_e and (n_c * wc_b + n_v * wv_b) > _ELL_MAX_FILL * 2 * n_e:
        return None
    return c_deg, v_deg, wc_b, wv_b


def row_slots(keys: np.ndarray, n_rows: int):
    """Per element, its lane in its row: rows list their elements in
    stable (element index) order.  Returns (order, row, lane)."""
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    group_start = np.searchsorted(sorted_keys, np.arange(n_rows))
    lanes = np.arange(len(keys), dtype=np.int64) - group_start[sorted_keys]
    return order, sorted_keys, lanes


def ell_tables(e_var: np.ndarray, e_cnst: np.ndarray, e_w: np.ndarray,
               n_c: int, n_v: int, wc: int, wv: int, dtype):
    """The six ELL tables of the elements (``cv_var``, ``cv_w``,
    ``cv_valid`` [n_c, wc]; ``vc_cnst``, ``vc_valid``, ``vc_w``
    [n_v, wv]; validity is weight > 0), and each element's lane in its
    constraint row and in its variable row."""
    ew = e_w.astype(dtype)
    cv_var = np.zeros((n_c, wc), np.int32)
    cv_w = np.zeros((n_c, wc), dtype)
    cv_valid = np.zeros((n_c, wc), bool)
    order, rows, cv_lane = row_slots(e_cnst, n_c)
    cv_var[rows, cv_lane] = e_var[order]
    cv_w[rows, cv_lane] = ew[order]
    cv_valid[rows, cv_lane] = ew[order] > 0
    cv_lanes = np.empty(len(e_var), np.int64)
    cv_lanes[order] = cv_lane

    vc_cnst = np.zeros((n_v, wv), np.int32)
    vc_valid = np.zeros((n_v, wv), bool)
    vc_w = np.zeros((n_v, wv), dtype)
    order, rows, vc_lane = row_slots(e_var, n_v)
    vc_cnst[rows, vc_lane] = e_cnst[order]
    vc_valid[rows, vc_lane] = ew[order] > 0
    vc_w[rows, vc_lane] = ew[order]
    vc_lanes = np.empty(len(e_var), np.int64)
    vc_lanes[order] = vc_lane
    return ((cv_var, cv_w, cv_valid, vc_cnst, vc_valid, vc_w),
            cv_lanes, vc_lanes)


def ell_from_arrays(arrays: LmmArrays,
                    pad: str = "pow2") -> Optional[LmmEllArrays]:
    """Host repack of the COO arrays into ELL rows (numpy) at the row
    widths ``pad`` gives (:func:`ell_widths`), or None when the caps
    refuse it."""
    n_e, n_c, n_v = arrays.n_elem, len(arrays.c_bound), \
        len(arrays.v_penalty)
    e_var = arrays.e_var[:n_e]
    e_cnst = arrays.e_cnst[:n_e]
    widths = ell_widths(e_var, e_cnst, n_c, n_v, pad)
    if widths is None:
        return None
    (cv_var, cv_w, cv_valid, vc_cnst, vc_valid, vc_w), _, _ = ell_tables(
        e_var, e_cnst, arrays.e_w[:n_e], n_c, n_v, widths[2], widths[3],
        arrays.e_w.dtype)
    return LmmEllArrays(cv_var, cv_w, cv_valid, vc_cnst, vc_valid,
                        arrays.c_bound, arrays.c_fatpipe,
                        arrays.v_penalty, arrays.v_bound,
                        arrays.n_cnst, arrays.n_var, vc_w)


#: memo of COO -> ELL conversions; values hold the source arrays, so
#: their ids stay alive and every field is identity-checked on a hit
_ELL_CACHE: dict = {}


def ell_cached(arrays: LmmArrays,
               pad: str = "pow2") -> Optional[LmmEllArrays]:
    key = (id(arrays.e_var), id(arrays.e_cnst), pad)
    hit = _ELL_CACHE.get(key)
    if hit is not None:
        src, ell = hit
        if all(a is b for a, b in zip(src, arrays)):
            return ell
    ell = ell_from_arrays(arrays, pad)
    if len(_ELL_CACHE) >= 8:
        _ELL_CACHE.clear()
    _ELL_CACHE[key] = (arrays, ell)
    return ell


#: device copies of solver inputs, keyed by (kind, ids, device); values
#: keep the host arrays alive and identity-checked
_DEVICE_ARGS_CACHE: dict = {}


def device_args(kind: str, host_args, device: torch.device, make=None):
    """The device copies of ``host_args`` (numpy arrays), uploaded on a
    miss only (counted in ``uploaded_bytes_full``) and kept in an LRU of
    eight entries.  ``make(tensors)``, when given, derives what the
    caller needs from the copies once, and that is what the entry keeps
    and returns.  Callers never mutate a host array after passing it."""
    key = (kind, tuple(id(a) for a in host_args), str(device))
    hit = _DEVICE_ARGS_CACHE.get(key)
    if hit is not None:
        src, dev_args = hit
        if all(a is b for a, b in zip(src, host_args)):
            _DEVICE_ARGS_CACHE.pop(key)
            _DEVICE_ARGS_CACHE[key] = hit
            return dev_args
    tensors = [torch.from_numpy(np.ascontiguousarray(a)).to(device,
                                                              copy=True)
               for a in host_args]
    dev_args = make(tensors) if make is not None else tensors
    opstats.bump("uploaded_bytes_full",
                 sum(getattr(a, "nbytes", 0) for a in host_args))
    if len(_DEVICE_ARGS_CACHE) >= 8:
        _DEVICE_ARGS_CACHE.pop(next(iter(_DEVICE_ARGS_CACHE)))
    _DEVICE_ARGS_CACHE[key] = (list(host_args), dev_args)
    return dev_args


def build_vc_index(vc_cnst: torch.Tensor, vc_valid: torch.Tensor,
                   vc_w: torch.Tensor, n_c: int) -> dict:
    """K8's constraint-ordered entry layout over the variable-row tables
    (:class:`~..kernels.common.EllSystem`'s ``vcx_*`` fields): for each
    constraint, its valid entries in increasing flat position ``v * Wv
    + lane`` (a stable sort keeps them so), with the row pointers
    (``vcx_ptr`` [C+1]), the positions, the entries' rows and weights,
    and a buffer for their ``w / penalty`` (zeros; K8's ``vc_prep``
    fills it), on the tables' device.  Built where the tables are
    (glue, counted in ``row_index_builds``)."""
    wv = int(vc_cnst.shape[1])
    pos = torch.nonzero(vc_valid.reshape(-1)).reshape(-1)
    keys = vc_cnst.reshape(-1).to(torch.int64)[pos]
    order = torch.argsort(keys, stable=True)
    counts = torch.bincount(keys, minlength=n_c)
    ptr = torch.zeros(n_c + 1, dtype=torch.int64, device=vc_cnst.device)
    ptr[1:] = torch.cumsum(counts, 0)
    idx = pos[order]
    opstats.bump("row_index_builds")
    return dict(vcx_ptr=ptr.to(torch.int32), vcx_idx=idx.to(torch.int32),
                vcx_row=(idx // wv).to(torch.int32),
                vcx_w=vc_w.reshape(-1)[idx],
                vcx_upen=torch.zeros(len(idx), dtype=vc_w.dtype,
                                     device=vc_w.device))


def ell_system(cv_var, cv_w, cv_valid, vc_cnst, vc_valid, vc_w, c_bound,
               c_fatpipe) -> EllSystem:
    """An :class:`EllSystem` over device tables, with K8's layout."""
    return EllSystem(cv_var, cv_w, cv_valid, vc_cnst, vc_valid, vc_w,
                     c_bound, c_fatpipe, **build_vc_index(
                         vc_cnst, vc_valid, vc_w, int(c_bound.shape[0])))


def _dense_args(t):
    """``device_args`` maker of the dense kind: (system, pen, vb)."""
    cv_var, cv_w, cv_valid, vc_cnst, vc_valid, c_bound, c_fat, pen, vb, \
        vc_w = t
    return (ell_system(cv_var, cv_w, cv_valid, vc_cnst, vc_valid, vc_w,
                       c_bound, c_fat), pen, vb)


def dense_system(ell: LmmEllArrays, device: torch.device):
    """The dense path's device system, penalties and bounds (the JAX
    package's ``"ell"`` upload kind)."""
    return device_args(
        "ell", [ell.cv_var, ell.cv_w, ell.cv_valid, ell.vc_cnst,
                ell.vc_valid, ell.c_bound, ell.c_fatpipe, ell.v_penalty,
                ell.v_bound, ell.vc_w], device, make=_dense_args)


def solve_ell_dense(ell: LmmEllArrays, eps: float, device: torch.device,
                    global_rounds: bool, has_bounds: bool,
                    has_fatpipe: bool, chunk: int, what):
    """``fixpoint_ell`` in chunks from its None-carry init (K7), with
    the reference's host checks between chunks; returns numpy
    ``(values, remaining, usage, rounds)``."""
    opstats.bump("ell_solves")
    sys, pen, vb = dense_system(ell, device)
    w = EllWork(sys.n_v, sys.n_c, sys.wc, sys.cv_w.dtype, device)
    ell_init(sys, w, pen, eps, vb)
    return run_chunks(sys, w, pen, eps, vb, has_bounds, has_fatpipe,
                      global_rounds, chunk, what)


#: memo of the chain's host init per (ell identity, eps)
_CHAIN_INIT_CACHE: dict = {}


def _chain_tables(t):
    vc_cnst, vc_w, vc_valid, pen, c_bound, c_fat = t
    return EllSystem(None, None, None, vc_cnst, vc_valid, vc_w, c_bound,
                     c_fat, **build_vc_index(vc_cnst, vc_valid, vc_w,
                                             int(c_bound.shape[0]))), pen


def chain_init(ell: LmmEllArrays, eps_f: float, has_fatpipe: bool):
    """The chain's initial carry on the host, as the JAX package
    computes it (numpy's pairwise row sums), memoised per (ell, eps)."""
    dtype = ell.vc_w.dtype
    key = (id(ell.vc_cnst), id(ell.cv_w), eps_f)
    hit = _CHAIN_INIT_CACHE.get(key)
    if hit is not None and hit[0] is ell.vc_cnst and hit[1] is ell.cv_w:
        _CHAIN_INIT_CACHE.pop(key)
        _CHAIN_INIT_CACHE[key] = hit
        return hit[2]
    v0 = ell.v_penalty.shape[0]
    np_pen = ell.v_penalty
    safe_pen = np.where(np_pen > 0, np_pen, 1.0)
    cv_evalid = ell.cv_valid & (np_pen[ell.cv_var] > 0)
    cv_upen = np.where(cv_evalid, ell.cv_w / safe_pen[ell.cv_var],
                       0.0).astype(dtype)
    usage0_np = cv_upen.sum(axis=1, dtype=dtype)
    if has_fatpipe:
        usage0_np = np.where(ell.c_fatpipe,
                             cv_upen.max(axis=1, initial=0.0), usage0_np)
    light0_np = (ell.c_bound > ell.c_bound * eps_f) & (usage0_np > 0)
    init_np = [np.zeros(v0, dtype), (np_pen < 0),
               ell.c_bound.astype(dtype), usage0_np, light0_np,
               np.arange(v0, dtype=np.int32)]
    if len(_CHAIN_INIT_CACHE) >= 8:
        _CHAIN_INIT_CACHE.pop(next(iter(_CHAIN_INIT_CACHE)))
    _CHAIN_INIT_CACHE[key] = (ell.vc_cnst, ell.cv_w, init_np)
    return init_np


#: the chains' states by shape (V0, C, layout capacity, Wv, dtype,
#: device): their buffers, and the graphs built over them
_CHAIN_STATES: dict = {}


def chain_state(sys: EllSystem, pen: torch.Tensor, orig: torch.Tensor,
                device: torch.device) -> ChainState:
    """The :class:`ChainState` of the chain's shape, made at its first
    solve and kept (an LRU of four shapes), reset to the first stage
    over ``sys``, ``pen`` and ``orig``."""
    key = (sys.n_v, sys.n_c, int(sys.vcx_row.shape[0]), sys.wv,
           sys.vc_w.dtype, str(device))
    cs = _CHAIN_STATES.pop(key, None)
    if cs is None:
        if len(_CHAIN_STATES) >= 4:
            _CHAIN_STATES.pop(next(iter(_CHAIN_STATES)))
        cs = ChainState(sys, pen, orig,
                        Work(sys.n_v, sys.n_c, sys.vc_w.dtype, device))
        cs.loops = {}
        cs.out = torch.empty(4 + sys.n_v + 2 * sys.n_c,
                             dtype=sys.vc_w.dtype, device=device)
    _CHAIN_STATES[key] = cs
    cs.reset(sys, pen, orig)
    return cs


def chain_halves(v0: int) -> tuple:
    """The rows each stage keeps: halving from ``v0`` while the half is
    at least ``_CHAIN_MIN_V``."""
    out, vs = [], v0
    while vs // 2 >= _CHAIN_MIN_V:
        vs //= 2
        out.append(vs)
    return tuple(out)


def _chain_loops(cs: ChainState, eps_f: float, has_fatpipe: bool,
                 chunk: int):
    """The chain as two K16 loops over ``cs``'s fixed buffers: the whole
    chain (K8's prep and the first arm, each stage's rounds and its K9
    stage, which arms the next loop, then the finisher's first chunk of
    rounds and its fetch), and a finisher chunk alone.  Built once per
    shape, stage-0 buffers and scalars (``superstep_loop.cached``)."""
    w = cs.w
    halves = chain_halves(cs.v0)
    arms = [(_CHAIN_STAGE_CAP, h) for h in halves] + [(-1, -1)]

    def rounds(cap: int = 0) -> Loop:
        # K8's rounds over the stage's tables while vc_go holds (a
        # stage's cap is in its round limit; the finisher's is ``cap``)
        return Loop(PRED_VC_ROUND, w.ctrl, (lambda: vc_round(
            cs.sys, w, cs.pen, eps_f, has_fatpipe),),
            cap=cap, tally="vc_round", ends=True)

    def stage(k: int):
        return lambda: chain_stage(cs, halves[k], arms[k + 1])

    steps = [lambda: vc_prep(cs.sys, w, cs.pen),
             lambda: chain_arm(cs, *arms[0], True)]
    for k in range(len(halves)):
        steps += [rounds(), stage(k)]
    tail = [rounds(chunk), lambda: chain_fetch(cs, cs.out)]
    refs = cs.first + (eps_f, has_fatpipe, chunk, _CHAIN_MIN_V,
                       _CHAIN_STAGE_CAP)
    dev = cs.out.device
    # the finisher's graph is captured at its first run, after the
    # chain's run has left ``cs`` at the last stage's buffers
    main = cached(cs.loops, "main", refs,
                  lambda: DeviceLoop(steps + tail, "chain", dev, refs))
    fin = cached(cs.loops, "finisher", refs,
                 lambda: DeviceLoop(tail, "chain", dev, refs))
    return main, fin, halves


def solve_ell_chain(ell: LmmEllArrays, eps: float, device: torch.device,
                    has_fatpipe: bool, chunk: int):
    """The compaction chain (``_solve_ell_chain``); returns numpy
    ``(values, remaining, usage, rounds)``, or None on a stage overflow
    or a stall (the caller re-solves on the dense path).  On the card
    the stages and the first finisher chunk are one graph launch, and
    each further chunk one more, with one fetch each."""
    eps_f = float(eps)
    opstats.bump("ell_chain_solves")
    sys, pen = device_args(
        "vc_chain", [ell.vc_cnst, ell.vc_w, ell.vc_valid, ell.v_penalty,
                     ell.c_bound, ell.c_fatpipe], device,
        make=_chain_tables)
    init = device_args("vc_chain_init", chain_init(ell, eps_f, has_fatpipe),
                       device)
    v0, n_c = sys.n_v, sys.n_c
    cs = chain_state(sys, pen, init[5], device)
    w = cs.w
    # the carry starts as a copy: the cached init stays as uploaded
    for t, src in zip((w.v_value, w.v_fixed, w.remaining, w.usage,
                       w.light), init[:5]):
        t.copy_(src)
    main, finisher, halves = _chain_loops(cs, eps_f, has_fatpipe, chunk)
    main.run()
    cs.goto(halves)
    opstats.bump("ell_chain_stages", len(halves))
    prev_progress = None
    while True:
        fetched = opstats.timed_fetch(cs.out)
        rounds, n_light, n_fixed, oflow = (int(fetched[0]),
                                           int(fetched[1]),
                                           int(fetched[2]),
                                           bool(fetched[3]))
        if oflow:
            opstats.bump("ell_chain_fallbacks")
            return None
        if n_light == 0:
            break
        if rounds >= MAX_ROUNDS:
            raise SolveError(
                f"LMM chain solve did not converge within {MAX_ROUNDS} "
                f"saturation rounds ({ell.n_cnst} constraints, "
                f"{ell.n_var} variables, {n_light} still active); "
                f"check maxmin/precision vs the system's magnitudes")
        progress = (n_light, n_fixed)
        if progress == prev_progress:
            opstats.bump("ell_chain_fallbacks")
            return None
        prev_progress = progress
        finisher.run()
    return (fetched[4:4 + v0], fetched[4 + v0:4 + v0 + n_c],
            fetched[4 + v0 + n_c:4 + v0 + 2 * n_c], rounds)
