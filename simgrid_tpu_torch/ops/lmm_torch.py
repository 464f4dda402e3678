"""The max-min solve on the port's kernels, and the System backend.

Counterpart of ``simgrid_tpu/ops/lmm_jax.py``:

* :func:`solve_arrays` — ``solve_arrays`` (``:1316-1506``) and
  ``check_convergence`` (``:1509``), in the COO layout (K1) or, where
  the layout choice resolves to it, the ELL layout (:mod:`.lmm_ell`:
  the dense path or the compaction chain), in local
  rounds (the default, as ``lmm/rounds`` defaults to ``local``) or
  global rounds (``parallel_rounds=False``), with the bound-first rule
  and the FATPIPE usage max switched on exactly where the JAX solve
  switches them on.  Rounds run in chunks; after each chunk the host
  fetches the round count, the light and fixed counts and the result
  vectors in one transfer, and raises the same non-convergence and
  stall errors as the reference, as :class:`SolveError`;
* :func:`flatten`, :func:`solve_flattened`, :func:`solve_torch`,
  :func:`dispatching_solve` and :func:`install` (``:1099-1152``,
  ``:1519-1711``): a port-side :class:`~.lmm_host.System` solved on the
  card.  Selective-update systems go through the warm solver
  (:mod:`.lmm_warm`), full-update systems through the
  :class:`~.lmm_view.ArrayView` snapshot.  On the host CPU a
  :class:`SolveError` falls back to the exact host list solver (counted
  in ``solver_fallbacks``) unless the flags are strict; on the card it
  always propagates, as does any other error.
"""

from __future__ import annotations

import functools
import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.common import (IT, LIGHT, MAX_ROUNDS, EllSystem, LmmSystem,
                              Work)
from ..kernels.ell_round import ell_prep, ell_round
from ..kernels.lmm_round import lmm_init, lmm_round, plan_of
from ..kernels.superstep_loop import (PRED_ROUND, PRED_VC_ROUND,
                                      DeviceLoop, Loop, cached)
from ..kernels.vc_round import vc_prep, vc_round
from . import opstats
from .csr import build_csr
from .lmm_arrays import LmmArrays, bucket
from .lmm_host import (Constraint, LmmFlags, SharingPolicy, System,
                       Variable)
from .lmm_view import ArrayView

__all__ = ["LmmFlags", "SolveError", "solve_arrays", "flatten",
           "solve_flattened", "solve_torch", "dispatching_solve",
           "install"]

_log = logging.getLogger(__name__)


class SolveError(RuntimeError):
    """A device solve that did not converge, stalled or returned
    non-finite rates: the failures :func:`solve_torch` hands to the host
    list solver.  A kernel that fails to build or launch raises a plain
    ``RuntimeError`` instead, which no solve path catches."""


def to_device_system(e_var, e_cnst, e_w, c_bound, n_v: int,
                     dtype: torch.dtype, device: torch.device,
                     c_fatpipe=None) -> LmmSystem:
    """Upload COO elements, bounds and (optionally) the FATPIPE flags,
    and build both row indexes.  Counts no bytes: each caller counts the
    arrays the JAX package counts for the same upload (it has no row
    indexes)."""
    ev = torch.from_numpy(np.array(e_var, np.int32))
    ec = torch.from_numpy(np.array(e_cnst, np.int32))
    ew = torch.from_numpy(np.array(e_w)).to(dtype)
    cb = torch.from_numpy(np.array(c_bound)).to(dtype)
    fat = (None if c_fatpipe is None
           else torch.from_numpy(np.array(c_fatpipe, bool)))
    csr = build_csr(ev, ec, ew, len(cb), n_v)
    put = lambda t: t.to(device)
    return LmmSystem(put(ev), put(ec), put(ew), put(cb),
                     type(csr)(*(put(t) for t in csr)), int(n_v),
                     None if fat is None else put(fat))


#: rounds a chunk runs at most on the card (the JAX package's
#: ``_CHUNK_ROUNDS_ACCEL``; also the chain's finisher chunk)
CHUNK_ROUNDS_ACCEL = 256


def chunk_rounds(device: torch.device, n_elem: int) -> int:
    """Rounds per chunk, for the solve and the warm solver alike: the
    JAX CPU default on the host; on the card the JAX accelerator default
    (a chunk is one K16 launch of at most this many rounds), and 32 from
    2**20
    elements, where the JAX package caps its big COO chunks
    (``lmm_jax.py:1373-1381``, ``lmm_warm.py:669-671``; ELL callers
    pass ``n_elem=0``: the cap is COO's only in ``solve_arrays``)."""
    if device.type == "cpu":
        return 4096
    return 32 if n_elem >= 1 << 20 else CHUNK_ROUNDS_ACCEL


def _round_fn(sys, has_bounds: bool, global_rounds: bool):
    """The round a chunk runs, its loop condition and its tally: K1 over
    COO; over ELL, K8 for a local bound-free system (``fixpoint_ell``'s
    ``body_local_vc``), else K7."""
    if not isinstance(sys, EllSystem):
        return (lambda w, pen, eps, vb, fat: lmm_round(
            sys, w, pen, eps, vb, has_bounds, fat, global_rounds),
            PRED_ROUND, "lmm_round")
    if not global_rounds and not has_bounds:
        return (lambda w, pen, eps, vb, fat: vc_round(sys, w, pen, eps, fat),
                PRED_VC_ROUND, "vc_round")
    return (lambda w, pen, eps, vb, fat: ell_round(sys, w, pen, eps, vb, fat,
                                                   global_rounds),
            PRED_VC_ROUND, "ell_round")


def chunk_loop(sys, w: Work, pen: torch.Tensor, eps: float,
               vb: Optional[torch.Tensor], has_bounds: bool,
               has_fatpipe: bool, global_rounds: bool,
               chunk: int) -> DeviceLoop:
    """At most ``chunk`` rounds while the fixpoint runs, as one K16
    launch (kept on ``w`` for the same buffers and arms).  K8's and K7's
    rounds start with their prep (``vc_prep``, ``ell_prep``: what the
    rounds read that the solve keeps fixed); every round ends its loop's
    body itself."""
    one_round, pred, tally = _round_fn(sys, has_bounds, global_rounds)
    refs = (sys, w, pen, vb, float(eps), has_bounds, has_fatpipe,
            global_rounds, chunk)
    steps = [Loop(pred, w.ctrl, (lambda: one_round(w, pen, eps, vb,
                                                   has_fatpipe),),
                  cap=chunk, tally=tally, ends=True)]
    if tally == "vc_round":
        steps.insert(0, lambda: vc_prep(sys, w, pen))
    elif tally == "ell_round":
        steps.insert(0, lambda: ell_prep(sys, w, pen, vb))
    prepare = (None if isinstance(sys, EllSystem)
               else lambda: plan_of(sys, w))
    return cached(w.ptr_cache, "chunk_loop", refs, lambda: DeviceLoop(
        steps, "chunk", w.ctrl.device, refs, prepare=prepare))


def run_chunks(sys, w: Work, pen: torch.Tensor, eps: float,
               vb: Optional[torch.Tensor], has_bounds: bool,
               has_fatpipe: bool, global_rounds: bool, chunk: int,
               what: str):
    """Run the rounds from the state in ``w`` (an init, cold or warm,
    has armed it) in chunks of at most ``chunk`` rounds (one K16 launch
    each, :func:`chunk_loop`), with the
    reference's host convergence checks between chunks; returns numpy
    ``(values, remaining, usage, rounds)`` from one fetch per chunk.
    ``sys`` is an :class:`LmmSystem` (K1's rounds) or an
    :class:`EllSystem` (K7's or K8's, as ``fixpoint_ell`` picks its
    body; ``w`` then carries ``cv_live``).  ``what`` names the solve and
    its size in the errors."""
    dtype = w.v_value.dtype
    n_v, n_c = sys.n_v, sys.n_c
    loop = chunk_loop(sys, w, pen, eps, vb, has_bounds, has_fatpipe,
                      global_rounds, chunk)
    prev_progress = None
    while True:
        loop.run()
        opstats.bump("dispatches")
        head = torch.stack([w.ctrl[IT], w.ctrl[LIGHT],
                            w.v_fixed.sum(dtype=torch.int32)]).to(dtype)
        fetched = opstats.timed_fetch(
            torch.cat([head, w.v_value, w.remaining, w.usage]))
        rounds, n_light, n_fixed = (int(fetched[0]), int(fetched[1]),
                                    int(fetched[2]))
        if n_light == 0:
            return (fetched[3:3 + n_v], fetched[3 + n_v:3 + n_v + n_c],
                    fetched[3 + n_v + n_c:3 + n_v + 2 * n_c], rounds)
        if rounds >= MAX_ROUNDS:
            raise SolveError(
                f"{what[0]} did not converge within {MAX_ROUNDS} "
                f"saturation rounds ({what[1]}, {n_light} still active); "
                f"check maxmin/precision vs the system's magnitudes")
        progress = (n_light, n_fixed)
        if progress == prev_progress:
            raise SolveError(
                f"{what[0]} stalled after {rounds} rounds: {n_light} "
                f"active constraints and {n_fixed} fixed variables "
                f"unchanged over {chunk} rounds ({what[1]}); the system "
                f"does not converge at eps={eps} in "
                f"{str(dtype).replace('torch.', '')} precision")
        prev_progress = progress


LAYOUTS = ("auto", "coo", "ell")
CHAINS = ("auto", "on", "off")


def check_choice(name: str, value: str, allowed) -> None:
    if value not in allowed:
        raise ValueError(f"Unknown {name} {value!r} "
                         f"(expected {', '.join(allowed)})")


def uses_ell(layout: str, device: torch.device) -> bool:
    """Whether a solve tries the ELL layout: asked for, or ``auto`` on
    the card (the JAX package's ``auto`` off the CPU platform,
    ``lmm_jax.py:1344-1349``)."""
    check_choice("layout", layout, LAYOUTS)
    return layout == "ell" or (layout == "auto" and device.type != "cpu")


def uses_chain(chain: str, device: torch.device) -> bool:
    """Whether an eligible ELL solve takes the compaction chain: asked
    for, or ``auto`` on the card (``lmm_jax.py:1404-1416``)."""
    check_choice("chain", chain, CHAINS)
    return chain == "on" or (chain == "auto" and device.type != "cpu")


def _coo_args(t):
    """``lmm_ell.device_args`` maker of the COO kind: (system, pen, vb)
    with both row indexes built on the device."""
    ev, ec, ew, cb, fat, pen, vb = t
    ev, ec = ev.to(torch.int32), ec.to(torch.int32)
    cb, pen, vb = (x.to(ew.dtype) for x in (cb, pen, vb))
    csr = build_csr(ev, ec, ew, int(cb.shape[0]), int(pen.shape[0]))
    return LmmSystem(ev, ec, ew, cb, csr, int(pen.shape[0]), fat), pen, vb


def solve_arrays(arrays: LmmArrays, eps: float,
                 device: DeviceLike = None,
                 parallel_rounds: Optional[bool] = None,
                 chunk: Optional[int] = None, layout: str = "auto",
                 chain: str = "auto", pad: str = "pow2"):
    """Run the fixpoint in bounded-round chunks with host-side
    convergence checks between them; returns numpy
    ``(values, remaining, usage, rounds)``.  ``parallel_rounds`` None or
    True runs local rounds, False global rounds.

    ``layout`` and ``chain`` are the JAX package's ``lmm/layout``
    (``auto|coo|ell``) and ``lmm/chain`` (``auto|on|off``), resolved as
    it resolves them with the device in place of its platform
    (``lmm_jax.py:1341-1416``): ``auto`` tries ELL on the card, where
    :func:`~.lmm_ell.ell_from_arrays` accepts the system; the chain runs
    (``on``, or ``auto`` on the card) for an ELL, local, bound-free
    system of at least ``2 * _CHAIN_MIN_V`` variable slots, and a chain
    that overflows or stalls falls back to the dense ELL path.  ``pad``
    is ``lmm/pad``, the ELL row widths (``pow2`` or the exact widths,
    ``tight``; the arrays carry their own lengths).  Uploads
    go through the identity-keyed LRU ``lmm_ell.device_args``, so a
    repeated solve of the same arrays uploads nothing, as in JAX."""
    from . import lmm_ell
    dev = resolve_device(device)
    chained = uses_chain(chain, dev)
    chunk_given = chunk is not None
    global_rounds = parallel_rounds is False
    # decided on the host exactly as lmm_jax.py:1399-1401 decides its
    # static flags: a bound counts only on an enabled variable
    has_bounds = bool(np.any((arrays.v_bound[:arrays.n_var] > 0)
                             & (arrays.v_penalty[:arrays.n_var] > 0)))
    has_fatpipe = bool(np.any(arrays.c_fatpipe[:arrays.n_cnst]))
    ell = (lmm_ell.ell_cached(arrays, pad) if uses_ell(layout, dev)
           else None)
    if chunk is None:
        chunk = chunk_rounds(dev, 0 if ell is not None
                             else len(arrays.e_var))
    what = ("LMM torch solve", f"{arrays.n_cnst} constraints, "
                               f"{arrays.n_var} variables")
    if (ell is not None and ell.vc_w is not None and not global_rounds
            and not has_bounds
            and len(ell.v_penalty) >= 2 * lmm_ell._CHAIN_MIN_V and chained):
        res = lmm_ell.solve_ell_chain(
            ell, eps, dev, has_fatpipe,
            chunk if chunk_given else CHUNK_ROUNDS_ACCEL)
        if res is not None:
            return res
        # overflow/stall: the dense path below re-solves
    if ell is not None:
        values, remaining, usage, rounds = lmm_ell.solve_ell_dense(
            ell, eps, dev, global_rounds, has_bounds, has_fatpipe, chunk,
            what)
    else:
        # the seven arrays, as lmm_jax.py:1433-1436 uploads them
        sys, pen, vb = lmm_ell.device_args(
            "coo", list(arrays[:7]), dev, make=_coo_args)
        w = Work(sys.n_v, sys.n_c, pen.dtype, dev)
        lmm_init(sys, w, pen, eps, has_fatpipe=has_fatpipe)
        values, remaining, usage, rounds = run_chunks(
            sys, w, pen, eps, vb if has_bounds else None, has_bounds,
            has_fatpipe, global_rounds, chunk, what)
    opstats.bump("fixpoint_rounds", rounds)
    return values, remaining, usage, rounds


def check_convergence(rounds: int, n_cnst, n_var) -> None:
    """Raise if a fixpoint hit the round cap."""
    if rounds >= MAX_ROUNDS:
        raise SolveError(
            f"LMM torch solve did not converge within {MAX_ROUNDS} "
            f"saturation rounds ({n_cnst} constraints, {n_var} "
            f"variables); check maxmin/precision vs the system's "
            f"magnitudes")


# ---------------------------------------------------------------------------
# the System backend


def flatten(cnst_list: List[Constraint], dtype=np.float64
            ) -> Optional[Tuple[LmmArrays, List[Variable]]]:
    """Flatten the live portion of a System into padded COO arrays.

    Slot numbering follows the constraint-list iteration order and,
    within each constraint, the enabled-element list order
    (``lmm_jax.py:1099-1152``)."""
    var_slots = {}
    v_penalty: List[float] = []
    v_bound: List[float] = []
    vars_in_order = []
    e_var: List[int] = []
    e_cnst: List[int] = []
    e_w: List[float] = []
    c_bound: List[float] = []
    c_fat: List[bool] = []

    for ci, cnst in enumerate(cnst_list):
        c_bound.append(cnst.bound)
        c_fat.append(cnst.sharing_policy == SharingPolicy.FATPIPE)
        for elem in cnst.enabled_element_set:
            var = elem.variable
            slot = var_slots.get(id(var))
            if slot is None:
                slot = len(v_penalty)
                var_slots[id(var)] = slot
                v_penalty.append(var.sharing_penalty)
                v_bound.append(var.bound)
                vars_in_order.append(var)
            e_var.append(slot)
            e_cnst.append(ci)
            e_w.append(elem.consumption_weight)

    n_e, n_c, n_v = len(e_var), len(c_bound), len(v_penalty)
    if n_c == 0:
        return None
    E, C, V = bucket(max(n_e, 1)), bucket(n_c), bucket(max(n_v, 1))

    arrays = LmmArrays(
        e_var=np.zeros(E, np.int32), e_cnst=np.zeros(E, np.int32),
        e_w=np.zeros(E, dtype), c_bound=np.zeros(C, dtype),
        c_fatpipe=np.zeros(C, bool), v_penalty=np.zeros(V, dtype),
        v_bound=np.full(V, -1.0, dtype), n_elem=n_e, n_cnst=n_c, n_var=n_v)
    arrays.e_var[:n_e] = e_var
    # padding elements point at constraint slot 0 with weight 0: harmless
    arrays.e_cnst[:n_e] = e_cnst
    arrays.e_w[:n_e] = e_w
    arrays.c_bound[:n_c] = c_bound
    arrays.c_fatpipe[:n_c] = c_fat
    arrays.v_penalty[:n_v] = v_penalty
    arrays.v_bound[:n_v] = v_bound
    return arrays, vars_in_order


def solve_flattened(system: System, dtype, solve_flat,
                    allow_device: bool = False,
                    device: DeviceLike = None) -> None:
    """Flatten the System, solve, scatter back (``lmm_jax.py:1519-1599``).

    Mirrors the side effects of System::lmm_solve (maxmin.cpp:487-500):
    values written to variables, modified actions collected for lazy
    model updates, constraint usage left consistent, modified flags
    cleared.  ``solve_flat(arrays, eps) -> (values, remaining, usage)``
    is the solver.  Selective-update systems on the device
    (``allow_device``) are served by the warm solver unless its flags
    say ``warm_start="off"``, which re-flattens the modified subset and
    solves it cold; full-update systems solve the ArrayView's
    snapshot."""
    eps = system.flags.precision

    if system.selective_update_active and allow_device:
        from . import lmm_warm
        if lmm_warm.solve_selective(system, dtype, eps, device):
            return

    if not system.selective_update_active:
        view = system.array_view
        if view is None:
            view = ArrayView(system)
        arrays = view.snapshot(dtype)
        if arrays.n_cnst:
            values, remaining, usage = solve_flat(arrays, eps)
            vals = np.asarray(values).tolist()
            for slot, var in enumerate(view.slot_var):
                if var is not None:
                    var.value = vals[slot]
            rem = np.asarray(remaining).tolist()
            use = np.asarray(usage).tolist()
            for slot, cnst in enumerate(view.slot_cnst):
                if cnst is not None:
                    cnst.remaining = rem[slot]
                    cnst.usage = use[slot]
        system.modified = False
        return

    cnst_list = reset_modified(system)
    flat = flatten(cnst_list, dtype)
    if flat is not None:
        arrays, vars_in_order = flat
        values, remaining, usage = solve_flat(arrays, eps)
        for slot, var in enumerate(vars_in_order):
            var.value = float(values[slot])
        for ci, cnst in enumerate(cnst_list):
            cnst.remaining = float(remaining[ci])
            cnst.usage = float(usage[ci])

    system.modified = False
    system.remove_all_modified_set()


def reset_modified(system: System) -> List[Constraint]:
    """The list solver's selective init pass (maxmin.cpp:509-539) over
    the modified constraints, which it returns: their enabled variables'
    values reset, their actions flagged modified for the lazy model
    (zero-bound constraints' actions too, so the lazy model drops their
    stale completion dates)."""
    cnst_list = list(system.modified_constraint_set)
    for cnst in cnst_list:
        for elem in cnst.enabled_element_set:
            elem.variable.value = 0.0
    if system.modified_actions is not None:
        for cnst in cnst_list:
            for elem in cnst.enabled_element_set:
                if elem.consumption_weight > 0:
                    system.flag_action_modified(elem.variable.id)
    return cnst_list


def solve_torch(system: System, device: DeviceLike = None) -> None:
    """Backend entry: solve the System on the device
    (``lmm_jax.py:1627-1670``).  When a solve on the host CPU does not
    converge, stalls or returns non-finite rates (:class:`SolveError`),
    the exact host list solver redoes it, the carried warm state is
    dropped and ``solver_fallbacks`` counts it; with ``flags.strict``
    the error propagates instead.  On the card it always propagates: a
    failed card solve is never handed to the host."""
    flags = system.flags
    dev = resolve_device(device)
    dtype = np.float32 if flags.dtype == "float32" else np.float64

    def solve_flat(arrays, eps):
        values, remaining, usage, _ = solve_arrays(
            arrays, eps, dev, parallel_rounds=flags.rounds == "local",
            layout=flags.layout, chain=flags.chain)
        if not np.all(np.isfinite(values)):
            raise SolveError(
                "LMM torch solve returned non-finite rates "
                f"({arrays.n_cnst} constraints, {arrays.n_var} variables, "
                f"dtype {np.dtype(dtype).name})")
        return values, remaining, usage

    try:
        solve_flattened(system, dtype, solve_flat, allow_device=True,
                        device=dev)
    except SolveError as exc:
        if flags.strict or dev.type != "cpu":
            raise
        # the host solve happens outside the warm solver: its carried
        # fixpoint state is stale from here on
        if system.warm_solver is not None:
            system.warm_solver.invalidate()
        system.fallback_count += 1
        opstats.bump("solver_fallbacks")
        if system.fallback_count == 1:
            _log.warning("device solve failed (%s); the exact host solver "
                         "takes this solve over, and later fallbacks of "
                         "this System are silent (strict flags restore "
                         "the error)", exc)
        system.solve_exact()


def _count_live_vars(system: System) -> int:
    n = 0
    for var in system.variable_set:
        if var.sharing_penalty <= 0:
            break  # enabled vars are kept at the list head
        n += 1
    return n


def dispatching_solve(system: System, device: DeviceLike = None) -> None:
    """The ``auto`` backend: the exact host list solver for small live
    sets, the device above ``flags.threshold`` live variables."""
    if _count_live_vars(system) >= system.flags.threshold:
        solve_torch(system, device)
    else:
        system.solve_exact()


def install(system: System, flags: Optional[LmmFlags] = None,
            device: DeviceLike = None) -> System:
    """Attach the solver backend that ``flags`` (or the System's own
    flags) name.  The device backends run on the card; without one they
    raise unless ``device="cpu"`` asks for the plain PyTorch path."""
    if flags is not None:
        system.flags = flags
    backend = system.flags.backend
    if backend == "list":
        system.solve_fn = None
        return system
    dev = resolve_device(device)
    fn = solve_torch if backend == "torch" else dispatching_solve
    system.solve_fn = functools.partial(fn, device=dev)
    return system
