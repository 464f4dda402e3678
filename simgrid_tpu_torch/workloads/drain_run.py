"""Timed runs of a generated system: the port's main paths, as both
``chip_smoke.py`` and ``tools/torch_e2e_drain.py`` drive them.

* ``make_sim`` builds the ``DrainSim``; ``run_drain`` builds one, zeroes
  the kernels' launch counts, drains it with a host clock around
  ``run()`` (ending in a device sync on CUDA), checks that every flow
  completed exactly once at non-decreasing times, and returns the drain
  with its row of counters, wall seconds and launch counts.
* ``run_solve`` times one ``solve_arrays`` of the system (the BASELINE's
  "LMM solve ms @ 100k concurrent flows").
* ``run_engine_plan`` drives the drain the way the engine's fast path
  drives its plan (``simgrid_tpu/ops/drain_path.py``): a seeded 1% of
  flows still in their latency phase (penalty 0, bounded), one
  superstep, one transition batch, one partial advance, then the drain
  to its end, or for ``max_advances`` more advances (a cut of depth).
  ``engine_plan`` is that sequence on any executor with the
  ``DrainSim`` calls, so a test can hold the JAX package's to it too.
* ``held_step`` runs one superstep of a drain and the same superstep
  from a handover of its state to the plain path on the CPU, and raises
  unless the two agree; ``run_engine_plan_held`` drives
  the engine plan to its end with such windows after the partial
  advance and after each repack.

A system carrying LV08 penalties and bounds (``v_penalty``) drains as
the engine plans it: absolute retirement at ``maxmin/precision *
surf/precision`` (``drain_path.py:307-310``).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels import path_counts, reset_launch_counts
from ..kernels import superstep_loop as k16
from ..ops.lmm_arrays import LmmArrays
from ..ops.lmm_drain import DrainSim
from ..ops.lmm_torch import solve_arrays
from .dragonfly import BANDWIDTH, BW_FACTOR, Dragonfly

EPS = 1e-5
DONE_EPS = 1e-4
#: the engine plan's absolute retirement threshold (maxmin/precision *
#: surf/precision, both 1e-5 by default)
ENGINE_DONE_EPS = 1e-5 * 1e-5
SUPERSTEP = 16


def make_sim(system, *, device: DeviceLike = None, dtype=np.float64,
             done_mode: Optional[str] = None, **kw) -> DrainSim:
    """A DrainSim of ``system`` (anything with e_var, e_cnst, e_w,
    c_bound, sizes, and optionally v_penalty and v_bound), solve eps
    1e-5; relative retirement at 1e-4 of the size, or for a system with
    LV08 penalties the engine plan's absolute rule.  ``kw`` passes on
    the executor shape (``superstep=K`` or ``fused=True``) and any other
    constructor argument."""
    dtype = np.dtype(dtype)
    lv08 = getattr(system, "v_penalty", None) is not None
    if lv08:
        kw.setdefault("penalty", system.v_penalty.astype(dtype))
        kw.setdefault("v_bound", system.v_bound.astype(dtype))
    if done_mode is None:
        done_mode = "abs" if lv08 else "rel"
    kw.setdefault("done_eps", ENGINE_DONE_EPS if done_mode == "abs"
                  else DONE_EPS)
    return DrainSim(system.e_var, system.e_cnst,
                    system.e_w.astype(dtype), system.c_bound.astype(dtype),
                    system.sizes, eps=EPS, done_mode=done_mode, dtype=dtype,
                    device=device, **kw)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_events(events: List[Tuple[float, int]], n_v: int,
                 live: Optional[np.ndarray] = None) -> None:
    """Raise AssertionError unless every flow completed exactly once at
    non-decreasing event times; with ``live`` (the flow ids still
    draining after a cut), every flow either completed once or is live,
    never both."""
    ids = np.fromiter((f for _, f in events), np.int64, len(events))
    if live is not None:
        ids = np.concatenate([ids, np.asarray(live, np.int64)])
    if not np.array_equal(np.sort(ids), np.arange(n_v)):
        raise AssertionError("not every flow completed exactly once")
    times = np.fromiter((t for t, _ in events), np.float64, len(events))
    if np.any(np.diff(times) < 0):
        raise AssertionError("event times decrease")


def _row(sim: DrainSim, system, wall: float) -> dict:
    return dict(flows=len(system.sizes), n_cnst=len(system.c_bound),
                n_elem=len(system.e_var), advances=sim.advances,
                rounds=sim.rounds, supersteps=sim.supersteps,
                loop_builds=sim.loop_builds, syncs=sim.syncs,
                repacks=sim.repacks, pipeline=sim.pipeline,
                spec_issued=sim.spec_issued,
                spec_committed=sim.spec_committed,
                spec_rolled_back=sim.spec_rolled_back,
                wall_s=wall, t_sim=sim.t)


def run_drain(system, **kw) -> Tuple[DrainSim, dict]:
    """Drain ``system`` once (arguments as ``make_sim``); raises
    AssertionError unless every flow completed exactly once at
    non-decreasing event times."""
    sim = make_sim(system, **kw)
    _sync(sim.device)
    reset_launch_counts()
    t0 = time.perf_counter()
    sim.run()
    _sync(sim.device)
    wall = time.perf_counter() - t0
    counts = path_counts()
    loop = k16.summary()
    check_events(sim.events, len(system.sizes))
    return sim, dict(_row(sim, system, wall), launches=counts, loop=loop)


def solve_inputs(system, dtype=np.float64) -> LmmArrays:
    """The flattened system ``solve_arrays`` takes: no FATPIPE link,
    unit penalties and no bounds unless the system carries LV08 ones."""
    dtype = np.dtype(dtype)
    V, C, E = len(system.sizes), len(system.c_bound), len(system.e_var)
    pen = getattr(system, "v_penalty", None)
    vb = getattr(system, "v_bound", None)
    return LmmArrays(
        np.asarray(system.e_var, np.int32),
        np.asarray(system.e_cnst, np.int32), system.e_w.astype(dtype),
        system.c_bound.astype(dtype), np.zeros(C, bool),
        (np.ones(V) if pen is None else pen).astype(dtype),
        (np.full(V, -1.0) if vb is None else vb).astype(dtype), E, C, V)


def run_solve(system, device: DeviceLike = None, dtype=np.float64,
              parallel_rounds: Optional[bool] = None, layout: str = "auto"):
    """One timed ``solve_arrays(arrays, 1e-5)`` of ``system`` (a
    generated system, or flattened ``LmmArrays`` as they are; local
    rounds by default), host clock around it, the kernels' launch counts
    zeroed before.  ``layout`` is ``solve_arrays``'s: with ``auto`` the
    ELL caps refuse config #4's systems (rows of 862 and 1,272
    elements), so they solve in COO as in the JAX package.  Returns
    ``(values, row)``."""
    arrays = (system if isinstance(system, LmmArrays)
              else solve_inputs(system, dtype))
    dev = resolve_device(device)
    _sync(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    values, _, _, rounds = solve_arrays(arrays, EPS, device=dev,
                                        parallel_rounds=parallel_rounds,
                                        layout=layout)
    _sync(dev)
    wall = time.perf_counter() - t0
    return values, dict(flows=arrays.n_var, n_cnst=arrays.n_cnst,
                        n_elem=arrays.n_elem, rounds=rounds, wall_s=wall,
                        launches=path_counts(), loop=k16.summary())


# ---------------------------------------------------------------------------
# the engine plan


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def plan_setup(system, seed: int = 7):
    """The plan's inputs: each flow's LV08 penalty, except a seeded 1%
    of flows still in their latency phase (penalty 0: invisible lanes,
    as ``drain_path.py:61-64, 294-297`` builds them), and every flow's
    LV08 bound.  Returns ``(constructor kwargs, latency flow ids)``."""
    V = len(system.sizes)
    lat = np.sort(np.random.default_rng(seed).choice(
        V, max(1, V // 100), replace=False))
    pen = system.v_penalty.copy()
    pen[lat] = 0.0
    return dict(penalty=pen, v_bound=system.v_bound.copy(), eps=EPS,
                done_mode="abs", done_eps=ENGINE_DONE_EPS,
                dtype=np.float64, superstep=SUPERSTEP), lat


def engine_plan(sim, system, lat: np.ndarray, seed: int = 7,
                max_advances: Optional[int] = None) -> dict:
    """One superstep; then, with the rates it leaves, one transition
    batch: a seeded 1% of live flows get a new bound (their rate times
    U(0.5, 1.5), so about half bind), a seeded 1% of links a new
    capacity (``0.97 x`` a bandwidth of U(0.5, 1) times the link's,
    as ``set_bandwidth`` installs it), and the latency flows wake to
    their LV08 penalty; one partial advance by half the next dt; the
    drain to its end, or ``max_advances`` more advances.  Returns the
    events on the engine's clock (the partial advance's delta added
    after it), the ids of the flows still live, and the steps'
    counts."""
    rng = np.random.default_rng(seed + 1)
    sim.superstep_batch()
    ids = np.asarray(sim._host_ids())
    slot_of = np.full(len(system.sizes), -1, np.int64)
    slot_of[ids] = np.arange(len(ids))
    lat_slots = slot_of[lat]
    if np.any(lat_slots < 0):
        raise AssertionError("a latency lane left the plan before its wake")
    rates = np.asarray(sim.solve_rates())
    live = np.flatnonzero(_np(sim._pen) > 0)
    bslots = np.sort(rng.choice(live, max(1, len(live) // 100),
                                replace=False))
    C = len(system.c_bound)
    cslots = np.sort(rng.choice(C, max(1, C // 100), replace=False))
    link_bw = BANDWIDTH * Dragonfly().link_count(
        system.link_ids[cslots]).astype(np.float64)
    n = sim.apply_transitions({
        "v_bound": (bslots, rates[bslots]
                    * rng.uniform(0.5, 1.5, len(bslots))),
        "c_bound": (cslots, BW_FACTOR
                    * (link_bw * rng.uniform(0.5, 1.0, len(cslots)))),
        "v_penalty": (lat_slots, system.v_penalty[lat]),
    })
    rates2 = np.asarray(sim.solve_rates())
    pen, rem = _np(sim._pen), _np(sim._rem)
    flowing = (pen > 0) & (rates2 > 0)
    delta = float(np.min(rem[flowing] / rates2[flowing])) / 2
    done, n_live = sim.partial_advance(delta)
    t_part = sim.t
    k = len(sim.events)
    done_ids = ids[np.asarray(done, np.int64)]
    if max_advances is None:
        sim.run()
    else:
        sim.run(max_advances=max_advances)
    events = (list(sim.events[:k])
              + [(t_part + delta, int(f)) for f in done_ids]
              + [(t + delta, f) for t, f in sim.events[k:]])
    live = np.asarray(sim._host_ids())[_np(sim._pen) > 0]
    return dict(events=events, live=live, transition_slots=n, delta=delta,
                partial_done=len(done_ids), partial_live=n_live,
                t_engine=sim.t + delta)


def run_engine_plan(system, device: DeviceLike = None, seed: int = 7,
                    max_advances: Optional[int] = None, **kw
                    ) -> Tuple[DrainSim, dict, List[Tuple[float, int]]]:
    """Build the engine plan of an LV08 ``system`` and drive it with
    ``engine_plan`` (to the end, or ``max_advances`` advances past the
    partial advance), host clock around the whole sequence; ``kw``
    overrides constructor arguments (``repack_min``).  Returns the
    drain, its row and the events on the engine's clock; raises
    AssertionError unless every flow completed exactly once (plan
    events and partial-advance retirements together) or, after a cut,
    is still live, at non-decreasing times."""
    plan_kw, lat = plan_setup(system, seed)
    kw = {**plan_kw, **kw}
    sim = DrainSim(system.e_var, system.e_cnst, system.e_w, system.c_bound,
                   system.sizes, device=device, **kw)
    _sync(sim.device)
    reset_launch_counts()
    t0 = time.perf_counter()
    out = engine_plan(sim, system, lat, seed, max_advances)
    _sync(sim.device)
    wall = time.perf_counter() - t0
    counts = path_counts()
    loop = k16.summary()
    events, live = out.pop("events"), out.pop("live")
    if max_advances is None and len(live):
        raise AssertionError("the drain ended with live flows")
    check_events(events, len(system.sizes), live)
    row = dict(_row(sim, system, wall), launches=counts, loop=loop,
               latency_lanes=len(lat), completed=len(events),
               live_left=len(live), **out)
    return sim, row, events


# ---------------------------------------------------------------------------
# windows held against another device


def held_step(sim: DrainSim, k: Optional[int] = None) -> Tuple[int, dict]:
    """One ``superstep_step(k)`` of ``sim``, and the same step from a
    handover of the same state (through ``convert``) to the plain path
    on the CPU: raises AssertionError unless events, clock, advances,
    penalties and remains are equal.  Returns the live count and the
    window's row."""
    from ..convert import port_drain_state, resume_drain
    other = resume_drain(
        port_drain_state(sim), device="cpu", eps=sim.eps,
        done_eps=sim.done_eps, done_mode=sim.done_mode, dtype=sim.dtype,
        solve_chunk=sim.solve_chunk, repack_at=sim.repack_at,
        repack_min=sim.repack_min, fused=sim.fused,
        superstep=sim.superstep_k, superstep_rounds=sim.superstep_rounds)
    adv0, ev0 = sim.advances, len(sim.events)
    t0 = time.perf_counter()
    n = sim.superstep_step(k)
    _sync(sim.device)
    t1 = time.perf_counter()
    n_other = other.superstep_step(k)
    t2 = time.perf_counter()
    equal = (n == n_other and sim.events == other.events
             and sim.t == other.t and sim.advances == other.advances
             and np.array_equal(_np(sim._pen), _np(other._pen))
             and np.array_equal(_np(sim._rem), _np(other._rem)))
    if not equal:
        raise AssertionError(f"advances {adv0}-{sim.advances}: the drain "
                             "and the plain path on the CPU differ")
    return n, dict(from_advance=adv0, advances=sim.advances - adv0,
                   events=len(sim.events) - ev0, repacks=sim.repacks,
                   wall_s=t1 - t0, cpu_wall_s=t2 - t1)


def run_engine_plan_held(system, device: DeviceLike = None,
                         **kw) -> Tuple[DrainSim, List[dict]]:
    """``run_engine_plan``'s sequence again, to its end, held against
    the plain path on the CPU in windows: the first superstep after the
    partial advance and the first after each repack (``held_step``).
    Returns the drain and the windows' rows."""
    plan_kw, lat = plan_setup(system)
    sim = DrainSim(system.e_var, system.e_cnst, system.e_w, system.c_bound,
                   system.sizes, device=device, **{**plan_kw, **kw})
    engine_plan(sim, system, lat, max_advances=0)
    windows, n, seen = [], 1, None
    while n:
        if sim.repacks != seen:
            seen = sim.repacks
            n, row = held_step(sim)
            windows.append(row)
        else:
            n = sim.superstep_step()
    return sim, windows
