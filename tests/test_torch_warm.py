"""The port's warm-started selective solve (simgrid_tpu_torch.ops.lmm_warm,
K5's delta scatter, K6) against the JAX package's (ops/lmm_warm.py), on
the CPU.

Both packages' selective Systems are built and mutated through the same
seeded calls (the churn of ``bench.py``'s churn stage, the churn of
tests/test_lmm_warm.py, the Lazy-mode LV08 alltoall); after every solve
the host state (every variable's value, every constraint's remaining
and usage) must be equal bit for bit (compared as float64 bit patterns,
so -0.0 is not 0.0), and so must the warm solver's counters.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import simgrid_tpu.ops.lmm_warm as jwarm
from simgrid_tpu.ops import lmm_jax
from simgrid_tpu.ops import make_new_maxmin_system as jax_system
from simgrid_tpu.ops import opstats as jstats
from simgrid_tpu.utils.config import config
from simgrid_tpu_torch import convert
from simgrid_tpu_torch.kernels import warm_init as k6
from simgrid_tpu_torch.kernels.common import IT
from simgrid_tpu_torch.kernels.transition_scatter import (
    DELTA_FIELDS, TRANSITION_FIELDS, delta_scatter, ell_delta_scatter,
    transition_scatter)
from simgrid_tpu_torch.ops import lmm_torch, lmm_warm
from simgrid_tpu_torch.ops import opstats as pstats
from simgrid_tpu_torch.ops.lmm_arrays import bucket
from simgrid_tpu_torch.ops.lmm_host import LmmFlags, make_new_maxmin_system
from simgrid_tpu_torch.workloads import churn, lazy_alltoall

EPS = 1e-5


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = {k: config[k] for k in
             ("lmm/warm-start", "lmm/delta-upload", "lmm/dtype",
              "lmm/rounds", "lmm/layout", "lmm/strict")}
    yield
    for k, v in saved.items():
        config[k] = v


def port_system(**flags):
    s = make_new_maxmin_system(True, LmmFlags(**{"backend": "torch",
                                                 **flags}))
    return lmm_torch.install(s, device="cpu")


def jax_solver_system(warm_start="on", delta_upload="on", rounds="local"):
    config["lmm/warm-start"] = warm_start
    config["lmm/delta-upload"] = delta_upload
    config["lmm/rounds"] = rounds
    s = jax_system(True)
    s.solve_fn = lmm_jax.solve_jax
    return s


def host_state(s):
    """The host state as float64 bit patterns: ``==`` on them is
    equality bit for bit (-0.0 differs from 0.0, a NaN equals itself)."""
    return tuple(a.view(np.int64).tolist() for a in churn.host_state(s))


def bits(t):
    t = t if torch.is_tensor(t) else torch.from_numpy(np.array(t))
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


# ---------------------------------------------------------------------------
# K5 and K6, plain versions against the JAX programs


def random_masters(rng, E=256, C=32, V=64, dtype=np.float64):
    return [rng.integers(0, V, E).astype(np.int32),
            rng.integers(0, C, E).astype(np.int32),
            rng.choice([0.0, 0.5, 1.0], E).astype(dtype),
            rng.uniform(1, 10, C).astype(dtype), rng.random(C) < 0.3,
            rng.choice([0.0, 1.0, 2.0], V).astype(dtype),
            np.where(rng.random(V) < 0.3, 2.0, -1.0).astype(dtype)]


def padded_payload(rng, masters, fields):
    """Runs padded as the JAX warm solver pads them: bucket(n, 8) slots,
    the tail repeating the first (index, value) pair."""
    layout, chunks, off = [], [], 0
    for f in fields:
        fi = DELTA_FIELDS.index(f)
        n_slots = len(masters[fi])
        ix = np.sort(rng.choice(n_slots, int(rng.integers(1, 12)),
                                replace=False))
        if f == "c_fatpipe":
            src = rng.random(len(ix)) < 0.5
        elif f in ("e_var", "e_cnst"):
            src = rng.integers(0, 30, len(ix))
        else:
            src = rng.uniform(-1, 5, len(ix))
        n = bucket(len(ix), floor=8)
        idx = np.full(n, ix[0], np.float64)
        vals = np.full(n, float(src[0]))
        idx[:len(ix)] = ix
        vals[:len(ix)] = src
        layout.append((fi, off, n))
        chunks += [idx, vals]
        off += 2 * n
    return np.concatenate(chunks), layout


@pytest.mark.parametrize("fields", [("c_fatpipe",), DELTA_FIELDS],
                         ids=["bool", "seven"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_delta_scatter_plain_equals_apply_deltas(fields, dtype):
    rng = np.random.default_rng(3)
    masters = random_masters(rng, dtype=dtype)
    payload, layout = padded_payload(rng, masters, fields)
    want = jwarm._apply_deltas(payload, *masters, layout=tuple(layout))
    got = [torch.from_numpy(m.copy()) for m in masters]
    assert delta_scatter(torch.from_numpy(payload), layout, got) is True
    for g, w in zip(got, want):
        assert torch.equal(bits(g), bits(np.asarray(w)))


def capture_warm(monkeypatch, s):
    """Record the JAX warm solver's next ``_warm_init`` call (its
    masters, carry and arguments) and the chunk result it leads to."""
    seen = {}
    orig_init, orig_run = jwarm._warm_init, jwarm.WarmSolver._run_chunks

    def init(*args, **kw):
        st = s.warm_solver._states[np.dtype(np.float64)]
        seen.update(masters=[np.asarray(m) for m in st.masters],
                    carry=[np.asarray(c) for c in st.carry],
                    mc=np.asarray(args[9]), eps=kw["eps"])
        out = orig_init(*args, **kw)
        seen["out"] = [np.asarray(x) for x in out]
        return out

    def run(self, *args, **kw):
        out = orig_run(self, *args, **kw)
        if "out" in seen and "result" not in seen:
            seen["result"] = out[:4]
        return out
    monkeypatch.setattr(jwarm, "_warm_init", init)
    monkeypatch.setattr(jwarm.WarmSolver, "_run_chunks", run)
    return seen


def build_lmm_warm(s, seed, n_clusters=8, per_cluster=6, chain=24):
    """tests/test_lmm_warm.py's ``_build``: a deep saturation chain plus
    independent clusters the churn touches."""
    rng = np.random.default_rng(seed)
    cs = [s.constraint_new(None, float(2.0 ** i)) for i in range(chain)]
    for i in range(chain - 1):
        v = s.variable_new(None, 1, -1, 2)
        s.expand(cs[i], v, 1)
        s.expand(cs[i + 1], v, 1)
    clusters = [s.constraint_new(None, float(rng.uniform(5, 20)))
                for _ in range(n_clusters)]
    flows = {k: [] for k in range(n_clusters)}
    for k in range(n_clusters):
        for _ in range(per_cluster):
            v = s.variable_new(None, 1.0)
            s.expand(clusters[k], v, float(rng.choice([0.5, 1.0, 2.0])))
            flows[k].append(v)
    return s, clusters, flows, rng


def churn_lmm_warm(s, clusters, flows, rng, step):
    """tests/test_lmm_warm.py's ``_churn``: retire and replace a flow,
    and periodic constraint and variable bound updates."""
    k = int(rng.integers(len(clusters)))
    if flows[k]:
        s.variable_free(flows[k].pop(0))
    v = s.variable_new(None, float(rng.choice([0.5, 1.0])))
    s.expand(clusters[k], v, float(rng.choice([1.0, 2.0])))
    flows[k].append(v)
    if step % 3 == 0:
        s.update_constraint_bound(clusters[k], float(rng.uniform(5, 20)))
    if step % 5 == 0 and flows[k]:
        s.update_variable_bound(flows[k][-1], float(rng.uniform(0.1, 3.0)))


def test_warm_init_and_warm_solve_from_jax_state(monkeypatch):
    """K6's plain version from the JAX warm solver's own resident state
    (handed across by ``convert.port_warm_state``) equals ``_warm_init``
    bit for bit, and K1's rounds from there equal the JAX warm solve."""
    s, clusters, flows, rng = build_lmm_warm(jax_solver_system(), 42)
    s.solve()
    seen = capture_warm(monkeypatch, s)
    churn_lmm_warm(s, clusters, flows, rng, 0)    # bounds move too
    s.solve()
    assert s.warm_solver.last_mode == "warm" and "result" in seen
    st = convert.port_warm_state(seen["masters"], seen["carry"],
                                 np.float64, "cpu")
    pen = st.masters[5]
    mc = torch.from_numpy(np.array(seen["mc"]))
    assert k6.warm_init(st.sys, st.work, pen, mc, seen["eps"]) is True
    w = st.work
    for name, want in zip(("v_value", "v_fixed", "remaining", "usage",
                           "light"), seen["out"][:5]):
        assert torch.equal(bits(getattr(w, name)), bits(want)), name
    assert int(w.ctrl[IT]) == int(seen["out"][5]) == 0

    view = s.array_view
    has_bounds = bool(np.any((view.v_bound > 0) & (view.v_penalty > 0)))
    values, remaining, usage, rounds = lmm_torch.run_chunks(
        st.sys, w, pen, seen["eps"], st.masters[6], has_bounds,
        bool(view.c_fatpipe.any()), False, 4096, ("test", "test"))
    jv, jr, ju, jrounds = seen["result"]
    assert rounds == jrounds
    for a, b in ((values, jv), (remaining, jr), (usage, ju)):
        assert np.array_equal(bits(a), bits(b))


# ---------------------------------------------------------------------------
# whole solves against JAX


def step_counters(stats_mod, before, ws):
    d = stats_mod.diff(before)
    return (int(d.get("fixpoint_rounds", 0)),
            int(d.get("uploaded_bytes_full", 0)),
            int(d.get("uploaded_bytes_delta", 0)),
            None if ws is None else (ws.last_mode, ws.last_rounds,
                                     ws.last_dirty_slots, ws.warm_solves,
                                     ws.cold_solves))


def drive_both(port, jax, step_fn, n_steps):
    """Solve both Systems, then apply ``step_fn(side_index, system)``
    and solve again ``n_steps`` times; compare host states and warm
    counters after every solve."""
    for step in range(n_steps + 1):
        if step:
            step_fn(0, port)
            step_fn(1, jax)
        pb, jb = pstats.snapshot(), jstats.snapshot()
        port.solve()
        jax.solve()
        assert host_state(port) == host_state(jax), f"step {step}"
        pc = step_counters(pstats, pb, port.warm_solver)
        jc = step_counters(jstats, jb, jax.warm_solver)
        assert pc == jc, f"step {step}"


@pytest.mark.parametrize("rounds", ["local", "global"])
@pytest.mark.parametrize("mode", list(churn.MODES))
def test_churn_modes_equal_jax(mode, rounds):
    """bench.py's churn stage at a small size in every mode: states,
    rounds, upload bytes (full and delta), dirty slots and warm/cold
    counts equal JAX ``solve_jax`` at every step."""
    warm_start, delta_upload = churn.MODES[mode]
    port = port_system(warm_start=warm_start, delta_upload=delta_upload,
                       rounds=rounds)
    jax = jax_solver_system(warm_start, delta_upload, rounds)
    n_v, clusters, chain, steps = 1200, 24, 10, 4
    rngs = [np.random.default_rng(42), np.random.default_rng(42)]
    built = [churn.build(s, r, n_v, clusters, chain)
             for s, r in zip((port, jax), rngs)]
    churn_n = max(1, int((n_v - chain + 1) * 0.02))

    def step(i, s):
        churn.churn_step(s, rngs[i], *built[i], churn_n)
    drive_both(port, jax, step, steps)
    if mode == "warm-selective":
        assert port.warm_solver.warm_solves == steps


@pytest.mark.parametrize("rounds", ["local", "global"])
def test_warm_equals_cold_and_jax(rounds):
    """tests/test_lmm_warm.py's warm == cold contract on the port (with
    bound updates, slot recycling), each step also equal to JAX's warm
    run; warm rounds are at most a fifth of cold rounds."""
    cold = build_lmm_warm(port_system(warm_start="cold", rounds=rounds), 42)
    warm = build_lmm_warm(port_system(warm_start="on", rounds=rounds), 42)
    jax = build_lmm_warm(jax_solver_system("on", "on", rounds), 42)
    r_cold, r_warm = [], []
    for step in range(16):
        for s, clusters, flows, rng in (cold, warm, jax):
            churn_lmm_warm(s, clusters, flows, rng, step)
            s.solve()
        assert host_state(warm[0]) == host_state(cold[0]) == \
            host_state(jax[0]), f"step {step}"
        pw, jw = warm[0].warm_solver, jax[0].warm_solver
        assert (pw.last_mode, pw.last_rounds, pw.last_dirty_slots,
                pw.last_upload_bytes) == \
            (jw.last_mode, jw.last_rounds, jw.last_dirty_slots,
             jw.last_upload_bytes)
        r_cold.append(cold[0].warm_solver.last_rounds)
        r_warm.append(pw.last_rounds)
    assert warm[0].warm_solver.warm_solves >= 12
    assert sum(r_warm[1:]) * 5 <= sum(r_cold[1:]), (r_cold, r_warm)


def test_compaction_recycling_and_dtype_alternation():
    """tests/test_lmm_warm.py's carry-invalidation case: forced
    compaction (layout epoch), recycled variable slots and f64/f32
    alternation (a master set and carry per dtype); the port's warm run
    equals its cold run and the JAX warm run at every step."""
    def build(s, seed):
        rng = np.random.default_rng(seed)
        cs = [s.constraint_new(None, float(rng.uniform(5, 50)))
              for _ in range(12)]
        flows = []
        for _ in range(40):
            v = s.variable_new(None, 1.0, -1.0, 2)
            for k in rng.choice(12, size=2, replace=False):
                s.expand(cs[int(k)], v, float(rng.choice([0.5, 1.0, 2.0])))
            flows.append(v)
        return s, cs, flows, rng

    cold = build(port_system(warm_start="cold"), 7)
    warm = build(port_system(warm_start="on"), 7)
    jax = build(jax_solver_system("on", "on"), 7)
    dts = ["float64", "float32"]
    for step in range(24):
        for (s, cs, flows, rng) in (cold, warm, jax):
            for _ in range(3):
                if flows and rng.random() < 0.5:
                    s.variable_free(flows.pop(int(rng.integers(len(flows)))))
                else:
                    v = s.variable_new(None, float(rng.choice([0.5, 1.0])))
                    s.expand(cs[int(rng.integers(12))], v, 1.0)
                    flows.append(v)
            if step % 4 == 0:
                s.update_constraint_bound(cs[int(rng.integers(12))],
                                          float(rng.uniform(5, 50)))
            if step % 7 == 0 and s.array_view is not None:
                s.array_view._compact()
        for s in (cold[0], warm[0]):
            s.flags = dataclasses.replace(s.flags, dtype=dts[step % 2])
        config["lmm/dtype"] = dts[step % 2]
        for s in (cold[0], warm[0], jax[0]):
            s.solve()
        assert host_state(warm[0]) == host_state(cold[0]) == \
            host_state(jax[0]), f"step {step}"
        pw, jw = warm[0].warm_solver, jax[0].warm_solver
        assert (pw.warm_solves, pw.cold_solves, pw.last_dirty_slots) == \
            (jw.warm_solves, jw.cold_solves, jw.last_dirty_slots)
    assert warm[0].warm_solver.warm_solves > 0


def test_lazy_alltoall_sequence_equals_jax():
    """The Lazy-mode LV08 alltoall at 16 ranks: the System built through
    ``communicate``'s calls, then the latency ends, a retirement and a
    bandwidth change, each solved; equal to JAX's System with
    ``solve_jax`` after every solve, warm and cold alike."""
    config["lmm/warm-start"] = config["lmm/delta-upload"] = "auto"
    a2a = lazy_alltoall.alltoall(16)
    port = port_system()
    jax = jax_system(True)
    jax.solve_fn = lmm_jax.solve_jax
    seqs = [lazy_alltoall.solve_sequence(s, a2a,
                                         *lazy_alltoall.build(s, a2a))
            for s in (port, jax)]
    labels = []
    pb, jb = pstats.snapshot(), jstats.snapshot()
    for (lp, _), (lj, _) in zip(*seqs):
        assert lp == lj
        labels.append(lp)
        assert host_state(port) == host_state(jax), lp
        pw, jw = port.warm_solver, jax.warm_solver
        assert (pw.last_mode, pw.last_rounds, pw.last_dirty_slots,
                pw.last_upload_bytes) == \
            (jw.last_mode, jw.last_rounds, jw.last_dirty_slots,
             jw.last_upload_bytes), lp
    assert labels[0] == "first" and labels[-2:] == ["retire", "bandwidth"]
    assert port.warm_solver.warm_solves > 0
    for name in ("warm_solves", "cold_solves", "warm_bound_restarts",
                 "uploaded_bytes_full", "uploaded_bytes_delta"):
        assert pstats.diff(pb).get(name, 0) == jstats.diff(jb).get(name, 0)
    assert pstats.diff(pb).get("warm_bound_restarts", 0) == 0


# ---------------------------------------------------------------------------
# the host fallback


def churned(**flags):
    s, clusters, flows, rng = build_lmm_warm(port_system(**flags), 9,
                                             chain=4)
    s.solve()
    churn_lmm_warm(s, clusters, flows, rng, 1)
    return s, clusters, flows, rng


def stalled_rounds(monkeypatch):
    """K1's rounds made to do nothing: the solve stalls, and the port's
    stall check raises its SolveError."""
    monkeypatch.setattr(lmm_torch, "lmm_round", lambda *a, **k: True)


def test_solve_error_falls_back_and_invalidates(monkeypatch):
    s, clusters, flows, rng = churned()
    twin = build_lmm_warm(port_system(backend="list"), 9, chain=4)
    twin[0].solve()
    churn_lmm_warm(*twin, 1)
    ws = s.warm_solver
    assert all(st.work.carry_valid for st in ws._states.values())
    before = pstats.snapshot()
    with monkeypatch.context() as m:
        stalled_rounds(m)
        s.solve()
    twin[0].solve()
    assert host_state(s) == host_state(twin[0])
    assert pstats.diff(before).get("solver_fallbacks") == 1
    assert s.fallback_count == 1
    # the failed solve poisoned the carry before it raised
    assert not any(st.work.carry_valid for st in ws._states.values())
    churn_lmm_warm(s, clusters, flows, rng, 2)
    s.solve()
    assert ws.last_mode == "cold"          # no stale carry reused
    churn_lmm_warm(s, clusters, flows, rng, 4)
    s.solve()
    assert ws.last_mode == "warm"          # carry re-established
    ws.invalidate()                        # what the fallback calls
    assert ws.carry_invalidations == 1
    churn_lmm_warm(s, clusters, flows, rng, 7)
    s.solve()
    assert ws.last_mode == "cold"


def test_strict_solve_error_raises(monkeypatch):
    s, *_ = churned(strict=True)
    stalled_rounds(monkeypatch)
    with pytest.raises(lmm_torch.SolveError, match="stalled"):
        s.solve()
    assert s.fallback_count == 0
    assert not any(st.work.carry_valid
                   for st in s.warm_solver._states.values())


def test_kernel_error_is_not_swallowed(monkeypatch):
    """A plain RuntimeError (what a failed kernel launch or build
    raises) from K6 propagates: no fallback, no count."""
    s, *_ = churned()

    def launch_failed(*args, **kw):
        raise RuntimeError("CUDA kernel warm_init failed to launch")
    monkeypatch.setattr(k6, "warm_init_plain", launch_failed)
    before = pstats.snapshot()
    with pytest.raises(RuntimeError, match="failed to launch") as exc:
        s.solve()
    assert type(exc.value) is RuntimeError
    assert "solver_fallbacks" not in pstats.diff(before)
    assert s.fallback_count == 0


def shared_links(s, n_c=200, n_v=2000, seed=5):
    """Flows over three random links each: fair shares close enough
    that the solve's precision shows in its result."""
    rng = np.random.default_rng(seed)
    cs = [s.constraint_new(None, float(rng.uniform(50, 200)))
          for _ in range(n_c)]
    for _ in range(n_v):
        v = s.variable_new(None, 1.0)
        for c in rng.choice(n_c, 3, replace=False):
            s.expand(cs[int(c)], v, float(rng.choice([0.5, 1.0, 2.0])))
    return cs


@pytest.mark.parametrize("layout", ["coo", "ell"])
def test_warm_state_solved_at_a_new_precision_equals_jax(layout):
    """The same warm state solved again at another maxmin/precision (a
    cold init on the same work buffers, whose chunk loop bakes eps in):
    every state and counter equals JAX's, and the new precision shows."""
    saved = config["maxmin/precision"]
    config["lmm/layout"] = layout
    try:
        port = port_system(warm_start="on", delta_upload="on",
                           layout=layout)
        jax = jax_solver_system("on", "on")
        built = [shared_links(s) for s in (port, jax)]
        kept = port_system(warm_start="on", delta_upload="on",
                           layout=layout)
        kept_cs = shared_links(kept)
        config["maxmin/precision"] = EPS

        def step(i, s):
            s.update_constraint_bound(built[i][7], 120.0)
            if i == 0:
                s.flags = dataclasses.replace(s.flags, precision=0.3)
            else:
                config["maxmin/precision"] = 0.3
        drive_both(port, jax, step, 1)
        kept.solve()
        kept.update_constraint_bound(kept_cs[7], 120.0)
        kept.solve()
        assert host_state(kept) != host_state(port)
    finally:
        config["maxmin/precision"] = saved


def clone_work(w):
    """A copy of a fixpoint state whose tensors are its own."""
    c = copy.copy(w)
    for n, t in vars(w).items():
        if torch.is_tensor(t):
            setattr(c, n, t.clone())
    return c


def record_k6_call(monkeypatch, layout):
    """Spy on the port warm solver's next K6 call (COO or ELL): the
    modified constraints as the solver listed them (``raw``), the index
    ``modified_index`` built from them, the index K6 got, and K6's
    arguments with a copy of the state it started from."""
    seen = {}
    orig_index = lmm_warm.modified_index

    def index(mc):
        seen["raw"] = np.array(mc)
        out = orig_index(mc)
        seen["index"] = out.copy()
        return out
    name = "warm_init_ell" if layout == "ell" else "warm_init"
    orig_init = getattr(lmm_warm, name)

    def init(sys_, w, pen, mc_idx, eps, *args, **kw):
        if "work" not in seen:
            seen.update(sys=sys_, pen=pen.clone(),
                        mc_idx=torch.as_tensor(np.array(mc_idx)), eps=eps,
                        work=clone_work(w))
        return orig_init(sys_, w, pen, mc_idx, eps, *args, **kw)
    monkeypatch.setattr(lmm_warm, "modified_index", index)
    monkeypatch.setattr(lmm_warm, name, init)
    return seen


def warm_restart_of_clusters(monkeypatch, layout):
    """A port System (CPU) solved, then every cluster's bound moved in
    decreasing slot order and solved again from the warm state: the
    record of that solve's K6 call."""
    s, clusters, flows, rng = build_lmm_warm(
        port_system(warm_start="on", layout=layout), 17)
    s.solve()
    seen = record_k6_call(monkeypatch, layout)
    for c in reversed(clusters):
        s.update_constraint_bound(c, float(rng.uniform(5, 20)))
    s.solve()
    assert s.warm_solver.last_mode == "warm"
    assert s.warm_solver.last_layout == layout
    return seen


@pytest.mark.parametrize("layout", ["coo", "ell"])
def test_warm_solver_hands_k6_a_sorted_index(monkeypatch, layout):
    """The warm solver builds K6's modified-constraint index with
    ``modified_index``: the listed constraints (here in decreasing slot
    order) sorted, padded to JAX's length by repeating the last one.
    K6's kernel decides "modified" by binary search in it."""
    seen = warm_restart_of_clusters(monkeypatch, layout)
    raw, got = seen["raw"], seen["mc_idx"].numpy()
    assert len(raw) > 1 and np.any(np.diff(raw) < 0)
    assert np.array_equal(got, seen["index"]) and got.dtype == np.int32
    assert len(got) == bucket(len(raw), floor=8)
    assert np.all(np.diff(got) >= 0)
    assert np.all(got[len(raw):] == got[len(raw) - 1])
    assert set(got.tolist()) == set(raw.tolist())


@pytest.mark.parametrize("layout", ["coo", "ell"])
def test_k6_plain_is_the_same_for_any_index_order(monkeypatch, layout):
    """K6's plain version (a transcription of the JAX program, which
    takes the index in any order) gives the same state, bit for bit,
    from the sorted index the warm solver hands it, from JAX's padding
    of the listed order (the first entry repeated) and from a shuffle."""
    seen = warm_restart_of_clusters(monkeypatch, layout)
    raw = seen["raw"]
    jax_pad = np.full(bucket(len(raw), floor=8), raw[0], np.int32)
    jax_pad[:len(raw)] = raw
    shuffled = np.random.default_rng(3).permutation(jax_pad)
    plain = k6.warm_init_ell_plain if layout == "ell" else k6.warm_init_plain
    states = []
    for mc in (seen["index"], jax_pad, shuffled):
        w = clone_work(seen["work"])
        assert plain(seen["sys"], w, seen["pen"], torch.from_numpy(mc),
                     seen["eps"]) is True
        states.append({n: t for n, t in vars(w).items()
                       if torch.is_tensor(t)})
    assert "c_mod" in states[0] and "ctrl" in states[0]
    for other in states[1:]:
        assert states[0].keys() == other.keys()
        for n, t in states[0].items():
            assert torch.equal(bits(t), bits(other[n])), n


@pytest.mark.parametrize("layout", ["coo", "ell"])
def test_k6_card_route_refuses_an_unsorted_index(monkeypatch, layout):
    """On the card K6 takes the index on the host and checks its order
    there: a descending pair raises ``ValueError`` before any launch (the
    kernel's trap is only a backstop), a device tensor is refused, and
    the sorted index the warm solver builds goes on to the launch."""
    seen = warm_restart_of_clusters(monkeypatch, layout)
    launched = []
    monkeypatch.setattr(k6, "on_cpu", lambda *t: False)
    monkeypatch.setattr(k6, "_launch", lambda entry, dev, mc, *a:
                        launched.append((entry, mc.copy())))
    fn = k6.warm_init_ell if layout == "ell" else k6.warm_init
    index = seen["index"]
    assert len(np.unique(index)) > 1
    for bad in (index[::-1].copy(), torch.from_numpy(index[::-1].copy()),
                np.random.default_rng(3).permutation(index)):
        if not (np.diff(np.asarray(bad)) < 0).any():
            continue
        with pytest.raises(ValueError, match="sorted"):
            fn(seen["sys"], clone_work(seen["work"]), seen["pen"], bad,
               seen["eps"])
    with pytest.raises(TypeError):
        fn(seen["sys"], clone_work(seen["work"]), seen["pen"],
           torch.from_numpy(index).to("meta"), seen["eps"])
    assert not launched
    for good in (index, torch.from_numpy(index)):
        fn(seen["sys"], clone_work(seen["work"]), seen["pen"], good,
           seen["eps"])
    assert [e for e, _ in launched] == [fn.__name__] * 2
    assert all(np.array_equal(mc, index) for _, mc in launched)
    with pytest.raises(TypeError):
        k6.host_index(index.astype(np.int64))


def scatter_case(arm):
    """(wrapper, CPU targets) of one K5 arm."""
    if arm == "ell":
        return ell_delta_scatter, [
            torch.zeros(16, dtype=torch.int32),
            torch.zeros(16, dtype=torch.float64),
            torch.zeros(16, dtype=torch.bool),
            torch.zeros(16, dtype=torch.int32),
            torch.zeros(16, dtype=torch.bool),
            torch.zeros(16, dtype=torch.float64)]
    fields = TRANSITION_FIELDS if arm == "transition" else DELTA_FIELDS
    fn = transition_scatter if arm == "transition" else delta_scatter
    return fn, [torch.zeros(16, dtype=torch.float64) for _ in fields]


@pytest.mark.parametrize("arm", ["transition", "delta", "ell"])
def test_scatter_refuses_two_runs_on_one_target(arm):
    """K5 writes every run of a call in one launch, in no set order
    across runs, so its wrapper refuses a layout with two runs on one
    target, on the CPU route too; the targets stay untouched."""
    fn, targets = scatter_case(arm)
    payload = torch.tensor([1.0, 2.0, 5.0, 6.0, 1.0, 3.0, 7.0, 8.0],
                           dtype=torch.float64)
    with pytest.raises(ValueError, match="one target"):
        fn(payload, [(1, 0, 2), (1, 4, 2)], targets)
    assert not any(bool(t.any()) for t in targets)
    assert fn(payload, [(1, 0, 2), (3, 4, 2)], targets) is True
    assert targets[1].tolist()[1:3] == [5.0, 6.0]
