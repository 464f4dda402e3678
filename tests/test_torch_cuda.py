"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``; each test skips when no CUDA device is present.
This file imports nothing of JAX or of simgrid_tpu, so it also runs on a
machine without them:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Every comparison is exact: the kernels sum in element order, as the
plain versions on the CPU do.  The K1 cases pin ``layout="coo"``: on the
card the default layout is ELL wherever its caps accept the system (as
the JAX package's is on an accelerator), and the ELL cases below hold
K7-K9 and the ELL arms of K5 and K6.
"""

import dataclasses

import numpy as np
import pytest
import torch

from simgrid_tpu_torch.kernels import (launch_counts, path_counts,
                                       reset_launch_counts)
from simgrid_tpu_torch.kernels import ell_chain as k9
from simgrid_tpu_torch.kernels import warm_init as k6
from simgrid_tpu_torch.kernels.common import (
    AANY, ADV_CONV, ADV_GO, ADV_OK, COMMIT_TILE, DT, EV_NEXT_T, EV_T0, FFIRE,
    FIRE, IT, LIGHT, LIMIT, LIVE_ACC, N_CTRL, OVERFLOW, PENDING, SS_ACTIVE,
    SS_ADV, SS_NEV,
    SS_ROUNDS, T_COMP, T_SUM, TPOS, EllWork, Work, inf_key)
from simgrid_tpu_torch.kernels import superstep_loop as k16
from simgrid_tpu_torch.kernels.dag_walk import dag_walk
from simgrid_tpu_torch.kernels.drain_advance import drain_forced_advance
from simgrid_tpu_torch.kernels.transition_scatter import (
    delta_scatter, ell_delta_scatter, transition_scatter)
from simgrid_tpu_torch.ops import lmm_ell, lmm_torch
from simgrid_tpu_torch.ops.lmm_arrays import LmmArrays, bucket
from simgrid_tpu_torch.ops.lmm_drain import DrainSim
from simgrid_tpu_torch.ops.lmm_host import LmmFlags, make_new_maxmin_system
from simgrid_tpu_torch.ops.lmm_warm import modified_index
from simgrid_tpu_torch.workloads import (churn, dragonfly, drain_run,
                                         lazy_alltoall)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def random_arrays(seed, n_c, n_v, deg, dtype):
    rng = np.random.default_rng(seed)
    E = n_v * deg
    Eb, Cb, Vb = bucket(E), bucket(n_c), bucket(n_v)
    e_var = np.zeros(Eb, np.int32)
    e_cnst = np.zeros(Eb, np.int32)
    e_w = np.zeros(Eb, dtype)
    e_var[:E] = np.repeat(np.arange(n_v, dtype=np.int32), deg)
    e_cnst[:E] = rng.integers(0, n_c, size=E).astype(np.int32)
    e_w[:E] = rng.uniform(0.5, 1.5, size=E).astype(dtype)
    c_bound = np.zeros(Cb, dtype)
    c_bound[:n_c] = rng.uniform(1.0, 10.0, size=n_c).astype(dtype)
    c_bound[:3] = 0.0
    v_penalty = np.zeros(Vb, dtype)
    v_penalty[:n_v] = 1.0
    v_penalty[rng.choice(n_v, n_v // 10, replace=False)] = 0.0
    return LmmArrays(e_var, e_cnst, e_w, c_bound, np.zeros(Cb, bool),
                     v_penalty, np.full(Vb, -1.0, dtype), E, n_c, n_v)


@pytest.mark.parametrize("dtype,eps", [(np.float64, 1e-9),
                                       (np.float32, 1e-5)])
def test_solve_card_equals_plain(cuda, dtype, eps):
    a = random_arrays(11, 3000, 20000, 5, dtype)
    g = lmm_torch.solve_arrays(a, eps, device=cuda, layout="coo")
    c = lmm_torch.solve_arrays(a, eps, device="cpu", layout="coo")
    assert g[3] == c[3]
    for x, y in zip(g[:3], c[:3]):
        np.testing.assert_array_equal(x, y)


MODES = {
    "superstep64": (np.float64, dict(superstep=16)),
    "superstep32": (np.float32, dict(superstep=16)),
    "fused64": (np.float64, dict(fused=True)),
    "unfused64": (np.float64, {}),
    # a round budget tighter than some solves: slots end on the budget
    # inside the graph, and the fused rescue's chunk loops finish them
    "starved64": (np.float64, dict(superstep=16, superstep_rounds=40)),
}


def assert_graph_drain(g, c, counts, tally):
    """A drain on the card ran its supersteps as K16 graphs: one graph
    launch a superstep, no K1 call from the host, the rounds the control
    words report run inside the graphs, and the graphs rebuilt on the
    events the plain run rebuilt its loops on (the first use, every
    repack)."""
    assert counts["superstep_loop_superstep"] == g.supersteps
    assert not any(v for k, v in counts.items()
                   if k.startswith("lmm_round"))
    assert tally["lmm_round"] == g.rounds
    assert g.loop_builds == c.loop_builds >= 1 + g.repacks


@pytest.mark.parametrize("mode", list(MODES))
def test_drain_card_equals_plain(cuda, mode):
    s = dragonfly.build_system(3000)
    dtype, kw = MODES[mode]
    sims = []
    for dev in (cuda, torch.device("cpu")):
        reset_launch_counts()
        sim = DrainSim(s.e_var, s.e_cnst, s.e_w.astype(dtype),
                       s.c_bound.astype(dtype), s.sizes, eps=1e-5,
                       dtype=dtype, repack_min=64, device=dev, **kw)
        sim.run()
        sims.append((sim, launch_counts(), k16.device_tally()))
    (g, counts, tally), (c, _, _) = sims
    assert g.events == c.events
    assert g.t == c.t
    assert (g.advances, g.supersteps, g.repacks, g.rounds) == \
        (c.advances, c.supersteps, c.repacks, c.rounds)
    assert sorted(f for _, f in g.events) == list(range(3000))
    if kw.get("superstep"):
        assert_graph_drain(g, c, counts, tally)
    else:
        assert counts["superstep_loop_chunk"] > 0
        assert tally["lmm_round"] == g.rounds


def mixed_arrays(seed, n_c, n_v, p_bound, p_fat, dtype):
    """Bounds in [0.5, 50], penalties from {0.5, 1, 2, 3}, FATPIPE
    constraints, 1-5 distinct constraints per variable."""
    rng = np.random.default_rng(seed)
    n_links = rng.integers(1, 6, n_v)
    e_cnst = np.concatenate([rng.choice(n_c, size=k, replace=False)
                             for k in n_links])
    E = len(e_cnst)
    Eb, Cb, Vb = bucket(E), bucket(n_c), bucket(n_v)
    a = LmmArrays(np.zeros(Eb, np.int32), np.zeros(Eb, np.int32),
                  np.zeros(Eb, dtype), np.zeros(Cb, dtype),
                  np.zeros(Cb, bool), np.zeros(Vb, dtype),
                  np.full(Vb, -1.0, dtype), E, n_c, n_v)
    a.e_var[:E] = np.repeat(np.arange(n_v), n_links)
    a.e_cnst[:E] = e_cnst
    a.e_w[:E] = rng.choice([0.5, 1.0, 1.0, 2.0], E)
    a.c_bound[:n_c] = rng.uniform(1, 100, n_c)
    a.c_fatpipe[:n_c] = rng.random(n_c) < p_fat
    a.v_penalty[:n_v] = rng.choice([0.5, 1.0, 2.0, 3.0], n_v)
    a.v_bound[:n_v] = np.where(rng.random(n_v) < p_bound,
                               rng.uniform(0.5, 50, n_v), -1.0)
    return a


@pytest.mark.parametrize("parallel_rounds", [True, False],
                         ids=["local", "global"])
@pytest.mark.parametrize("dtype,eps", [(np.float64, 1e-5),
                                       (np.float32, 1e-5)])
def test_solve_arms_card_equals_plain(cuda, dtype, eps, parallel_rounds):
    """K1's bound-first, FATPIPE and global arms on the card equal the
    plain versions on the CPU."""
    a = mixed_arrays(13, 1500, 4000, 0.5, 0.3, dtype)
    reset_launch_counts()
    g = lmm_torch.solve_arrays(a, eps, device=cuda,
                               parallel_rounds=parallel_rounds, layout="coo")
    arm = ("lmm_round" + ("" if parallel_rounds else "_global")
           + "_bounds_fatpipe")
    assert path_counts()[arm] > 0
    c = lmm_torch.solve_arrays(a, eps, device="cpu",
                               parallel_rounds=parallel_rounds, layout="coo")
    assert g[3] == c[3]
    for x, y in zip(g[:3], c[:3]):
        np.testing.assert_array_equal(x, y)


def test_forced_advance_card_equals_plain(cuda):
    rng = np.random.default_rng(3)
    V = 50_000
    pen = np.where(rng.random(V) < 0.9, rng.uniform(0.5, 2, V), 0.0)
    rem = rng.uniform(1e3, 1e6, V)
    rate = np.where(rng.random(V) < 0.95, rng.uniform(1e3, 1e5, V), 0.0)
    thresh = np.full(V, 1e-3)
    delta = float(np.min(rem[(pen > 0) & (rate > 0)]
                         / rate[(pen > 0) & (rate > 0)]))
    out = []
    for dev in (cuda, torch.device("cpu")):
        w = Work(V, 4, torch.float64, dev)
        w.v_value.copy_(torch.from_numpy(rate))
        p, r = (torch.from_numpy(x.copy()).to(dev) for x in (pen, rem))
        drain_forced_advance(p, r, torch.from_numpy(thresh).to(dev), w,
                             delta)
        out.append([p.cpu(), r.cpu(), w.done.cpu(),
                    int(w.ctrl[LIVE_ACC])])
    for x, y in zip(out[0][:3], out[1][:3]):
        assert torch.equal(x, y)
    assert out[0][3] == out[1][3]
    assert int(out[1][2].sum()) > 0


# K2 and K3 against their plain versions at small shapes that straddle
# K3's tiles, with every control word, clock slot and array compared by
# bits; ``None`` is the solo layout, 1, 5 and 8 replica axes.
LEADS = (None, 1, 5, 8)
V_TILES = 3 * COMMIT_TILE + 37


def _per_replica(B, fn):
    """A [B, ...] array of fn(b) rows, or fn(0) for the solo layout."""
    return fn(0) if B is None else np.stack([fn(b) for b in range(B)])


def _work(dev, B, dtype, V=V_TILES, C=16):
    return Work(V, C, dtype, dev, B=B)


def _set(w, B, slot, vals):
    """ctrl/fctrl/evf slot ``slot`` per replica (vals: a list or scalar)."""
    t, i = slot
    x = getattr(w, t)
    if B is None:
        x[i] = vals[0] if isinstance(vals, list) else vals
    else:
        x[:, i] = torch.tensor(vals if isinstance(vals, list)
                               else [vals] * B, dtype=x.dtype)


def _same(a, b, what):
    a, b = a.cpu(), b.cpu()
    if a.dtype.is_floating_point:
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        assert bool(same.all()) and torch.equal(torch.signbit(a),
                                                torch.signbit(b)), what
    else:
        assert torch.equal(a, b), what


K2_CASES = ("plain", "event_tape", "event_ready", "tie", "starved",
            "budget", "nonfinite", "gated2", "twice", "forced")


def _k2_inputs(case, dtype, B, V):
    rng = np.random.default_rng(21)
    npd = np.float64 if dtype == torch.float64 else np.float32
    nb = 1 if B is None else B

    def row(b):
        pen = np.where(rng.random(V) < 0.9, rng.uniform(0.5, 2, V), 0.0)
        rate = np.where(rng.random(V) < 0.95,
                        np.round(rng.uniform(1e3, 1e5, V)), 0.0)
        rem = rate * rng.uniform(6.0, 60.0, V) + 1.0
        # several flows end together on the planned dt, across tiles
        tie = rng.choice(V, 7, replace=False)
        pen[tie], rate[tie] = 1.0, 1024.0 * (b + 1)
        rem[tie] = rate[tie] * 5.0
        if case == "nonfinite":
            rate[:] = 0.0
        return np.stack([pen, rem, rate, np.full(V, 1e-3)]).astype(npd)
    x = _per_replica(B, row)
    if B is None:
        pen, rem, rate, thr = x
    else:
        pen, rem, rate, thr = (x[:, i] for i in range(4))
    tape_t = ready = None
    if case in ("event_tape", "tie", "twice", "gated2", "starved"):
        tape_t = _per_replica(B, lambda b: np.sort(rng.uniform(0.5, 60.0, 6)))
    if case in ("event_ready", "tie"):
        def rdy(b):
            r = np.full(V, np.inf)
            idx = rng.choice(V, 9, replace=False)
            r[idx] = 3.0 + rng.uniform(0.0, 4.0, 9)
            return r
        ready = _per_replica(B, rdy)
    ctrl = dict(light=[0] * nb, it=[4] * nb, limit=[10] * nb,
                active=[1] * nb, gated=0)
    if case in ("starved", "budget", "gated2"):
        ctrl["gated"] = 2 if case == "gated2" else 1
        ctrl["light"] = [3 if b % 2 == 0 else 0 for b in range(nb)]
        if case == "budget":
            ctrl["it"] = [10] * nb
        if case == "gated2":
            ctrl["active"] = [b % 3 != 0 for b in range(nb)]
    return pen, rem, rate, thr, tape_t, ready, ctrl


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case,B", [(c, B) for c in K2_CASES
                                    for B in LEADS
                                    if c != "forced" or B is None])
def test_k2_advance_card_equals_plain(cuda, case, B, dtype):
    """K2 (two launches a call, the forced mode one) against its plain
    version: a gated advance after a fixpoint that has not converged (it
    runs and changes nothing), a non-finite dt, a fixpoint out of
    budget, a gate that is off in some replicas, the event arm on a tape
    and on ready dates, an
    event date that ties the planned dt, and two calls in a row with no
    reset between them (each call's last block resets the minimum slots
    and the ticket)."""
    from simgrid_tpu_torch.kernels.drain_advance import (drain_advance,
                                                         planned_dt)
    V = V_TILES
    pen, rem, rate, thr, tape_t, ready, c = _k2_inputs(case, dtype, B, V)
    nb = 1 if B is None else B
    runs = []
    for dev in (cuda, torch.device("cpu")):
        w = _work(dev, B, dtype, V)
        T = lambda a: torch.from_numpy(np.array(a)).to(dev)  # noqa
        p, r, th = T(pen), T(rem), T(thr)
        w.v_value.copy_(T(rate))
        tt = None if tape_t is None else T(tape_t)
        rd = None if ready is None else T(ready)
        for key, slot in (("light", LIGHT), ("it", IT), ("limit", LIMIT),
                          ("active", SS_ACTIVE)):
            _set(w, B, ("ctrl", slot), [int(v) for v in c[key]])
        _set(w, B, ("ctrl", TPOS), [b % 3 for b in range(nb)])
        _set(w, B, ("fctrl", T_SUM), [0.75 + b for b in range(nb)])
        _set(w, B, ("evf", EV_T0), [2.0 + 0.5 * b for b in range(nb)])
        if case == "tie":
            # the next event date lands exactly on now + dt_plan: a tape
            # date in even replicas, an activation date in odd ones (with
            # a collective the clock is t_sum alone)
            for b in range(nb):
                wb = w if B is None else w.replica(b)
                pb, rb = (p, r) if B is None else (p[b], r[b])
                tb = tt if B is None else tt[b]
                rrow = rd if B is None else rd[b]
                dt = float(planned_dt(pb.cpu(), rb.cpu(),
                                      wb.v_value.cpu())[0])
                now = float(wb.fctrl[T_SUM])
                rrow.fill_(float("inf"))
                if b % 2 == 0:
                    tb[int(wb.ctrl[TPOS])] = now + dt
                else:
                    tb += 1000.0
                    rrow[V // 2] = now + dt
        if case == "forced":
            for delta in (2.5, 5.0):
                drain_forced_advance(p, r, th, w, delta)
        else:
            for _ in range(2 if case == "twice" else 1):
                drain_advance(p, r, th, w, gated=c["gated"], tape_t=tt,
                              ready=rd)
        runs.append((w, p, r))
    (wg, pg, rg), (wc, pc, rc) = runs
    for name, a, b in (("pen", pg, pc), ("rem", rg, rc),
                       ("done", wg.done, wc.done), ("ctrl", wg.ctrl, wc.ctrl),
                       ("fctrl", wg.fctrl, wc.fctrl), ("evf", wg.evf, wc.evf)):
        _same(a, b, name)
    # the minimum slots are back at +inf for the next call
    assert bool((wg.dtbits.cpu() == inf_key(dtype)).all())
    assert bool((wg.atbits.cpu() == inf_key(torch.float64)).all())
    cc = wc.ctrl.reshape(nb, -1)
    if case in ("plain", "tie", "twice", "forced"):
        assert int(wc.done.sum()) > 0
    if case == "tie":
        assert bool((cc[:, FIRE] == 1).all())
    if case == "starved":
        # the replicas whose fixpoint still runs advanced nothing
        assert bool((cc[:, ADV_GO] == 1).all())
        assert bool((cc[::2, ADV_CONV] == 0).all())
        assert int(wc.done.reshape(nb, -1)[::2].sum()) == 0
    if case in ("budget", "nonfinite"):
        # replica 0 ran its advance and changed nothing
        assert int(cc[0, ADV_GO]) == 1
        assert int(wc.done.reshape(nb, -1)[0].sum()) == 0


K3_CASES = ("none", "all", "edges", "tape_act", "act_next", "go0",
            "ring_end", "stalled", "budget", "ids_view")


def _k3_inputs(case, dtype, B, V):
    rng = np.random.default_rng(33)
    nb = 1 if B is None else B
    nt = 5.0

    def done_row(b):
        if case == "none":
            return np.zeros(V, bool)
        if case == "all":
            return np.ones(V, bool)
        d = rng.random(V) < 0.01
        if case in ("edges", "ids_view"):
            d[[0, 15, 16, 4095, 4096, 4097, 8191, 8192, 12287, 12288,
               V - 1]] = True
        return d
    done = _per_replica(B, done_row)
    tape = case in ("all", "tape_act", "go0", "ring_end", "stalled")
    coll = case in ("tape_act", "act_next", "go0", "ring_end", "budget")

    def ready_row(b):
        r = np.full(V, np.inf)
        idx = rng.choice(V, 40, replace=False)
        r[idx] = nt + rng.uniform(-2.0, 2.0, 40)
        # due exactly at the event date, across tiles
        r[[4095, 4096, 9000 + b, V - 2]] = nt
        r[V - 3] = np.nextafter(nt, np.inf)
        return r
    ready = _per_replica(B, ready_row) if coll else None
    ok = case not in ("stalled", "budget")
    n_done = done.reshape(nb, V).sum(1)
    n_act = ((ready.reshape(nb, V) <= nt).sum(1) if coll
             else np.zeros(nb, int))
    n_ev = 100
    # two commits in a row: completions twice, the fault twice, the
    # activations once (the first sets their dates to inf)
    need = n_ev + 2 * n_done + (2 if tape else 0) + n_act
    ring_n = int(need.max()) if case == "ring_end" else n_ev + 3 * V
    return done, tape, coll, ready, ok, n_ev, ring_n, nt


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("B", LEADS, ids=lambda B: f"B{B}")
@pytest.mark.parametrize("case", K3_CASES)
def test_k3_commit_card_equals_plain(cuda, case, B, dtype):
    """K3's commit (a reduce-then-scan over tiles) against its plain
    version, two commits in a row: no completion, every flow completing,
    completions on tile edges with V not a multiple of the tile, a tape
    fire with activations, activations due exactly at the event date, a
    replica whose advance did not run beside live ones, a ring filled to
    its last slot, a non-finite dt, an unconverged fixpoint and ids
    given as a view one entry into its storage (not 16-byte aligned)."""
    from simgrid_tpu_torch.kernels.superstep_commit import (
        packed_size, superstep_commit)
    V, C, k_max, n_t = V_TILES, 16, 4, 5
    done, tape, coll, ready, ok, n_ev, ring_n, nt = _k3_inputs(
        case, dtype, B, V)
    nb = 1 if B is None else B
    rng = np.random.default_rng(34)
    npd = np.float64 if dtype == torch.float64 else np.float32
    ids = rng.permutation(V).astype(np.int32)
    t_slot = _per_replica(
        B, lambda b: rng.integers(0, C, n_t).astype(np.int32))
    t_val = _per_replica(B, lambda b: rng.uniform(1.0, 9.0, n_t).astype(npd))
    c_bound = _per_replica(B, lambda b: rng.uniform(1.0, 9.0, C).astype(npd))
    pen = _per_replica(B, lambda b: rng.uniform(0.0, 2.0, V).astype(npd))
    runs = []
    for dev in (cuda, torch.device("cpu")):
        T = lambda a: torch.from_numpy(np.array(a)).to(dev)  # noqa
        w = _work(dev, B, dtype, V, C)
        w.done.copy_(T(done))
        go = [0 if case == "go0" and (B is None or b == 1) else 1
              for b in range(nb)]
        for slot, vals in (
                (("ctrl", ADV_GO), go),
                (("ctrl", ADV_CONV), 0 if case == "budget" else 1),
                (("ctrl", SS_NEV), n_ev), (("ctrl", SS_ADV), 1),
                (("ctrl", TPOS), [b % 2 for b in range(nb)]),
                (("ctrl", FFIRE), int(tape)), (("ctrl", AANY), int(coll)),
                (("ctrl", IT), 7), (("ctrl", SS_ROUNDS), 30),
                (("ctrl", LIVE_ACC), [V // 2 + b for b in range(nb)]),
                (("ctrl", PENDING), 1000),
                (("fctrl", DT), float("inf") if case == "stalled"
                 else 0.25),
                (("fctrl", T_SUM), [3.0 + b for b in range(nb)]),
                (("fctrl", T_COMP), 1e-7), (("evf", EV_NEXT_T), nt)):
            _set(w, B, slot, vals)
        packed = torch.full(((nb,) if B is not None else ())
                            + (packed_size(k_max, ring_n),), -3.0,
                            dtype=dtype, device=dev)
        arms = dict(tape=(T(t_slot), T(t_val)) if tape else None,
                    c_bound=T(c_bound), n_c=C,
                    ready=T(ready) if coll else None, pen=T(pen))
        ids_t = (T(np.concatenate([[-1], ids]).astype(np.int32))[1:]
                 if case == "ids_view" else T(ids))
        for _ in range(2):
            superstep_commit(w, ids_t, packed, k_max, ring_n, **arms)
        runs.append((w, packed, arms))
    (wg, pg, ag), (wc, pc, ac) = runs
    for name, a, b in (("packed", pg, pc), ("ctrl", wg.ctrl, wc.ctrl),
                       ("fctrl", wg.fctrl, wc.fctrl),
                       ("c_bound", ag["c_bound"], ac["c_bound"]),
                       ("pen", ag["pen"], ac["pen"])):
        _same(a, b, name)
    if coll:
        _same(ag["ready"], ac["ready"], "ready")
    if case == "ring_end":
        # the fullest replica's last ring slot was written
        last = pc.reshape(nb, -1)[:, -1]
        assert bool((last != -3.0).any())
    if ok and case != "none" and case != "go0":
        assert int(wc.ctrl.reshape(nb, -1)[:, SS_NEV].max()) > n_ev


def test_transition_scatter_card_equals_plain(cuda):
    rng = np.random.default_rng(4)
    E, C, V = 4096, 300, 1000
    base = [np.zeros(E, np.int32), np.zeros(E, np.int32), np.ones(E),
            np.ones(C), np.ones(V), np.ones(V), np.ones(V), np.ones(V)]
    runs = [(0, 50, E), (1, 50, E), (2, 50, E), (3, 7, C), (4, 40, V),
            (7, 40, V)]
    layout, chunks, off = [], [], 0
    for ti, n, hi in runs:
        ix = rng.choice(hi, n, replace=False).astype(np.float64)
        vals = (rng.integers(0, 900, n).astype(np.float64) if ti < 2
                else rng.uniform(0, 10, n))
        layout.append((ti, off, n))
        chunks += [ix, vals]
        off += 2 * n
    payload = torch.from_numpy(np.concatenate(chunks))
    out = []
    for dev in (cuda, torch.device("cpu")):
        targets = [torch.from_numpy(b.copy()).to(dev) for b in base]
        transition_scatter(payload.to(dev), layout, targets)
        out.append([t.cpu() for t in targets])
    for x, y in zip(*out):
        assert torch.equal(x, y)


@pytest.mark.parametrize("mode", ["superstep64", "fused64", "unfused64",
                                  "starved64"])
def test_bounded_drain_card_equals_plain(cuda, mode):
    """The LV08 drain with its bounds scaled to bind (one factor), in
    the executor shapes: the bound arm and K4's bound rows."""
    s = dragonfly.build_system(3000, lv08=True)
    rates = lmm_torch.solve_arrays(drain_run.solve_inputs(s), 1e-5,
                                   device="cpu")[0]
    vb = s.v_bound * np.median(rates / s.v_bound)
    dtype, kw = MODES[mode]
    sims = []
    for dev in (cuda, torch.device("cpu")):
        sim = DrainSim(s.e_var, s.e_cnst, s.e_w, s.c_bound, s.sizes,
                       eps=1e-5, dtype=dtype, repack_min=64, device=dev,
                       penalty=s.v_penalty, v_bound=vb, **kw)
        sim.run()
        sims.append(sim)
    g, c = sims
    assert g.events == c.events and g.t == c.t
    assert (g.advances, g.supersteps, g.repacks, g.rounds) == \
        (c.advances, c.supersteps, c.repacks, c.rounds)
    assert sorted(f for _, f in g.events) == list(range(3000))


def test_engine_plan_card_equals_plain(cuda):
    """The engine-plan drain (latency lanes, transition batch through
    K5, partial advance through K2's forced mode) of a 24-rank LV08
    alltoall, card against plain."""
    s = dragonfly.build_alltoall(24)
    g, grow, gev = drain_run.run_engine_plan(s, device=cuda)
    for name in ("transition_scatter", "drain_forced_advance",
                 "lmm_round_bounds"):
        assert grow["launches"][name] > 0, name
    c, _, cev = drain_run.run_engine_plan(s, device="cpu")
    assert gev == cev and g.t == c.t
    assert torch.equal(g._pen.cpu(), c._pen)
    assert torch.equal(g._rem.cpu(), c._rem)


def test_element_transitions_card_equals_plain(cuda):
    """A transition batch that appends a flow (elements in the plan's
    weight-0 slack) re-derives the row indexes on the device; the drain
    that follows equals the plain path's."""
    s = dragonfly.build_alltoall(12)
    E, V = len(s.e_var), len(s.sizes)
    pad = lambda a, n, fill: np.concatenate([a, np.full(n, fill, a.dtype)])
    e_var, e_cnst = pad(s.e_var, 8, 0), pad(s.e_cnst, 8, 0)
    e_w = pad(s.e_w, 8, 0.0)
    pen = pad(s.v_penalty, 1, 0.0)
    vb = pad(s.v_bound, 1, -1.0)
    sizes = pad(s.sizes, 1, 1.0)
    rem = pad(s.sizes, 1, 0.0)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        sim = DrainSim(e_var, e_cnst, e_w, s.c_bound, sizes, eps=1e-5,
                       dtype=np.float64,
                       done_mode="abs", done_eps=1e-10, penalty=pen,
                       remains=rem, v_bound=vb, superstep=16, device=dev,
                       repack_min=1 << 62)
        sim.superstep_batch()
        n = sim.apply_transitions({
            "e_var": (np.arange(E, E + 3), np.full(3, V)),
            "e_cnst": (np.arange(E, E + 3), np.array([0, 5, 9])),
            "e_w": (np.arange(E, E + 3), np.array([1.0, 1.0, 0.05])),
            "v_penalty": ([V], [1e-4]), "remains": ([V], [5e5]),
            "thresh": ([V], [1e-10]), "v_bound": ([V], [3e6])})
        assert n == 13
        sim.run()
        runs.append(sim)
    g, c = runs
    assert g.events == c.events and g.t == c.t
    for a, b in zip(g.sys.csr, c.sys.csr):
        assert torch.equal(a.cpu(), b)
    assert sorted(f for _, f in g.events) == list(range(V + 1))


def test_engine_plan_held_windows_card_against_plain(cuda):
    """``drain_run.run_engine_plan_held`` of a 3,000-flow LV08 random
    system with repacks: every window (after the partial advance, after
    each repack) equals the plain path's on the CPU, and the drain equals
    the timed ``run_engine_plan`` on the card."""
    s = dragonfly.build_system(3000, lv08=True)
    g, grow, _ = drain_run.run_engine_plan(s, device=cuda, repack_min=64)
    assert grow["launches"]["livefirst_repack_vbound"] > 0
    h, windows = drain_run.run_engine_plan_held(s, device=cuda,
                                                repack_min=64)
    assert len(windows) == g.repacks + 1 >= 2
    assert h.events == g.events and h.t == g.t


def test_bound_free_rounds_share_one_pointer_array(cuda):
    """The init and a bound-free round given the drain's bound rows key
    K1's pointer cache alike: a drain without bounds builds one entry."""
    s = dragonfly.build_system(3000)
    sim = DrainSim(s.e_var, s.e_cnst, s.e_w, s.c_bound, s.sizes, eps=1e-5,
                   dtype=np.float64, superstep=16, device=cuda)
    sim.superstep_batch()
    assert not sim.has_bounds and list(sim.w.ptr_cache) == [0]
    arr = sim.w.ptr_cache[0][3]
    sim.superstep_batch()
    assert sim.w.ptr_cache[0][3] is arr


def test_delta_scatter_card_equals_plain(cuda):
    """K5 into the warm solver's seven masters, a bool target among
    them, with runs padded by repeating their first pair."""
    rng = np.random.default_rng(5)
    E, C, V = 4096, 300, 1000
    base = [np.zeros(E, np.int32), np.zeros(E, np.int32), np.ones(E),
            np.ones(C), np.zeros(C, bool), np.ones(V), np.full(V, -1.0)]
    layout, chunks, off = [], [], 0
    for ti, hi in enumerate((E, E, E, C, C, V, V)):
        ix = rng.choice(hi, 37, replace=False).astype(np.float64)
        vals = (rng.integers(0, 900, 37).astype(np.float64) if ti < 2
                else (rng.random(37) < 0.5).astype(np.float64) if ti == 4
                else rng.uniform(0, 10, 37))
        ix = np.concatenate([ix, np.full(27, ix[0])])
        vals = np.concatenate([vals, np.full(27, vals[0])])
        layout.append((ti, off, 64))
        chunks += [ix, vals]
        off += 128
    payload = torch.from_numpy(np.concatenate(chunks))
    out = []
    for dev in (cuda, torch.device("cpu")):
        targets = [torch.from_numpy(b.copy()).to(dev) for b in base]
        delta_scatter(payload.to(dev), layout, targets)
        out.append([t.cpu() for t in targets])
    for x, y in zip(*out):
        assert torch.equal(x, y)
    assert int(out[0][4].sum()) > 0


def same_states(xs, ys):
    """Host states (:func:`churn.host_state`) equal bit for bit."""
    bits = lambda a: a.view(np.int64).tolist()
    return len(xs) == len(ys) and all(
        bits(a) == bits(c) and bits(b) == bits(d)
        for (a, b), (c, d) in zip(xs, ys))


@pytest.mark.parametrize("mode", list(churn.MODES))
def test_churn_card_equals_plain(cuda, mode):
    """The churn scenario at 3,000 variables, strict: every solve's host
    state on the card equals the plain path's bit for bit, no solve fell
    back to the host, and K5's delta scatter and K6 launched where the
    mode runs them."""
    kw = dict(n_v=3000, clusters=40, chain=12, churn=0.02, steps=5,
              states=True, strict=True, layout="coo")
    _, g = churn.run_churn(mode, device=cuda, **kw)
    _, c = churn.run_churn(mode, device="cpu", **kw)
    assert same_states(g["states"], c["states"])
    assert g["solver_fallbacks"] == c["solver_fallbacks"] == 0
    assert (g["rounds"], g["dirty_slots"], g["bytes_delta"]) == \
        (c["rounds"], c["dirty_slots"], c["bytes_delta"])
    if mode in ("cold-delta", "warm-selective"):
        assert g["launches"]["delta_scatter"] > 0
    if mode == "warm-selective":
        assert g["launches"]["warm_init"] == kw["steps"]


def _warm_two_precisions(dev, layout, eps2):
    """A selective System of 2,000 flows over 200 shared links, solved
    at eps 1e-5, one bound changed, then solved again at ``eps2`` on the
    same warm state: the host state after each solve, and whether the
    second solve ran on the first one's work buffers."""
    s = make_new_maxmin_system(True, LmmFlags(
        backend="torch", warm_start="on", delta_upload="on", strict=True,
        layout=layout))
    lmm_torch.install(s, device=dev)
    rng = np.random.default_rng(5)
    cs = [s.constraint_new(None, float(rng.uniform(50, 200)))
          for _ in range(200)]
    for _ in range(2000):
        v = s.variable_new(None, 1.0)
        for c in rng.choice(200, 3, replace=False):
            s.expand(cs[int(c)], v, float(rng.choice([0.5, 1.0, 2.0])))
    s.solve()
    work = lambda: [(st.work, st.ell_work)  # noqa: E731
                    for st in s.warm_solver._states.values()]
    first = work()
    states = [churn.host_state(s)]
    s.update_constraint_bound(cs[7], 120.0)
    s.flags = dataclasses.replace(s.flags, precision=eps2)
    s.solve()
    states.append(churn.host_state(s))
    return states, all(a is b for x, y in zip(first, work())
                       for a, b in zip(x, y))


@pytest.mark.parametrize("layout", ["coo", "ell"])
def test_warm_solves_at_two_precisions_card_equals_plain(cuda, layout):
    """eps is baked into the chunk loop's graph: a second solve of the
    same warm state at another precision builds its graph again, and
    every host state equals the plain path's bit for bit."""
    k16.reset_tally()
    g, g_same_work = _warm_two_precisions(cuda, layout, 0.3)
    builds = k16.summary()["graph_builds"]
    c, c_same_work = _warm_two_precisions("cpu", layout, 0.3)
    kept, _ = _warm_two_precisions("cpu", layout, 1e-5)
    assert g_same_work and c_same_work
    assert not same_states(kept[1:], c[1:])   # the new eps shows
    assert same_states(g, c)
    assert builds == 2


def test_lazy_alltoall_card_equals_plain(cuda):
    """The Lazy-mode LV08 alltoall at 16 ranks, strict, card against
    plain bit for bit, with no fallback to the host."""
    strict = LmmFlags(backend="torch", strict=True, layout="coo")
    _, g = lazy_alltoall.run_lazy(16, device=cuda, flags=strict, states=True)
    _, c = lazy_alltoall.run_lazy(16, device="cpu", flags=strict,
                                  states=True)
    assert same_states(g["states"], c["states"])
    assert g["solver_fallbacks"] == c["solver_fallbacks"] == 0
    strip = lambda rows: [{k: v for k, v in r.items() if k != "ms"}
                          for r in rows]
    assert strip(g["solves"]) == strip(c["solves"])
    assert g["launches"]["warm_init"] > 0
    assert g["launches"]["lmm_round_bounds"] > 0


def test_card_solve_error_is_never_handed_to_the_host(cuda, monkeypatch):
    """With the default, non-strict flags a SolveError on the card
    propagates: the card solve is not redone by the host list solver."""
    s = lmm_torch.install(make_new_maxmin_system(True,
                                                 LmmFlags(backend="torch")),
                          device=cuda)
    c = s.constraint_new(None, 4.0)
    for w in (1.0, 2.0):
        s.expand(c, s.variable_new(None, 1.0), w)
    monkeypatch.setattr(lmm_torch, "lmm_round", lambda *a, **k: True)
    with pytest.raises(lmm_torch.SolveError, match="stalled"):
        s.solve()
    assert s.fallback_count == 0


# ---------------------------------------------------------------------------
# the ELL layout: K7, K8, K9, K6's ELL arm, K5's ELL deltas


def width_arrays(seed, n_c, width, deg, bounds=0.0, fat=0.0):
    """Every constraint row holds ``width`` elements, each variable
    ``deg``; a tenth of the variables disabled, three zero-bound rows."""
    rng = np.random.default_rng(seed)
    n_e = n_c * width
    n_v = n_e // deg
    eb, cb, vb = bucket(n_e), bucket(n_c), bucket(n_v)
    e_var = np.zeros(eb, np.int32)
    e_cnst = np.zeros(eb, np.int32)
    e_w = np.zeros(eb)
    e_var[:n_e] = np.repeat(np.arange(n_v, dtype=np.int32), deg)
    e_cnst[:n_e] = np.concatenate([rng.permutation(n_c)
                                   for _ in range(width)])
    e_w[:n_e] = rng.uniform(0.5, 1.5, n_e)
    c_bound = np.zeros(cb)
    c_bound[:n_c] = rng.uniform(1.0, 10.0, n_c)
    c_bound[:3] = 0.0
    c_fat = np.zeros(cb, bool)
    c_fat[:n_c] = rng.random(n_c) < fat
    v_pen = np.zeros(vb)
    v_pen[:n_v] = 1.0
    v_pen[rng.choice(n_v, n_v // 10, replace=False)] = 0.0
    v_bound = np.full(vb, -1.0)
    sel = rng.random(n_v) < bounds
    v_bound[:n_v][sel] = rng.uniform(0.5, 3.0, sel.sum()) / width
    return LmmArrays(e_var, e_cnst, e_w, c_bound, c_fat, v_pen, v_bound,
                     n_e, n_c, n_v)


ELL_ARMS = {"vc": ({}, True, "vc_round"),
            "bounds": (dict(bounds=0.3), True, "ell_round"),
            "global": (dict(bounds=0.2), False, "ell_round_global"),
            "fatpipe_vc": (dict(fat=0.1), True, "vc_round"),
            "fatpipe_bounds": (dict(fat=0.1, bounds=0.3), True, "ell_round"),
            "global_fatpipe": (dict(fat=0.1), False, "ell_round_global")}


@pytest.mark.parametrize("width", [4, 64, 128])
@pytest.mark.parametrize("arm", list(ELL_ARMS))
def test_ell_dense_card_equals_plain(cuda, arm, width):
    """The dense ELL solve on the card (K7's init, then K8's or K7's
    rounds) equals the plain versions on the CPU, bit for bit."""
    kw, local, kernel = ELL_ARMS[arm]
    a = width_arrays(3, 96 if local else 48, width, 4, **kw)
    reset_launch_counts()
    g = lmm_torch.solve_arrays(a, 1e-9, device=cuda, parallel_rounds=local,
                               layout="ell", chain="off")
    counts = path_counts()
    assert counts["ell_init"] == 1 and counts[kernel] > 0
    c = lmm_torch.solve_arrays(a, 1e-9, device="cpu", parallel_rounds=local,
                               layout="ell", chain="off")
    assert g[3] == c[3]
    for x, y in zip(g[:3], c[:3]):
        np.testing.assert_array_equal(x.view(np.int64), y.view(np.int64))


@pytest.mark.parametrize("width", [36, 48])
@pytest.mark.parametrize("arm", list(ELL_ARMS))
def test_ell_dense_tight_card_equals_plain(cuda, arm, width):
    """The same at exact row widths that are not multiples of 32
    (``pad="tight"``): the card's row sums start their first window of
    32 lanes where XLA pads the row (``fold_rows``)."""
    kw, local, kernel = ELL_ARMS[arm]
    a = width_arrays(3, 96 if local else 48, width, 4, **kw)
    g = lmm_torch.solve_arrays(a, 1e-9, device=cuda, parallel_rounds=local,
                               layout="ell", chain="off", pad="tight")
    c = lmm_torch.solve_arrays(a, 1e-9, device="cpu", parallel_rounds=local,
                               layout="ell", chain="off", pad="tight")
    assert lmm_ell.ell_cached(a, "tight").cv_var.shape[1] == width
    assert g[3] == c[3]
    for x, y in zip(g[:3], c[:3]):
        np.testing.assert_array_equal(x.view(np.int64), y.view(np.int64))


# ---- K7's redesign: the bound regimes, the global arm across chunks,
# the round loop's nodes

#: nodes of a K7 round body in K16's loop by arm: every pass a kernel
#: node, the round's end in a_apply, no loop_cond node
K7_NODES = {"local": 8, "global": 4}


def bound_regime(a, bind):
    """``a`` with every enabled flow bounded: far above its share, so no
    bound ever binds (``none``), or far below it, so every bound binds
    (``all``)."""
    vb = np.full(len(a.v_bound), -1.0)
    vb[:a.n_var] = 1e6 if bind == "none" else 1e-3
    return a._replace(v_bound=vb)


def _k7_bodies():
    return [b for b in k16.bodies() if b["tally"] == "ell_round"]


@pytest.mark.parametrize("local", [True, False], ids=["local", "global"])
@pytest.mark.parametrize("bind", ["none", "all"])
def test_k7_bound_regimes_card_equal_plain(cuda, bind, local):
    """K7's solve with every flow bounded, where no bound ever binds (the
    bound passes skip in every round: ``mb_c`` is never written) and
    where every bound binds (no round skips), card against the plain
    path on the CPU by bits; the round loop's body holds the arm's
    kernel nodes, ends itself and has no ``loop_cond`` node."""
    a = bound_regime(width_arrays(5, 96 if local else 48, 64, 4), bind)
    reset_launch_counts()
    g = lmm_torch.solve_arrays(a, 1e-9, device=cuda, parallel_rounds=local,
                               layout="ell", chain="off")
    counts = path_counts()
    assert counts["ell_round" if local else "ell_round_global"] > 0
    assert counts["ell_prep"] >= 1
    (body,) = _k7_bodies()
    assert body["ends"] and body["cond_nodes"] == 0
    assert body["kernel_nodes"] == K7_NODES["local" if local else "global"]
    c = lmm_torch.solve_arrays(a, 1e-9, device="cpu", parallel_rounds=local,
                               layout="ell", chain="off")
    assert g[3] == c[3]
    for x, y in zip(g[:3], c[:3]):
        np.testing.assert_array_equal(x.view(np.int64), y.view(np.int64))
    if not local:
        return
    # the skip, seen from the scratch the bound passes write
    ell = lmm_ell.ell_from_arrays(a)
    s_, p_, vb_ = lmm_ell.dense_system(ell, cuda)
    w = EllWork(s_.n_v, s_.n_c, s_.wc, torch.float64, cuda)
    w.mb_c.fill_(7.0)
    from simgrid_tpu_torch.kernels.ell_round import ell_init
    ell_init(s_, w, p_, 1e-9, vb_)
    loop = lmm_torch.chunk_loop(s_, w, p_, 1e-9, vb_, True, False, False,
                                100_000)
    loop.run()
    assert int(w.ctrl[LIGHT]) == 0 and int(w.ctrl[IT]) == g[3]
    untouched = bool((w.mb_c == 7.0).all())
    assert untouched == (bind == "none")


def test_k7_global_two_chunks_card_equals_plain(cuda):
    """The global arm (bounds binding) in chunks of half its rounds: the
    minima the previous round's end cleared, and the prep at the second
    chunk's head, give the one-chunk result by bits, card and CPU."""
    a = width_arrays(3, 48, 64, 4, bounds=0.2)
    whole = lmm_torch.solve_arrays(a, 1e-9, device="cpu",
                                   parallel_rounds=False, layout="ell",
                                   chain="off")
    chunk = -(-whole[3] // 2)
    assert whole[3] >= 4
    reset_launch_counts()
    g = lmm_torch.solve_arrays(a, 1e-9, device=cuda, parallel_rounds=False,
                               layout="ell", chain="off", chunk=chunk)
    assert k16.COUNTS["chunk"].n == 2 and path_counts()["ell_prep"] == 2
    c = lmm_torch.solve_arrays(a, 1e-9, device="cpu", parallel_rounds=False,
                               layout="ell", chain="off", chunk=chunk)
    for r in (g, c):
        assert r[3] == whole[3]
        for x, y in zip(r[:3], whole[:3]):
            np.testing.assert_array_equal(x.view(np.int64),
                                          y.view(np.int64))


@pytest.mark.parametrize("prep", [True, False], ids=["prep", "init_only"])
def test_k7_round_outside_a_loop_counts_itself(cuda, prep):
    """Called from the host after its init (and prep, or the init alone:
    the init writes the tables the round reads), K7's round moves IT and
    LIGHT (a_apply's last block commits it), keeps ``rou`` as the plain
    round does, and leaves the ticket and NLOW at 0."""
    from simgrid_tpu_torch.kernels.common import NLOW, TICKET
    from simgrid_tpu_torch.kernels.ell_round import (ell_init, ell_prep,
                                                     ell_round)
    a = width_arrays(3, 96, 64, 4, bounds=0.3)
    ell = lmm_ell.ell_from_arrays(a)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        s_, p_, vb_ = lmm_ell.dense_system(ell, dev)
        w = EllWork(s_.n_v, s_.n_c, s_.wc, torch.float64, dev)
        ell_init(s_, w, p_, 1e-9, vb_)
        if prep:
            ell_prep(s_, w, p_, vb_)
        for _ in range(3):
            ell_round(s_, w, p_, 1e-9, vb_)
        runs.append([t.cpu().clone() for t in (
            w.v_value, w.v_fixed, w.remaining, w.usage, w.light, w.cv_live,
            w.rou, w.cv_upen, w.cv_ev)] + [w.ctrl.cpu().clone()])
    for x, y in zip(runs[0][:-1], runs[1][:-1]):
        assert torch.equal(x, y)
    ctrl = runs[0][-1]
    assert int(ctrl[IT]) == 3 and int(ctrl[LIGHT]) == int(runs[1][-1][LIGHT])
    assert int(ctrl[TICKET]) == int(ctrl[TICKET + 1]) == int(ctrl[NLOW]) == 0


# ---- K4's redesign: single-pass compactions, scratch kept zeroed


def k4_system(seed, V, deg, live_share, dev, all_live=False):
    """A COO system of ``V`` flows with up to ``deg`` elements each (a
    tenth of the weights zero), its flow state, and the shapes a drain
    would repack it to: ``live_share`` of the flows live, or exactly
    the first ``V // 2`` (``all_live``: every flow kept is live)."""
    rng = np.random.default_rng(seed)
    n_c = max(V // 8, 4)
    E = V * deg - rng.integers(0, V)  # not a multiple of anything
    ev = np.sort(rng.integers(0, V, E)).astype(np.int32)
    ec = rng.integers(0, n_c, E).astype(np.int32)
    ew = rng.uniform(0.5, 1.5, E)
    ew[rng.random(E) < 0.1] = 0.0
    if all_live:
        live = np.zeros(V, bool)
        live[rng.permutation(V)[:V // 2]] = True
    else:
        live = rng.random(V) < live_share
    pen = np.where(live, rng.uniform(0.5, 2.0, V), 0.0)
    sys_ = lmm_torch.to_device_system(ev, ec, ew, rng.uniform(1, 9, n_c), V,
                                      torch.float64, dev)
    state = [torch.from_numpy(x).to(dev) for x in (
        pen, rng.uniform(1e4, 1e6, V), rng.uniform(1, 10, V),
        np.arange(V, dtype=np.int32) * 3, np.where(
            rng.random(V) < 0.5, rng.uniform(1, 5, V), -1.0))]
    return sys_, state


def _k4_shapes(sys_, pen):
    E = sys_.n_e
    live_elems = int(((sys_.e_w > 0) & (pen[sys_.e_var.long()] > 0)).sum())
    return (int(pen.shape[0]) // 2, max(-(-(E // 2) // 8) * 8, live_elems),
            live_elems)


def _k4_out(rp):
    return [t.cpu() for t in (*rp.sys[:3], *rp.sys.csr, rp.pen, rp.rem,
                              rp.thresh, rp.ids)] + (
        [] if rp.vb is None else [rp.vb.cpu()])


K4_CASES = {"all_live": (4096, 3, 0.0, True), "one_live": (3001, 4, 0.0,
                                                           False),
            "ragged": (5003, 5, 0.45, False), "big": (100_003, 4, 0.45,
                                                      False)}


@pytest.mark.parametrize("vb", [False, True], ids=["plain", "vbound"])
@pytest.mark.parametrize("case", list(K4_CASES))
def test_k4_repack_card_equals_plain(cuda, case, vb):
    """K4 on the card against ``livefirst_repack_plain`` on the CPU, every
    output array by bits: every flow kept live (``all_live``), a single
    live flow, and V, E and nnz that are no multiple of a tile, with and
    without the rate bounds; then the halved system repacked again (the
    status words the first call left zeroed)."""
    from simgrid_tpu_torch.kernels.livefirst_repack import (
        livefirst_repack, livefirst_repack_plain)
    V, deg, share, all_live = K4_CASES[case]
    outs = []
    for dev in (cuda, torch.device("cpu")):
        sys_, st = k4_system(11, V, deg, share, dev, all_live)
        if case == "one_live":
            pen = torch.zeros_like(st[0])
            pen[V // 3] = 1.5
            st[0] = pen
        fn = livefirst_repack if dev.type == "cuda" else \
            livefirst_repack_plain
        seen = []
        for k in range(2):
            if k:    # flows end, so the live ones fit the next halving
                st[0] = torch.where(torch.arange(st[0].shape[0],
                                                 device=dev) % 5 == 0,
                                    st[0], 0.0)
            vh, eh, le = _k4_shapes(sys_, st[0])
            reset_launch_counts()
            rp = fn(sys_, *st[:4], vh, eh, le, st[4] if vb else None)
            if dev.type == "cuda":
                counts = launch_counts()
                assert counts["livefirst_repack_vbound" if vb
                              else "livefirst_repack"] == 1
            seen.append(_k4_out(rp))
            sys_ = rp.sys
            st = [rp.pen, rp.rem, rp.thresh, rp.ids,
                  rp.vb if vb else st[4][:vh]]
        outs.append(seen)
    for got, want in zip(*outs):
        assert len(got) == len(want)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_k4_scratch_reused_across_shapes(cuda):
    """Repacks of a large system, then a small one, then the large one
    again: the scratch grows once and is reused, and every call equals
    the plain repack by bits."""
    from simgrid_tpu_torch.kernels import livefirst_repack as k4
    key = str(torch.zeros(1, device=cuda).device)
    sizes = (20_011, 3_001, 20_011)
    for i, V in enumerate(sizes):
        outs = []
        for dev in (cuda, torch.device("cpu")):
            sys_, st = k4_system(20 + i, V, 4, 0.4, dev)
            vh, eh, le = _k4_shapes(sys_, st[0])
            fn = k4.livefirst_repack if dev.type == "cuda" else \
                k4.livefirst_repack_plain
            outs.append(_k4_out(fn(sys_, *st[:4], vh, eh, le, st[4])))
        for x, y in zip(*outs):
            assert torch.equal(x, y), (V, i)
        if i == 0:
            held = k4._SCRATCH[key][0].data_ptr()
    assert k4._SCRATCH[key][0].data_ptr() == held
    assert int(k4._SCRATCH[key][0].count_nonzero()) == 0


def chain_arrays(seed=13):
    from simgrid_tpu_torch.workloads.bench_solve import build_arrays
    return build_arrays(np.random.default_rng(seed), 4096, 33000, 3,
                        np.float64)


@pytest.mark.parametrize("cap", [64, 1], ids=["chain", "overflow"])
def test_ell_chain_card_equals_plain(cuda, monkeypatch, cap):
    """The compaction chain (K8 rounds in guarded stages, K9's partition
    and fetch) on the card equals the plain chain on the CPU; with a
    stage cap of 1 both overflow into the dense path, still equal.  The
    default layout and chain on the card take this path."""
    monkeypatch.setattr(lmm_ell, "_CHAIN_STAGE_CAP", cap)
    a = chain_arrays()
    reset_launch_counts()
    g = lmm_torch.solve_arrays(a, 1e-9, device=cuda)
    counts = path_counts()
    assert counts["ell_chain_stage"] == 3 and counts["ell_chain_fetch"] > 0
    assert (counts["ell_init"] > 0) == (cap == 1)
    c = lmm_torch.solve_arrays(a, 1e-9, device="cpu", layout="ell",
                               chain="on")
    assert g[3] == c[3]
    for x, y in zip(g[:3], c[:3]):
        np.testing.assert_array_equal(x.view(np.int64), y.view(np.int64))


def _chain_start(a, dev, fat=False):
    """The chain's first-stage state of ``a`` on ``dev``, armed."""
    ell = lmm_ell.ell_from_arrays(a)
    init = lmm_ell.chain_init(ell, 1e-9, fat)
    sys, pen = lmm_ell._chain_tables([torch.from_numpy(np.array(x)).to(
        dev) for x in (ell.vc_cnst, ell.vc_w, ell.vc_valid, ell.v_penalty,
                       ell.c_bound, ell.c_fatpipe)])
    w = Work(sys.n_v, sys.n_c, torch.float64, dev)
    for t, src in zip((w.v_value, w.v_fixed, w.remaining, w.usage,
                       w.light), init[:5]):
        t.copy_(torch.from_numpy(np.array(src)))
    cs = k9.ChainState(sys, pen, torch.from_numpy(init[5]).to(dev), w)
    from simgrid_tpu_torch.kernels.vc_round import vc_prep
    vc_prep(cs.sys, w, cs.pen)
    k9.chain_arm(cs, 64, sys.n_v // 2, first=True)
    return cs


def _stage_arrays(cs):
    n = int(cs.sys.vcx_ptr[-1])
    return [t.cpu().clone() for t in (
        cs.sys.vc_cnst, cs.sys.vc_w, cs.sys.vc_valid, cs.pen, cs.orig,
        cs.w.v_value[:cs.sys.n_v], cs.w.v_fixed[:cs.sys.n_v], cs.v_final,
        cs.w.ctrl, cs.w.rou, cs.sys.vcx_ptr)] + [
        getattr(cs.sys, k)[:n].cpu().clone()
        for k in ("vcx_idx", "vcx_row", "vcx_w", "vcx_upen")]


def test_kernel_nodes_count_launches(cuda):
    """``superstep_loop.kernel_nodes`` counts the CUDA kernels of one
    captured call without running it (each wrapper first runs for real
    at the shapes, as it does before every count in ``chip_smoke.py``):
    K4 three with and without the rate bounds, K8's round four, K9's
    stage two; no buffer of the state changes on the card, and K4 equals
    the plain repack by bits."""
    from simgrid_tpu_torch.kernels.livefirst_repack import (
        livefirst_repack, livefirst_repack_plain)
    from simgrid_tpu_torch.kernels.vc_round import vc_round
    sys_, st = k4_system(5, 4096, 3, 0.4, cuda)
    sys_c, st_c = k4_system(5, 4096, 3, 0.4, torch.device("cpu"))
    vh, eh, le = _k4_shapes(sys_, st[0])
    for bounds in (False, True):
        vb, vb_c = (st[4], st_c[4]) if bounds else (None, None)
        got = _k4_out(livefirst_repack(sys_, *st[:4], vh, eh, le, vb))
        want = _k4_out(livefirst_repack_plain(sys_c, *st_c[:4], vh, eh, le,
                                              vb_c))
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert k16.kernel_nodes(lambda: livefirst_repack(
            sys_, *st[:4], vh, eh, le, vb)) == 3
    cs = _chain_start(chain_arrays(5), cuda, False)
    vc_round(cs.sys, cs.w, cs.pen, 1e-9, False)
    # the buffers themselves: a stage's wrapper may swap which buffers
    # the state on the host names
    held = (cs.w.ctrl, cs.w.v_value, cs.w.rou)
    before = [t.clone() for t in held]
    half = cs.sys.n_v // 2
    assert k16.kernel_nodes(lambda: vc_round(cs.sys, cs.w, cs.pen, 1e-9,
                                             False)) == 4
    assert k16.kernel_nodes(lambda: k9.chain_stage(cs, half,
                                                   (64, half // 2))) == 2
    torch.cuda.synchronize()
    for x, y in zip(before, held):
        assert torch.equal(x, y)


@pytest.mark.parametrize("short", [False, True], ids=["guard", "short"])
@pytest.mark.parametrize("fat", [False, True], ids=["shared", "fatpipe"])
def test_ell_chain_stage_card_equals_plain(cuda, fat, short):
    """Chain stages from the same state, each after K8's rounds ran until
    the stage's guard stopped them: the kept rows, K8's re-derived entry
    layout (pointers, positions, rows, weights, w / penalty), v_final,
    the control words and rou, by bits.  ``guard``: two stages of half
    the rows; ``short``: one stage that keeps a quarter, fewer than are
    live, so live rows are dropped and the stage raises OVERFLOW."""
    a = chain_arrays(5)
    if fat:
        f = a.c_fatpipe.copy()
        f[:a.n_cnst] = np.random.default_rng(12).random(a.n_cnst) < 0.10
        a = a._replace(c_fatpipe=f)
    from simgrid_tpu_torch.kernels.vc_round import vc_round
    states = []
    for dev in (cuda, torch.device("cpu")):
        cs = _chain_start(a, dev, fat)
        seen = []
        for k in range(1 if short else 2):
            for _ in range(64):
                vc_round(cs.sys, cs.w, cs.pen, 1e-9, fat)
            half = cs.sys.n_v // (4 if short else 2)
            k9.chain_stage(cs, half, (64, half // 2))
            seen += _stage_arrays(cs)
        assert int(cs.w.ctrl[OVERFLOW]) == int(short)
        states.append(seen)
    for x, y in zip(*states):
        assert torch.equal(x, y)


def test_ell_chain_graph_built_once(cuda, monkeypatch):
    """A second solve of the same arrays replays the chain's graph: no
    graph is built and no K8 or K9 wrapper is called from the host."""
    a = chain_arrays()
    g = lmm_torch.solve_arrays(a, 1e-9, device=cuda)
    reset_launch_counts()
    g2 = lmm_torch.solve_arrays(a, 1e-9, device=cuda)
    host = launch_counts()
    assert k16.BUILDS["graphs"] == 0
    assert not any(host.get(n, 0) for n in (
        "vc_round", "vc_prep", "ell_chain_arm", "ell_chain_stage",
        "ell_chain_fetch"))
    assert path_counts()["ell_chain_stage"] == 3
    for x, y in zip(g[:3], g2[:3]):
        np.testing.assert_array_equal(x.view(np.int64), y.view(np.int64))
    assert g[3] == g2[3]


@pytest.mark.parametrize("case", ["tight", "fatpipe"])
def test_ell_chain_variants_card_equal_plain(cuda, case):
    """The chain at tight padding (exact row widths, V a multiple of
    4,096) and with 10% of its constraints FATPIPE, card against the
    plain chain on the CPU."""
    from simgrid_tpu_torch.workloads.bench_solve import build_arrays
    pad = "tight" if case == "tight" else "pow2"
    a = build_arrays(np.random.default_rng(13), 4096, 33000, 3,
                     np.float64, pad)
    if case == "fatpipe":
        f = a.c_fatpipe.copy()
        f[:a.n_cnst] = np.random.default_rng(12).random(a.n_cnst) < 0.10
        a = a._replace(c_fatpipe=f)
    reset_launch_counts()
    g = lmm_torch.solve_arrays(a, 1e-9, device=cuda, pad=pad)
    assert path_counts()["ell_chain_stage"] >= 1
    c = lmm_torch.solve_arrays(a, 1e-9, device="cpu", layout="ell",
                               chain="on", pad=pad)
    assert g[3] == c[3]
    for x, y in zip(g[:3], c[:3]):
        np.testing.assert_array_equal(x.view(np.int64), y.view(np.int64))


@pytest.mark.parametrize("mode", list(churn.MODES))
def test_churn_ell_card_equals_plain(cuda, mode):
    """The churn at 3,000 variables under the card's default layout (ELL,
    the chain where eligible) against the plain path with
    ``layout="ell"``, ``chain="on"`` on the CPU, strict: every step bit
    for bit, ELL throughout, no fallback."""
    kw = dict(n_v=3000, clusters=40, chain=12, churn=0.02, steps=5,
              states=True, strict=True)
    _, g = churn.run_churn(mode, device=cuda, **kw)
    _, c = churn.run_churn(mode, device="cpu", layout="ell",
                           chain_mode="on", **kw)
    assert same_states(g["states"], c["states"])
    assert g["solver_fallbacks"] == c["solver_fallbacks"] == 0
    assert (g["rounds"], g["bytes_full"], g["bytes_delta"]) == \
        (c["rounds"], c["bytes_full"], c["bytes_delta"])
    if mode != "legacy-subset":
        assert g["last_layout"] == "ell" and g["warm_ell_fallbacks"] == 0
    if mode == "warm-selective":
        assert g["launches"]["warm_init_ell"] == kw["steps"]
        assert g["launches"]["delta_scatter_ell"] > 0


def test_warm_init_ell_card_equals_plain(cuda):
    """K6's ELL arm from the same previous state, card against plain."""
    a = width_arrays(8, 96, 64, 4, fat=0.1)
    ell = lmm_ell.ell_from_arrays(a)
    rng = np.random.default_rng(8)
    mc_pad = modified_index(rng.choice(96, 20, replace=False))
    n_c, wc = ell.cv_var.shape
    n_v = ell.vc_cnst.shape[0]
    prev = dict(v_value=rng.uniform(0, 1, n_v),
                remaining=rng.uniform(0, 5, n_c),
                usage=rng.uniform(0, 5, n_c),
                cv_live=rng.random((n_c, wc)) < 0.5)
    out = []
    for dev in (cuda, torch.device("cpu")):
        sys, pen, _ = lmm_ell.dense_system(ell, dev)
        w = EllWork(sys.n_v, sys.n_c, sys.wc, torch.float64, dev)
        for name, x in prev.items():
            getattr(w, name).copy_(torch.from_numpy(x))
        k6.warm_init_ell(sys, w, pen, mc_pad, 1e-9)
        out.append([getattr(w, n).cpu() for n in (
            "v_value", "v_fixed", "remaining", "usage", "light", "cv_live",
            "ctrl", "c_mod", "v_mod", "v_has")])
    for x, y in zip(*out):
        assert torch.equal(x, y)


def test_ell_delta_scatter_card_equals_plain(cuda):
    """K5's ELL use: six flat runs, validity written as weight > 0."""
    rng = np.random.default_rng(6)
    shapes = [((64, 8), np.int32), ((64, 8), np.float64), ((64, 8), bool),
              ((300, 4), np.int32), ((300, 4), bool), ((300, 4), np.float64)]
    masters = [(rng.uniform(0, 50, s) if dt != bool else rng.random(s) < 0.5
                ).astype(dt) for s, dt in shapes]
    n, k = 16, 13
    runs = []
    for ti, (s, dt) in enumerate(shapes):
        ix = np.sort(rng.choice(s[0] * s[1], k, replace=False))
        vals = rng.choice([-1.0, 0.0, 0.5, 3.0], k)
        idx = np.full(n, ix[0], np.float64)
        v = np.full(n, vals[0])
        idx[:k], v[:k] = ix, vals
        runs += [idx, v]
    payload = torch.from_numpy(np.concatenate(runs))
    layout = [(ti, 2 * n * ti, n) for ti in range(6)]
    g = [torch.from_numpy(m.copy()).to(cuda) for m in masters]
    c = [torch.from_numpy(m.copy()) for m in masters]
    reset_launch_counts()
    ell_delta_scatter(payload.to(cuda), layout, g)
    assert path_counts()["delta_scatter_ell"] == 1
    ell_delta_scatter(payload, layout, c)
    for x, y in zip(g, c):
        assert torch.equal(x.cpu(), y)


def padded_runs(rng, targets, n, k, positive=()):
    """A payload of one run a target (``k`` distinct flat slots padded
    to ``n`` by repeating the first (index, value) pair, as the warm
    solver pads) and its layout; values fit each target's kind."""
    chunks, layout, off = [], [], 0
    for ti, t in enumerate(targets):
        ix = rng.choice(t.numel(), k, replace=False).astype(np.float64)
        if t.dtype == torch.int32:
            vals = rng.integers(-5, 900, k).astype(np.float64)
        elif t.dtype == torch.bool and ti not in positive:
            vals = rng.choice([0.0, 1.0, -2.0], k)
        else:
            vals = rng.choice([-1.5, 0.0, 0.25, 3.0, 1e300], k)
        idx = np.full(n, ix[0])
        v = np.full(n, vals[0])
        idx[:k], v[:k] = ix, vals
        layout.append((ti, off, n))
        chunks += [idx, v]
        off += 2 * n
    return torch.from_numpy(np.concatenate(chunks)), layout


def scatter_targets(arm):
    """The K5 wrapper of one arm and zero targets in its field order."""
    from simgrid_tpu_torch.kernels import transition_scatter as k5
    if arm == "ell":
        return ell_delta_scatter, "delta_scatter_ell", k5.ELL_POSITIVE, [
            torch.zeros((64, 8), dtype=torch.int32),
            torch.zeros((64, 8), dtype=torch.float64),
            torch.zeros((64, 8), dtype=torch.bool),
            torch.zeros((300, 4), dtype=torch.int32),
            torch.zeros((300, 4), dtype=torch.bool),
            torch.zeros((300, 4), dtype=torch.float64)]
    if arm == "delta":
        kinds = (torch.int32, torch.int32, torch.float64, torch.float64,
                 torch.bool, torch.float64, torch.float64)
        return delta_scatter, "delta_scatter", (), [
            torch.zeros(500, dtype=dt) for dt in kinds]
    kinds = (torch.int32, torch.int32, torch.float64, torch.float64,
             torch.float64, torch.float64, torch.float64, torch.float64)
    return transition_scatter, "transition_scatter", (), [
        torch.zeros(500, dtype=dt) for dt in kinds]


@pytest.mark.parametrize("arm", ["transition", "delta", "ell"])
def test_scatter_arms_one_launch_card_equals_plain(cuda, arm):
    """K5 in each arm, every target of the arm written in one call with
    padded duplicates: card == plain by bits, one CUDA launch a call
    (the kernel nodes of the captured call), one count a call."""
    fn, name, positive, base = scatter_targets(arm)
    payload, layout = padded_runs(np.random.default_rng(15), base, 64, 41,
                                  positive)
    g = [t.to(cuda) for t in base]
    c = [t.clone() for t in base]
    reset_launch_counts()
    fn(payload.to(cuda), layout, g)
    assert launch_counts()[name] == 1
    assert fn(payload, layout, c) is True
    for x, y in zip(g, c):
        assert torch.equal(x.cpu(), y)
    assert all(bool(t.any()) for t in c)
    pg = payload.to(cuda)
    assert k16.kernel_nodes(lambda: fn(pg, layout, g)) == 1


def test_scatter_every_kind_in_one_call_card_equals_plain(cuda):
    """One K5 call over an int32, a float32, a float64, a bool and a
    positive-bool target (``KIND_POS``), runs padded with duplicates,
    in one launch; a layout with two runs on one target is refused on
    the card as on the CPU."""
    from simgrid_tpu_torch.kernels import transition_scatter as k5
    base = [torch.zeros(700, dtype=torch.int32),
            torch.zeros((30, 9), dtype=torch.float32),
            torch.zeros(300, dtype=torch.float64),
            torch.zeros(300, dtype=torch.bool),
            torch.zeros((40, 8), dtype=torch.bool)]
    fields = ("i", "f", "d", "b", "p")
    payload, layout = padded_runs(np.random.default_rng(16), base, 128, 97,
                                  (4,))
    count = k5.counter("scatter_kinds_test")
    pg = payload.to(cuda)
    g = [t.to(cuda) for t in base]
    c = [t.clone() for t in base]
    k5._scatter(pg, layout, g, fields, count, (4,))
    assert count.n == 1
    k5._scatter(payload, layout, c, fields, count, (4,))
    for x, y in zip(g, c):
        assert torch.equal(x.cpu(), y)
    assert bool(c[3].any()) and bool(c[4].any())
    assert k16.kernel_nodes(lambda: k5._scatter(
        pg, layout, g, fields, count, (4,))) == 1
    with pytest.raises(ValueError, match="one target"):
        k5._scatter(pg, layout[:2] + [(1,) + layout[2][1:]], g, fields,
                    count, (4,))


#: K6's edge cases: which constraints are modified, and the system's
#: FATPIPE share and bound scale
K6_CASES = {"one": ("one", 0.0, 1.0), "all": ("all", 0.0, 1.0),
            "dark": ("half", 0.0, 0.0), "fatpipe": ("half", 0.3, 1.0)}


def k6_arrays(seed, fat, bound_scale):
    """A random system with penalties negative, zero, infinite and
    positive, a fifth of the elements deleted (weight 0), ``fat`` of the
    constraints FATPIPE, the bounds scaled (0: no light row)."""
    a = width_arrays(seed, 96, 8, 4, fat=fat)
    rng = np.random.default_rng(seed + 1)
    pen = a.v_penalty.copy()
    n_v = a.n_var
    pick = rng.permutation(n_v)
    pen[pick[:n_v // 10]] = -1.0
    pen[pick[n_v // 10:n_v // 5]] = np.inf
    pen[pick[n_v // 5:n_v // 3]] = rng.uniform(0.5, 4.0, n_v // 3 - n_v // 5)
    e_w = a.e_w.copy()
    e_w[:a.n_elem][rng.random(a.n_elem) < 0.2] = 0.0
    return a._replace(v_penalty=pen, e_w=e_w, c_bound=a.c_bound * bound_scale)


def k6_modified(case, n_cnst, n_c, rng):
    """A single real constraint, every slot, or half the real ones."""
    if case == "one":
        return modified_index([int(rng.integers(3, n_cnst))])
    if case == "all":
        return modified_index(np.arange(n_c))
    return modified_index(rng.choice(n_cnst, n_cnst // 2, replace=False))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", list(K6_CASES))
@pytest.mark.parametrize("arm", ["coo", "ell"])
def test_warm_init_edge_cases_card_equal_plain(cuda, arm, case, dtype):
    """K6 (COO and ELL) from the same previous state, card == plain by
    bits over every output (the whole control row included): a single
    modified constraint padded to 8, every constraint modified, no
    light row, FATPIPE rows; penalties negative, zero and infinite and
    deleted elements in every case; one CUDA launch a call."""
    which, fat, scale = K6_CASES[case]
    a = k6_arrays(21, fat, scale)
    a = a._replace(e_w=a.e_w.astype(dtype), c_bound=a.c_bound.astype(dtype),
                   v_penalty=a.v_penalty.astype(dtype))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    eps = 1e-9 if dtype == np.float64 else 1e-5
    rng = np.random.default_rng(22)
    n_c, n_v = len(a.c_bound), len(a.v_penalty)
    mc = k6_modified(which, a.n_cnst, n_c, rng)
    ell = lmm_ell.ell_from_arrays(a) if arm == "ell" else None
    wc = ell.cv_var.shape[1] if arm == "ell" else 0
    prev = dict(v_value=rng.uniform(0, 1, n_v), remaining=rng.uniform(0, 5, n_c),
                usage=rng.uniform(0, 5, n_c))
    if arm == "ell":
        prev["cv_live"] = rng.random((n_c, wc)) < 0.5
    names = ["v_value", "v_fixed", "remaining", "usage", "light", "c_mod",
             "ctrl"] + (["cv_live", "v_mod", "v_has"] if arm == "ell" else [])
    out, calls = [], []
    for dev in (cuda, torch.device("cpu")):
        if arm == "ell":
            sys_, pen, _ = lmm_ell.dense_system(ell, dev)
            w = EllWork(n_v, n_c, wc, tdt, dev)
            fn = k6.warm_init_ell
        else:
            sys_ = lmm_torch.to_device_system(
                a.e_var, a.e_cnst, a.e_w, a.c_bound, n_v, tdt, dev,
                c_fatpipe=a.c_fatpipe)
            pen = torch.from_numpy(a.v_penalty).to(dev)
            w = Work(n_v, n_c, tdt, dev)
            fn = k6.warm_init
        for name, x in prev.items():
            getattr(w, name).copy_(torch.from_numpy(x))
        args = (sys_, w, pen, mc, eps)
        fn(*args)
        out.append([getattr(w, n).cpu() for n in names])
        calls.append(lambda f=fn, a_=args: f(*a_))
    for name, x, y in zip(names, *out):
        assert torch.equal(x, y), name
    light = int(out[1][names.index("ctrl")][LIGHT])
    if case in ("dark", "all"):
        assert (light == 0) == (case == "dark")
    assert k16.kernel_nodes(calls[0]) == 1


@pytest.mark.parametrize("arm", ["coo", "ell"])
def test_warm_init_unsorted_index_raises_and_card_goes_on(cuda, arm):
    """A card call of K6 with an index that is not sorted raises
    ``ValueError`` before any launch, and so does a device index
    (``TypeError``): the CUDA context stays usable, and the next call
    with the sorted index equals the plain version by bits."""
    a = k6_arrays(23, False, 1.0)
    rng = np.random.default_rng(24)
    n_c, n_v = len(a.c_bound), len(a.v_penalty)
    mc = k6_modified("half", a.n_cnst, n_c, rng)
    bad = mc[::-1].copy()
    assert (np.diff(bad) < 0).any()
    names = ["v_value", "v_fixed", "remaining", "usage", "light", "c_mod",
             "ctrl"]
    v_prev = torch.from_numpy(rng.uniform(0, 1, n_v))
    out = []
    for dev in (cuda, torch.device("cpu")):
        if arm == "ell":
            ell = lmm_ell.ell_from_arrays(a)
            sys_, pen, _ = lmm_ell.dense_system(ell, dev)
            w = EllWork(n_v, n_c, ell.cv_var.shape[1], torch.float64, dev)
            fn = k6.warm_init_ell
        else:
            sys_ = lmm_torch.to_device_system(
                a.e_var, a.e_cnst, a.e_w, a.c_bound, n_v, torch.float64,
                dev, c_fatpipe=a.c_fatpipe)
            pen = torch.from_numpy(a.v_penalty).to(dev)
            w = Work(n_v, n_c, torch.float64, dev)
            fn = k6.warm_init
        w.v_value.copy_(v_prev)
        if dev.type == "cuda":
            reset_launch_counts()
            with pytest.raises(ValueError, match="sorted"):
                fn(sys_, w, pen, bad, 1e-9)
            with pytest.raises(TypeError):
                fn(sys_, w, pen, torch.from_numpy(mc).to(dev), 1e-9)
            torch.cuda.synchronize()
            assert launch_counts()[fn.__name__] == 0
        fn(sys_, w, pen, mc, 1e-9)
        out.append([getattr(w, n).cpu() for n in names])
    for name, x, y in zip(names, *out):
        assert torch.equal(x, y), name


FAULT_MODES = {"f64-k8": (np.float64, 8, False),
               "f64-k1-bounds": (np.float64, 1, True),
               "f32-k8": (np.float32, 8, False),
               "f64-k16-starved": (np.float64, 16, False)}


@pytest.mark.parametrize("mode", list(FAULT_MODES))
def test_fault_tape_drain_card_equals_plain(cuda, mode):
    """K2's event arm and K3's tape arm through a seeded campaign over a
    3,000-flow dragonfly drain, repacks included (and, starved, a round
    budget that ends slots inside the graph), one graph launch a
    superstep."""
    from simgrid_tpu_torch.workloads import fault_drain
    s = dragonfly.build_system(3000)
    tape = fault_drain.tape_for(s.e_cnst, s.e_w, s.c_bound, seed=7,
                                horizon=0.2, mtbf=2.0, mttr=0.005,
                                link_names=dragonfly.link_names(s))
    dtype, k, bounds = FAULT_MODES[mode]
    kw = {}
    if bounds:
        rng = np.random.default_rng(4)
        kw["v_bound"] = rng.uniform(2e9, 2e10, 3000).astype(dtype)
    if mode.endswith("starved"):
        kw["superstep_rounds"] = 40
    sims = []
    for dev in (cuda, torch.device("cpu")):
        reset_launch_counts()
        sim = DrainSim(s.e_var, s.e_cnst, s.e_w.astype(dtype),
                       s.c_bound.astype(dtype), s.sizes, eps=1e-5,
                       dtype=dtype, repack_min=64, device=dev, superstep=k,
                       tape=tape, **kw)
        sim.run()
        sims.append((sim, path_counts(), launch_counts(),
                     k16.device_tally()))
    (g, lc, host, tally), (c, _, _, _) = sims
    assert g.events == c.events and g.t == c.t
    assert g.fault_events == c.fault_events and len(g.fault_events) > 10
    assert (g.advances, g.supersteps, g.repacks, g.rounds) == \
        (c.advances, c.supersteps, c.repacks, c.rounds)
    assert lc["drain_advance_event"] > 0 and lc["superstep_commit_tape"] > 0
    assert torch.equal(g.sys.c_bound.cpu(), c.sys.c_bound)
    assert_graph_drain(g, c, host, tally)


@pytest.mark.parametrize("case", [("allreduce", "rdb", 64, "nic", 1 << 20),
                                  ("allreduce", "lr", 16, "star", 1 << 14),
                                  ("alltoall", "pairwise", 12, "ring",
                                   4096.0)])
def test_collective_tape_card_equals_plain_and_maestro(cuda, case):
    """K2's event arm, K3's collective arm and K10 walk a compiled DAG on
    the card: equal to the plain path on the CPU and to the host maestro
    on the card (completions, activations, the Kahan pair)."""
    from simgrid_tpu_torch.collectives import CollectiveSpec, HostMaestro
    dc = CollectiveSpec(*case).build()
    out = []
    for dev in (cuda, torch.device("cpu")):
        reset_launch_counts()
        sim = dc.make_sim(superstep=8, device=dev)
        sim.run()
        out.append((sim, path_counts()))
    (g, lc), (c, _) = out
    m = HostMaestro(dc, device=cuda)
    m.run()
    assert g.events == c.events == m.events
    assert g.collective_events == c.collective_events == m.collective_events
    assert tuple(g._coll_clk.tolist()) == tuple(c._coll_clk.tolist()) \
        == m.clock
    assert lc["superstep_commit_coll"] > 0 and lc["dag_walk"] > 0


def test_dag_walk_card_equals_plain(cuda):
    """K10 over a random DAG with several completions per successor in
    one advance: the counts, the dates it frees and the pending count."""
    rng = np.random.default_rng(8)
    V, E = 20_000, 80_000
    src = rng.integers(0, V, E).astype(np.int32)
    dst = rng.integers(0, V, E).astype(np.int32)
    dst[::97] = V                      # pad rows, dropped
    pred = np.bincount(dst[dst < V], minlength=V).astype(np.int32)
    done = rng.random(V) < 0.3
    exec_cost = rng.uniform(0, 1e-3, V)
    out = []
    for dev in (cuda, torch.device("cpu")):
        w = Work(V, 4, torch.float64, dev)
        w.ctrl[ADV_OK] = 1
        w.fctrl[T_SUM] = 0.125
        w.done.copy_(torch.from_numpy(done))
        p = torch.from_numpy(pred.copy()).to(dev)
        r = torch.full((V,), float("inf"), dtype=torch.float64, device=dev)
        dag_walk(w, torch.from_numpy(src).to(dev),
                 torch.from_numpy(dst).to(dev), p, r,
                 torch.from_numpy(exec_cost).to(dev))
        out.append((p.cpu(), r.cpu(), int(w.ctrl[PENDING])))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert out[0][2] == out[1][2] > 0


# ---------------------------------------------------------------------------
# Fleets: K11 and the replica axis of K1-K3
# ---------------------------------------------------------------------------


def _fleet_plan(dev, flows=2000, superstep=8, dtype=np.float64):
    from simgrid_tpu_torch.parallel.campaign import ScenarioPlan
    s = dragonfly.build_system(flows)
    return s, ScenarioPlan(s.e_var, s.e_cnst, s.e_w, s.c_bound, s.sizes,
                           link_names=dragonfly.link_names(s), eps=1e-5,
                           superstep=superstep, device=dev, dtype=dtype)


def _fleet_specs(s):
    from simgrid_tpu_torch.parallel.campaign import ScenarioSpec
    return [ScenarioSpec(seed=42, fault_mtbf=100.0, fault_mttr=0.1,
                         fault_horizon=2.0),
            ScenarioSpec(seed=1, bw_scale=1.2, size_scale=1.05,
                         dead_flows=(3, 17), elem_w={5: 0.5, 40: 2.0})]


def _rows(sim):
    return [t.cpu().clone() for t in (sim.sys.c_bound, sim._pen, sim._rem,
                                      sim._thresh, sim.sys.e_w)]


def _k11_fleet(case, dev):
    """(fleet, its row to admit into, the admitted overrides and tape) of
    a K11 card case: the dragonfly fleet (float64 or float32, per-replica
    weights, tapes) or a collective fleet."""
    from simgrid_tpu_torch.collectives import CollectiveSpec
    from simgrid_tpu_torch.ops.lmm_batch import ReplicaOverrides
    from simgrid_tpu_torch.parallel.campaign import ScenarioSpec
    from simgrid_tpu_torch.workloads import collective_fleet as cf
    if case == "collective":
        cs = CollectiveSpec("allreduce", "rdb", 32, "nic", 1 << 20, bw=1e9)
        specs = cf.fleet_specs(cs, 0.05, 4)
        plan = cf.fleet_campaign(cs, specs, dev).plan
        fresh = ScenarioSpec(seed=50, bw_scale=1.15, size_scale=0.95,
                             collective=cs, label="admitted")
        return (plan.executor(specs), 1, plan.overrides_for(fresh),
                plan.tape_for(fresh))
    s, plan = _fleet_plan(dev, dtype=np.float64 if case == "f64"
                          else np.float32)
    ov = ReplicaOverrides(0.8, 1.3, {7: 0.5, 9: 2.0}, {11: 3.0}, (0, 1, 2),
                          {12: 0.25})
    return (plan.executor(_fleet_specs(s), width=3, tape_slots=64), 2, ov,
            plan.tape_for(_fleet_specs(s)[0]))


def _k11_rows(sim):
    ts = [sim.sys.c_bound, sim._pen, sim._rem, sim._thresh, sim.sys.e_w]
    ts += list(sim._tape or ()) + list(sim._coll or ())
    return [t.cpu().clone() for t in ts]


def _k11_counts(lc):
    return {k: v for k, v in lc.items()
            if k.startswith("fleet_") and v}


@pytest.mark.parametrize("case", ["f64", "f32", "collective"])
def test_k11_birth_and_admission_card_equal_plain(cuda, case):
    """K11 at birth (pad slots in every payload row) and at the
    admission of one row (state, tape row, weight row or a collective
    fleet's DAG-walk rows), on the card and through the plain version,
    by bits on every output; one CUDA launch a call, by the host
    counters and by the kernel nodes of one captured call of each
    entry."""
    from simgrid_tpu_torch.kernels import fleet_materialize as k11
    from simgrid_tpu_torch.ops.lmm_batch import (_pack_elem_w,
                                                 _pack_overrides)
    out = []
    for dev in (cuda, torch.device("cpu")):
        reset_launch_counts()
        sim, lane, ov, tape = _k11_fleet(case, dev)
        born = _k11_rows(sim)
        at_birth = _k11_counts(path_counts())
        if sim.has_coll:
            sim._coll[0][lane].fill_(3)
        if sim._alive[lane]:
            sim.retire(lane)
        sim.admit_lane(lane, ov, tape)
        out.append((born, _k11_rows(sim), at_birth,
                    _k11_counts(path_counts()), sim))
    for a, b in zip(out[0][0] + out[0][1], out[1][0] + out[1][1]):
        assert torch.equal(a, b)
    g, lane = out[0][4], (1 if case == "collective" else 2)
    arm = "_coll" if g.has_coll else ""
    assert out[0][2] == {"fleet_materialize" + arm: 1}
    assert out[0][3] == {"fleet_materialize" + arm: 1, "fleet_admit" + arm: 1}
    if g.has_coll:
        assert not g._coll[2][lane].any()
        assert torch.equal(g._coll[0][lane], g._coll_base[0])
    # one kernel node a call of each entry, into fresh outputs
    ovs = list(g.overrides)
    pay = _pack_overrides(ovs, g.n_c, g.n_v)
    ei, ewv = _pack_elem_w(ovs, g.sys.n_e, g.dtype)
    fresh = [torch.empty_like(t) for t in (g.sys.c_bound, g._pen, g._rem,
                                          g._thresh, g.sys.e_w)]
    coll = ([torch.empty_like(t) for t in g._coll], g._coll_base) \
        if g.has_coll else None

    def birth():
        k11.materialize(g._base_dev, pay, fresh[:4], g.done_eps, True,
                        ew=(g._base_ew, fresh[4], ei, ewv)
                        if g.batch_w else None, coll=coll)
    row = (np.array([0.5]), np.array([3], np.int32), np.ones(1, g.dtype))
    pay1 = _pack_overrides([g.overrides[lane]], g.n_c, g.n_v, (2, 1, 4))
    ei1, ewv1 = _pack_elem_w([g.overrides[lane]], g.sys.n_e, g.dtype, 1)

    def admit():
        k11.admit(g._base_dev, pay1, fresh[:4], 1, g.done_eps, True,
                  ew=(g._base_ew, fresh[4], ei1, ewv1)
                  if g.batch_w else None,
                  tape=(g._tape, row) if g.has_tape else None, coll=coll)
    for fn in (birth, admit):
        fn()
        assert k16.kernel_nodes(fn) == 1
    torch.cuda.synchronize()
    assert torch.equal(fresh[0][1].cpu(), out[0][1][0][lane])


def test_fleet_b3_one_dead_card_equals_plain(cuda):
    """K1-K3 at B = 3, a faulted replica, a swept one with per-replica
    weights and a row dead from birth: the card equals the plain fleet
    on the CPU by bits, and the dead row comes back unchanged."""
    runs = []
    for dev in (cuda, torch.device("cpu")):
        s, plan = _fleet_plan(dev)
        sim = plan.executor(_fleet_specs(s), width=3)
        born = _rows(sim)
        reset_launch_counts()
        sim.run()
        runs.append((sim, born, _rows(sim), path_counts()))
    (g, g0, g1, lc), (c, _, _, _) = runs
    for b in range(3):
        rg, rc = g.replicas[b], c.replicas[b]
        assert rg.events == rc.events and rg.t == rc.t
        assert rg.fault_events == rc.fault_events
    assert g.replicas[0].fault_events and not g.replicas[2].events
    for a, b in zip(g0, g1):
        assert torch.equal(a[2], b[2])
    assert g.pad_events == 0
    for name in ("lmm_init_fleet", "lmm_round_fleet",
                 "drain_advance_event_fleet", "superstep_commit_tape_fleet",
                 "superstep_reset_fleet", "superstep_finish_fleet"):
        assert lc[name] > 0, name


def test_fleet_b1_equals_solo_on_card(cuda):
    """A fleet of one is the solo drain, by bits, on the card."""
    s, plan = _fleet_plan(cuda)
    for spec in _fleet_specs(s):
        sim = plan.executor([spec])
        sim.run()
        solo = plan.solo(spec)
        rep = sim.replicas[0]
        assert rep.events == solo.events and rep.t == solo.t
        assert rep.fault_events == solo.fault_events


@pytest.mark.parametrize("case", ["bounds_fatpipe", "global", "batch_w"])
def test_solve_arrays_batch_card_equals_plain(cuda, case):
    """K1's bound, FATPIPE and global arms with the replica axis, whole
    solves of B = 4 replicas, card against the plain fleet."""
    from simgrid_tpu_torch.ops.lmm_batch import solve_arrays_batch
    rng = np.random.default_rng(5)
    n_c, n_v, deg, nb = 400, 3000, 3, 4
    E = n_v * deg
    e_var = np.repeat(np.arange(n_v, dtype=np.int32), deg)
    e_cnst = rng.integers(0, n_c, E).astype(np.int32)
    e_w = rng.uniform(0.5, 1.5, E)
    cb = rng.uniform(1.0, 10.0, (nb, n_c))
    pen = np.ones((nb, n_v))
    pen[1, ::9] = 0.0
    vb = np.full((nb, n_v), -1.0)
    fat = np.zeros(n_c, bool)
    kw = {}
    if case == "batch_w":
        e_w = e_w * rng.uniform(0.5, 1.5, (nb, E))
    else:
        vb = np.where(rng.random((nb, n_v)) < 0.5,
                      rng.uniform(0.001, 0.01, (nb, n_v)), -1.0)
        fat[rng.choice(n_c, 40, replace=False)] = True
    if case == "global":
        kw["parallel_rounds"] = False
    out = [solve_arrays_batch(e_var, e_cnst, e_w, cb, fat, pen, vb, 1e-9,
                              device=dev, **kw)
           for dev in (cuda, torch.device("cpu"))]
    for a, b in zip(*out):
        assert np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# Collective fleets: K10's replica arm, K3's collective arm and K2's event
# arm on a fleet, K11's collective birth and admission
# ---------------------------------------------------------------------------


def test_dag_walk_fleet_card_equals_plain(cuda):
    """K10's replica arm over a random DAG, three replicas with their own
    completions and clocks, one whose advance did not commit (it moves
    nothing)."""
    rng = np.random.default_rng(9)
    V, E, B = 5_000, 20_000, 3
    src = rng.integers(0, V, E).astype(np.int32)
    dst = rng.integers(0, V, E).astype(np.int32)
    dst[::89] = V
    pred = np.bincount(dst[dst < V], minlength=V).astype(np.int32)
    done = rng.random((B, V)) < 0.3
    exec_cost = rng.uniform(0, 1e-3, V)
    out = []
    for dev in (cuda, torch.device("cpu")):
        w = Work(V, 4, torch.float64, dev, B=B)
        w.ctrl[:, ADV_OK] = torch.tensor([1, 0, 1], dtype=torch.int32)
        w.fctrl[:, T_SUM] = torch.tensor([0.125, 0.25, 0.5],
                                         dtype=torch.float64)
        w.done.copy_(torch.from_numpy(done))
        p = torch.from_numpy(np.tile(pred, (B, 1))).to(dev)
        r = torch.full((B, V), float("inf"), dtype=torch.float64,
                       device=dev)
        reset_launch_counts()
        dag_walk(w, torch.from_numpy(src).to(dev),
                 torch.from_numpy(dst).to(dev), p, r,
                 torch.from_numpy(exec_cost).to(dev))
        out.append((p.cpu(), r.cpu(), w.ctrl[:, PENDING].cpu(),
                    path_counts()))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert torch.equal(out[0][2], out[1][2])
    assert out[1][2][1] == 0 and out[1][2][0] > 0
    assert torch.equal(out[0][0][1], torch.from_numpy(pred))
    assert out[0][3]["dag_walk_fleet"] == 1


def test_k11_coll_card_equals_plain(cuda):
    """K11's collective arm: a birth (every row's state and DAG-walk
    rows) and an admission (one row) in one launch each, card against
    plain by bits, the clock pairs at zero."""
    from simgrid_tpu_torch.kernels import fleet_materialize as k11
    from simgrid_tpu_torch.ops.lmm_batch import (ReplicaOverrides,
                                                 _pack_overrides)
    rng = np.random.default_rng(2)
    B, C, V = 5, 400, 3_000
    row = (rng.integers(0, 4, V).astype(np.int32),
           np.where(rng.random(V) < 0.1, 1e-3, np.inf))
    base = [rng.uniform(1, 10, C), rng.uniform(1e3, 1e6, V),
            rng.uniform(1e2, 1e6, V), np.ones(V)]
    ovs = [ReplicaOverrides(1.0 + 0.1 * b, 1.0 - 0.05 * b,
                            {b: 0.5, 100 + b: 2.0}, {7 * b: 3.0})
           for b in range(B)]
    pay = _pack_overrides(ovs, C, V)
    pay1 = _pack_overrides(ovs[2:3], C, V, (2, 1, 1))
    out = []
    for dev in (cuda, torch.device("cpu")):
        coll = (torch.full((B, V), -7, dtype=torch.int32, device=dev),
                torch.full((B, V), 0.5, dtype=torch.float64, device=dev),
                torch.full((B, 2), 0.25, dtype=torch.float64, device=dev))
        state = [torch.zeros((B, n), dtype=torch.float64, device=dev)
                 for n in (C, V, V, V)]
        base_t = [torch.from_numpy(a).to(dev) for a in base]
        rows = tuple(torch.from_numpy(a).to(dev) for a in row)
        reset_launch_counts()
        k11.materialize(base_t, pay, state, 1e-4, True, coll=(coll, rows))
        born = [t.cpu().clone() for t in (*coll, *state)]
        coll[0][3].fill_(1)
        coll[1][3].fill_(9.0)
        coll[2][3].fill_(2.0)
        k11.admit(base_t, pay1, state, 3, 1e-4, True, coll=(coll, rows))
        out.append((born, [t.cpu() for t in (*coll, *state)],
                    _k11_counts(path_counts())))
    for a, b in zip(out[0][0] + out[0][1], out[1][0] + out[1][1]):
        assert torch.equal(a, b)
    assert torch.equal(out[0][1][0][3], torch.from_numpy(row[0]))
    assert not out[0][1][2].any()
    assert torch.equal(out[0][1][3][3], out[0][0][3][2])
    assert out[0][2] == {"fleet_materialize_coll": 1, "fleet_admit_coll": 1}


def test_collective_fleet_card_equals_plain(cuda):
    """A collective fleet of four (plain, bandwidth, one uplink, a fault
    campaign) with an admission after the first superstep: the card
    equals the plain fleet on the CPU in every lane's completions,
    activations, fault events and Kahan pair, lane 0 equals the tape
    drain of the compiled collective, and every collective arm
    launched."""
    from simgrid_tpu_torch.collectives import CollectiveSpec
    from simgrid_tpu_torch.parallel.campaign import ScenarioSpec
    from simgrid_tpu_torch.workloads import collective_fleet as cf
    from simgrid_tpu_torch.workloads import fleet_run
    cs = CollectiveSpec("allreduce", "rdb", 64, "nic", 1 << 20, bw=1e9)
    ref = cs.build().make_sim(superstep=cf.SUPERSTEP, device=cuda)
    ref.run()
    specs = cf.fleet_specs(cs, ref.t, 4)
    fresh = ScenarioSpec(seed=50, bw_scale=1.15, collective=cs)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        camp = cf.fleet_campaign(cs, specs, dev)

        def admit(sim, plan=camp.plan):
            if sim.supersteps == 1:
                sim.retire(1)
                sim.admit_lane(1, plan.overrides_for(fresh),
                               plan.tape_for(fresh))
        runs.append(fleet_run.run_fleet_full(camp, between=admit))
    (g, row), (c, _) = runs
    for b in range(4):
        assert cf.same_lane(g.replicas[b], c.replicas[b],
                            g.collective_clock_of(b),
                            c.collective_clock_of(b))
    assert g.replicas[0].events == ref.events
    assert g.replicas[0].collective_events == ref.collective_events
    assert g.collective_clock_of(0) == tuple(ref._coll_clk.tolist())
    assert cf.fires_before_end(g.replicas[3]) > 0
    for name in ("dag_walk_fleet", "superstep_commit_coll_fleet",
                 "drain_advance_event_fleet", "fleet_materialize_coll",
                 "fleet_admit_coll"):
        assert row["launches"].get(name, 0) > 0, name


# ---- K12-K15: the op-cost probe's kernels --------------------------------

PROBE_DTYPES = [torch.float32, torch.float64]


def probe_inputs(dev, dtype, C=16384, V=131072, seed=7):
    """P1's shapes (tools/tpu_pallas_probe.py:37-42)."""
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, C, (V, 4)).astype(np.int32))
    tab = torch.from_numpy(rng.uniform(1, 2, C)).to(dtype)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, (V, 4))).to(dtype)
    return tab.to(dev), idx.to(dev), w.to(dev), (tab, idx, w)


def reordered(got, want, terms, dtype):
    """|got - want| within two orders of a sum of `terms` positive
    values (probes/common.reorder_tol)."""
    from simgrid_tpu_torch.probes.common import reorder_tol
    g, w = got.cpu().double().numpy(), want.double().numpy()
    return bool(np.all(np.abs(g - w) <= reorder_tol(w, terms, dtype)))


@pytest.mark.parametrize("dtype", PROBE_DTYPES, ids=["f32", "f64"])
def test_probe_gather_card_equals_plain(cuda, dtype):
    from simgrid_tpu_torch.kernels import probe_gather as k12
    tab, idx, _, (tab_c, idx_c, _) = probe_inputs(cuda, dtype)
    want = k12.probe_gather_plain(tab_c, idx_c)
    for ix, ix_c in ((idx, idx_c), (idx.reshape(-1, 128),
                                    idx_c.reshape(-1, 128))):
        for arm in k12.ARMS:
            reset_launch_counts()
            got = k12.probe_gather(tab, ix, arm)
            assert got.shape == ix.shape
            assert torch.equal(got.cpu().reshape(want.shape), want)
            assert path_counts()[f"probe_gather_{arm}"] == 1
    big = torch.ones(30_000, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        k12.probe_gather(big, idx, "smem")


@pytest.mark.parametrize("dtype", PROBE_DTYPES, ids=["f32", "f64"])
def test_probe_segsum_card_equals_plain(cuda, dtype):
    from simgrid_tpu_torch.kernels import probe_segsum as k13
    C = 16384
    _, idx, w, (_, idx_c, w_c) = probe_inputs(cuda, dtype)
    csr = k13.segment_csr(idx, C)
    want = k13.probe_segsum_plain(idx_c, w_c, C)
    terms = np.maximum(np.bincount(idx_c.reshape(-1).numpy(),
                                   minlength=C), 1)
    for arm in k13.ARMS:
        got = k13.probe_segsum(idx, w, C, arm, csr=csr)
        if arm == "inorder":
            assert torch.equal(got.cpu(), want)
        else:
            assert reordered(got, want, terms, dtype), arm
    got = k13.probe_segsum(idx, w, C, "inorder", "min", csr)
    assert torch.equal(got.cpu(), k13.probe_segsum_plain(idx_c, w_c, C,
                                                         "min"))
    w3 = torch.stack([w, 2 * w, w], dim=-1)
    want3 = k13.probe_segsum_plain(idx_c, w3.cpu(), C)
    assert torch.equal(k13.probe_segsum(idx, w3, C, "inorder", csr=csr)
                       .cpu(), want3)
    assert reordered(k13.probe_segsum(idx, w3, C, "atomic"), want3,
                     terms[:, None], dtype)
    if dtype == torch.float64:
        with pytest.raises(ValueError, match="do not fit"):
            k13.probe_segsum(idx, w3, C, "smem_atomic")


@pytest.mark.parametrize("dtype", PROBE_DTYPES, ids=["f32", "f64"])
def test_probe_scan_card_equals_plain(cuda, dtype):
    from simgrid_tpu_torch.kernels import probe_scan as k14
    rng = np.random.default_rng(7)
    for shape in ((32, 16384), (5, 3000), (70_001,)):
        x_c = torch.from_numpy(rng.uniform(0.5, 1.5, shape)).to(dtype)
        x = x_c.to(cuda)
        want = k14.probe_scan_plain(x_c)
        assert torch.equal(k14.probe_scan(x, "seq").cpu(), want)
        terms = np.broadcast_to(np.arange(1, shape[-1] + 1), shape)
        assert reordered(k14.probe_scan(x, "block"), want, terms, dtype)
        want_min = k14.probe_scan_plain(x_c, "min")
        for arm in k14.ARMS:
            assert torch.equal(k14.probe_scan(x, arm, "min").cpu(),
                               want_min)


@pytest.mark.parametrize("dtype", PROBE_DTYPES, ids=["f32", "f64"])
def test_probe_loop_card_equals_plain(cuda, dtype):
    from simgrid_tpu_torch.kernels import probe_loop as k15
    tab, idx, _, (tab_c, idx_c, _) = probe_inputs(cuda, dtype)
    for rounds in (16, 1, 0):
        want = k15.probe_loop_plain(tab_c, idx_c, rounds)
        for arm in k15.ARMS:
            got = k15.probe_loop(tab, idx, rounds, arm)
            assert torch.equal(got.cpu(), want), (arm, rounds)
    lg = k15.LoopGraph(tab, idx, 16)       # captured outside the counts
    reset_launch_counts()
    k15.probe_loop(tab, idx, 16, "coop")
    k15.probe_loop(tab, idx, 16, "launch")
    for _ in range(3):
        got = lg.replay()
    assert torch.equal(got.cpu(), k15.probe_loop_plain(tab_c, idx_c, 16))
    cl = k15.CondLoop(tab, idx, 16)        # built at its first replay
    for _ in range(3):
        got = cl.replay()
    assert torch.equal(got.cpu(), k15.probe_loop_plain(tab_c, idx_c, 16))
    counts = path_counts()
    assert (counts["probe_loop_coop"], counts["probe_loop_launch"],
            counts["probe_loop_graph"]) == (1, 16, 3)
    # one graph launch a replay, 16 rounds in each on the card
    assert counts["superstep_loop_probe"] == 3
    assert k16.device_tally()["probe"] == 48
    grid = k15.coop_grid(dtype)
    assert grid >= torch.cuda.get_device_properties(0).multi_processor_count
    with pytest.raises(RuntimeError, match="cudaError"):
        k15.probe_loop(tab, idx, 16, "coop", grid=grid + 1)
    assert torch.equal(k15.probe_loop(tab, idx, 16, "coop").cpu(),
                       k15.probe_loop_plain(tab_c, idx_c, 16))
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (256, 128))
                         ).to(dtype)
    assert torch.equal(k15.probe_double(x.to(cuda)).cpu(), x * 2)


def test_run_opcost_on_card(cuda):
    """The whole probe at 1/16 of the tools' shapes: every row checked."""
    from simgrid_tpu_torch.probes.opcost import run_opcost
    from simgrid_tpu_torch.probes.scaling import run_scaling
    r = run_opcost(cuda, scale=1 / 16)
    assert r["ok"], [x for x in r["rows"] if not x["ok"]]
    assert all(x["bound_ms"] is not None for x in r["rows"])
    assert run_scaling(cuda, scale=1 / 16, dtypes=("float32",))["ok"]


# ---------------------------------------------------------------------------
# K1's row plan: rows walked by a thread, a warp or a block by length,
# dead rows skipped, one index walk for a group of replicas
# ---------------------------------------------------------------------------

from simgrid_tpu_torch.kernels import lmm_round as k1  # noqa: E402
from simgrid_tpu_torch.kernels.common import IT, LIGHT, LmmSystem  # noqa
from simgrid_tpu_torch.ops.csr import build_csr  # noqa: E402

K1_STATE = ("v_value", "v_fixed", "remaining", "usage", "light")
K1_ARMS = {
    "local": dict(),
    "bounds": dict(has_bounds=True),
    "fatpipe": dict(has_fatpipe=True),
    "bounds_fatpipe": dict(has_bounds=True, has_fatpipe=True),
    "global": dict(global_rounds=True),
    "global_bounds": dict(global_rounds=True, has_bounds=True),
    "global_fatpipe": dict(global_rounds=True, has_fatpipe=True),
}
#: (replicas, per-replica weights, forced replicas per group, short_max,
#: long_min): the solo layout and fleets at B = 8 and 5 (a partial
#: group), at the production classes and at small ones (most rows long)
K1_LAYOUTS = {
    "solo": (None, False, 0, k1.SHORT_ROW, k1.LONG_ROW),
    "b8_shared_g2": (8, False, 2, k1.SHORT_ROW, k1.LONG_ROW),
    "b8_per_w_g1": (8, True, 1, k1.SHORT_ROW, k1.LONG_ROW),
    "b5_per_w_g2": (5, True, 2, k1.SHORT_ROW, k1.LONG_ROW),
    "solo_small_classes": (None, False, 0, 2, 16),
    "b8_small_classes_g2": (8, True, 2, 2, 16),
}


def class_system(seed, dtype, short_max, long_min, n_v=2000, extra=150):
    """Constraint rows at every class boundary (empty, length 1, each
    threshold -1/0/+1, one row of 700 elements: more than two block
    stages) and ``extra`` random rows of 1-40 elements, over elements in
    random order, a few of weight 0; bounds with a zero, penalties with
    zeros, rate bounds on 40% of the flows, 15% of the rows FATPIPE."""
    rng = np.random.default_rng(seed)
    lens = [0, 1, 2, short_max - 1, short_max, short_max + 1,
            long_min - 1, long_min, long_min + 1, 700, 0, 1]
    lens += list(rng.integers(1, 41, extra))
    pairs = np.concatenate([
        np.stack([rng.choice(n_v, n, replace=False),
                  np.full(n, c)], 1) for c, n in enumerate(lens) if n > 0])
    pairs = pairs[rng.permutation(len(pairs))]
    E, C = len(pairs), len(lens)
    e_w = rng.uniform(0.5, 1.5, E)
    # weight-0 elements only on the random rows: the boundary rows keep
    # their lengths in the row index
    extra_e = np.flatnonzero(pairs[:, 1] >= 12)
    e_w[rng.choice(extra_e, len(extra_e) // 50, replace=False)] = 0.0
    c_bound = rng.uniform(1.0, 10.0, C)
    c_bound[4] = 0.0
    pen = rng.uniform(0.5, 2.0, n_v)
    pen[::13] = 0.0
    vb = np.where(rng.random(n_v) < 0.4, rng.uniform(1e-3, 5e-2, n_v),
                  -1.0)
    fat = rng.random(C) < 0.15
    return (pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32),
            e_w.astype(dtype), c_bound.astype(dtype), fat,
            pen.astype(dtype), vb.astype(dtype), n_v)


def _k1_fleet(dev, dtype, B, per_w, classes, seed=3):
    """The class system on ``dev`` (row lengths about ``classes``):
    solo (B None) or a fleet of B with bounds scaled per replica,
    penalties zeroed per replica, rate bounds per replica and
    (``per_w``) weights per replica."""
    e_var, e_cnst, e_w, cb, fat, pen, vb, n_v = class_system(
        seed, dtype, *classes)
    rng = np.random.default_rng(seed + 100)
    if B is not None:
        cb = cb[None, :] * (1.0 + 0.05 * np.arange(B))[:, None]
        pen = np.repeat(pen[None, :], B, 0)
        for b in range(B):
            pen[b, rng.choice(n_v, 20 * b, replace=False)] = 0.0
        vb = vb[None, :] * rng.uniform(0.5, 1.5, (B, n_v))
        if per_w:
            e_w = e_w[None, :] * rng.uniform(0.8, 1.2, (B, len(e_w)))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    ev, ec, ew = t(e_var), t(e_cnst), t(e_w.astype(dtype))
    csr = build_csr(ev, ec, ew if ew.dim() == 1 else ew.amax(0),
                    len(fat), n_v)
    sys_ = LmmSystem(ev, ec, ew, t(cb.astype(dtype)), csr, n_v, t(fat))
    w = Work(n_v, len(fat), ew.dtype, dev, B=B)
    return sys_, w, t(pen.astype(dtype)), t(vb.astype(dtype))


def _k1_plain_round(s, w, pen, vb, eps, arms):
    if w.B is None:
        return k1.lmm_round_plain(s, w, pen, eps, vb, **arms)
    return any([k1.lmm_round_plain(s.replica(b), w.replica(b), pen[b], eps,
                                   vb[b], **arms) for b in range(w.B)])


@pytest.mark.parametrize("layout", list(K1_LAYOUTS))
@pytest.mark.parametrize("arm", list(K1_ARMS))
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_k1_classes_card_equals_plain(cuda, monkeypatch, dtype, arm, layout):
    """K1 from init to convergence on the class system, the card against
    the plain round on the CPU after every round (the first 48, then
    every 8th and the last): state and control words equal by bits, in
    every arm, solo and as a fleet, with the plan's classes and the
    replica groups forced as the layout says."""
    B, per_w, group, short_max, long_min = K1_LAYOUTS[layout]
    monkeypatch.setattr(k1, "GROUP", group)
    monkeypatch.setattr(k1, "SHORT_ROW", short_max)
    monkeypatch.setattr(k1, "LONG_ROW", long_min)
    arms = K1_ARMS[arm]
    eps = 1e-5 if dtype == np.float32 else 1e-9
    (sg, wg, pg, vg), (sc, wc, pc_, vc) = (
        _k1_fleet(dev, dtype, B, per_w, (short_max, long_min))
        for dev in (cuda, torch.device("cpu")))
    fat = arms.get("has_fatpipe", False)
    reset_launch_counts()
    k1.lmm_init(sg, wg, pg, eps, has_fatpipe=fat)
    k1.lmm_init(sc, wc, pc_, eps, has_fatpipe=fat)
    plan = wg.k1_plan[1]
    want = k1.lmm_plan_plain(sc.csr.c_ptr, short_max, long_min)
    assert torch.equal(plan.order.cpu(), want.order)
    assert torch.equal(plan.ncls.cpu(), want.ncls)
    assert min(int(x) for x in want.ncls) >= 1

    def held(what):
        torch.cuda.synchronize()
        for n in K1_STATE:
            assert torch.equal(getattr(wg, n).cpu(), getattr(wc, n)), \
                (what, n)
        assert torch.equal(wg.ctrl.cpu(), wc.ctrl), what
        assert not bool(wg.touch.any()), what
    held("init")
    rounds = 0
    while _k1_plain_round(sc, wc, pc_, vc, eps, arms):
        k1.lmm_round(sg, wg, pg, eps, vg, **arms)
        rounds += 1
        if rounds <= 48 or rounds % 8 == 0:
            held(rounds)
        assert rounds < 20_000
    k1.lmm_round(sg, wg, pg, eps, vg, **arms)  # converged: a no-op
    held("end")
    assert rounds > 2
    name = k1.arm_name(k1.arm_flags(arms.get("has_bounds", False), fat,
                                    arms.get("global_rounds", False)))
    assert path_counts()[name + ("" if B is None else "_fleet")] == \
        rounds + 1
    assert path_counts()["lmm_plan"] == 1


@pytest.mark.parametrize("C", [0, 1, 5000, 300_000])
def test_k1_plan_card_equals_plain(cuda, C):
    """The row plan of random row indexes (several scan tiles at 300,000
    rows), card against plain, at two pairs of class limits."""
    rng = np.random.default_rng(C)
    lens = rng.choice([0, 1, 3, 8, 9, 30, 256, 257, 900], C)
    c_ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)])
                             .astype(np.int32))
    for short_max, long_min in ((k1.SHORT_ROW, k1.LONG_ROW), (0, 8)):
        got = k1.lmm_plan(c_ptr.to(cuda), short_max, long_min)
        want = k1.lmm_plan_plain(c_ptr, short_max, long_min)
        assert torch.equal(got.order.cpu(), want.order)
        assert torch.equal(got.ncls.cpu(), want.ncls)


@pytest.mark.parametrize("group", [-1, 3, 4, 8])
def test_k1_forced_group_out_of_range_refused(cuda, monkeypatch, group):
    """The C entries take a forced replica group of 0, 1 or 2 only: any
    other value raises, and no launch is counted."""
    monkeypatch.setattr(k1, "GROUP", group)
    sg, wg, pg, vg = _k1_fleet(cuda, np.float64, 8, False,
                               (k1.SHORT_ROW, k1.LONG_ROW))
    reset_launch_counts()
    with pytest.raises(RuntimeError):
        k1.lmm_init(sg, wg, pg, 1e-9)
    with pytest.raises(RuntimeError):
        k1.lmm_round(sg, wg, pg, 1e-9)
    counts = path_counts()
    assert counts["lmm_init_fleet"] == 0 and counts["lmm_round_fleet"] == 0


def test_k1_plan_rebuilt_after_repack_card_equals_plain(cuda, monkeypatch):
    """A bounded 3,000-flow LV08 drain that repacks on the card (K4
    rewrites the row index there): K1 builds a new plan for every new
    index, the last one equal to the plain plan of the last index, and
    the drain equals the plain drain on the CPU, at classes small enough
    that every class is walked."""
    monkeypatch.setattr(k1, "SHORT_ROW", 2)
    monkeypatch.setattr(k1, "LONG_ROW", 16)
    s = dragonfly.build_system(3000, lv08=True)
    rates = lmm_torch.solve_arrays(drain_run.solve_inputs(s), 1e-5,
                                   device="cpu")[0]
    vb = s.v_bound * np.median(rates / s.v_bound)
    sims = []
    for dev in (cuda, torch.device("cpu")):
        reset_launch_counts()
        sim = DrainSim(s.e_var, s.e_cnst, s.e_w, s.c_bound, s.sizes,
                       eps=1e-5, dtype=np.float64, repack_min=64,
                       device=dev, penalty=s.v_penalty, v_bound=vb,
                       superstep=16)
        sim.run()
        sims.append((sim, path_counts()))
    (g, lg), (c, _) = sims
    assert g.events == c.events and g.t == c.t
    assert g.repacks >= 2 and lg["livefirst_repack_vbound"] >= 1
    assert lg["lmm_plan"] >= g.repacks + 1
    csr, plan = g.w.k1_plan
    assert csr is g.sys.csr
    want = k1.lmm_plan_plain(csr.c_ptr.cpu(), 2, 16)
    assert torch.equal(plan.order.cpu(), want.order)
    assert torch.equal(plan.ncls.cpu(), want.ncls)
    assert min(int(x) for x in want.ncls) >= 1


# ---------------------------------------------------------------------------
# K1 ending its own K16 loop iteration, and K10 over the out-edge CSR

#: K1's kernel nodes a round inside a loop it ends, by arm (the first a
#: plain node, the rest programmatic dependents; no loop_cond node)
K1_LOOP_NODES = {"local": 4, "bounds": 8, "fatpipe": 4, "bounds_fatpipe": 8,
                 "global": 4, "global_bounds": 5, "global_fatpipe": 4}
K1_LOOP_LAYOUTS = ("solo", "b8_shared_g2", "b8_per_w_g1", "b5_per_w_g2")


def _k1_loop(s, w, pen, vb, eps, arms, cap, ends):
    tally = "lmm_round" if w.B is None else "lmm_round_fleet"
    return k16.DeviceLoop(
        [k16.Loop(k16.PRED_ROUND, w.ctrl, (lambda: k1.lmm_round(
            s, w, pen, eps, vb, **arms),), cap=cap, tally=tally,
            ends=ends)], "chunk" if w.B is None else "chunk_fleet",
        w.ctrl.device, prepare=lambda: k1.plan_of(s, w)), tally


@pytest.mark.parametrize("cap", [0, 5], ids=["uncapped", "cap5"])
@pytest.mark.parametrize("layout", K1_LOOP_LAYOUTS)
@pytest.mark.parametrize("arm", list(K1_ARMS))
def test_k1_loop_ends_card_equals_plain(cuda, monkeypatch, arm, layout,
                                        cap):
    """K1 as the body of ``Loop(PRED_ROUND, ..., ends=True)`` in a
    ``DeviceLoop``, run launch by launch (a capped loop stops exactly at
    its cap) to convergence: after every launch the state and control
    words equal the plain loop's on the CPU by bits, and the loop's
    tally equals the plain loop's and the tally of the same loop built
    with a ``loop_cond`` node (``ends=False``) on the card.  The body
    holds the arm's kernel nodes and no ``loop_cond`` node."""
    B, per_w, group, short_max, long_min = K1_LAYOUTS[layout]
    monkeypatch.setattr(k1, "GROUP", group)
    arms = K1_ARMS[arm]
    fat = arms.get("has_fatpipe", False)
    eps = 1e-9
    runs = {}
    for key, dev, ends in (("ends", cuda, True), ("cond", cuda, False),
                           ("plain", torch.device("cpu"), True)):
        s, w, pen, vb = _k1_fleet(dev, np.float64, B, per_w,
                                  (short_max, long_min))
        k1.lmm_init(s, w, pen, eps, has_fatpipe=fat)
        k16.reset_tally()
        loop, tally = _k1_loop(s, w, pen, vb, eps, arms, cap, ends)
        states, launches = [], 0
        while k16.pred_plain(k16.PRED_ROUND, w.ctrl.cpu()):
            loop.run()
            launches += 1
            states.append([getattr(w, n).cpu().clone() for n in K1_STATE]
                          + [w.ctrl.cpu().clone()])
            assert launches < 5_000
        runs[key] = (states, k16.device_tally()[tally], k16.bodies())
    want, n_plain, _ = runs["plain"]
    assert n_plain > 2
    if cap:
        assert len(want) == -(-n_plain // cap)
    for key in ("ends", "cond"):
        got, n, bodies = runs[key]
        assert n == n_plain, key
        assert len(got) == len(want), key
        for i, (g, c) in enumerate(zip(got, want)):
            for x, y in zip(g, c):
                assert torch.equal(x, y), (key, i)
        (body,) = bodies
        assert body["ends"] == (key == "ends")
        assert body["cond_nodes"] == (0 if key == "ends" else 1)
        assert body["kernel_nodes"] == K1_LOOP_NODES[arm] + (key == "cond")
    assert int(runs["ends"][0][-1][-1].view(-1, N_CTRL)[0, 14]) == 0


def test_k1_round_outside_a_loop_counts_itself(cuda):
    """Called from the host, K1's round still moves IT and LIGHT (its
    last block does what the one-thread launch did), solo and as a
    fleet, and leaves the launch-wide ticket at 0."""
    from simgrid_tpu_torch.kernels.common import GTICKET, LIGHT_ACC
    for B in (None, 5):
        (sg, wg, pg, vg), (sc, wc, pc_, vc) = (
            _k1_fleet(dev, np.float64, B, False,
                      (k1.SHORT_ROW, k1.LONG_ROW))
            for dev in (cuda, torch.device("cpu")))
        k1.lmm_init(sg, wg, pg, 1e-9)
        k1.lmm_init(sc, wc, pc_, 1e-9)
        for _ in range(3):
            k1.lmm_round(sg, wg, pg, 1e-9)
            _k1_plain_round(sc, wc, pc_, vc, 1e-9, {})
        ctrl = wg.ctrl.cpu().view(-1, N_CTRL)
        assert ctrl[:, IT].tolist() == [3] * ctrl.shape[0]
        assert torch.equal(ctrl[:, LIGHT],
                           wc.ctrl.view(-1, N_CTRL)[:, LIGHT])
        assert ctrl[:, LIGHT_ACC].tolist() == [0] * ctrl.shape[0]
        assert int(ctrl[0, GTICKET]) == 0


def test_k1_ends_only_its_own_loop(cuda):
    """A loop over other control words than the round's cannot be ended
    by K1: building it raises."""
    s, w, pen, vb = _k1_fleet(cuda, np.float64, None, False,
                              (k1.SHORT_ROW, k1.LONG_ROW))
    other = torch.zeros_like(w.ctrl)
    k1.lmm_init(s, w, pen, 1e-9)
    loop = k16.DeviceLoop(
        [k16.Loop(k16.PRED_ROUND, other, (lambda: k1.lmm_round(
            s, w, pen, 1e-9),), ends=True)], "chunk", cuda,
        prepare=lambda: k1.plan_of(s, w))
    with pytest.raises(ValueError):
        loop.run()


@pytest.mark.parametrize("B,V", [(None, 10_240), (None, 1_001), (4, 1_001),
                                 (32, 10_240)])
def test_dag_walk_csr_card_equals_plain(cuda, B, V):
    """K10 over a CSR built once, with seeded completion masks: solo
    and fleets whose rows start off the 16-byte grid (V = 1,001), one
    replica whose advance did not commit, several completions a
    successor; the counts, the dates and the pending counts equal the
    plain walk's by bits, in two walks in a row."""
    from simgrid_tpu_torch.kernels.dag_walk import dag_csr
    rng = np.random.default_rng(V)
    E = 4 * V
    src = rng.integers(0, V, E).astype(np.int32)
    dst = rng.integers(0, V, E).astype(np.int32)
    dst[::53] = V
    pred = np.bincount(dst[dst < V], minlength=V).astype(np.int32)
    lead = () if B is None else (B,)
    done = rng.random(lead + (V,)) < 0.2
    cost = rng.uniform(0, 1e-3, V)
    out = []
    for dev in (cuda, torch.device("cpu")):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
        es, ed = t(src), t(dst)
        csr = dag_csr(es, ed, V)
        w = Work(V, 4, torch.float64, dev, B=B)
        if B is not None:
            w.ctrl[:, ADV_OK] = 1
            w.ctrl[1, ADV_OK] = 0
            w.fctrl[:, T_SUM] = torch.arange(1, B + 1,
                                             dtype=torch.float64) / 8
        else:
            w.ctrl[ADV_OK] = 1
            w.fctrl[T_SUM] = 0.125
        p = t(np.broadcast_to(pred, lead + (V,)).copy())
        r = torch.full(lead + (V,), float("inf"), dtype=torch.float64,
                       device=dev)
        snaps = []
        for k in range(2):
            w.done.copy_(t(np.roll(done, k, axis=-1)))
            reset_launch_counts()
            dag_walk(w, es, ed, p, r, t(cost), csr)
            snaps.append((p.cpu().clone(), r.cpu().clone(),
                          w.ctrl.cpu().view(-1, N_CTRL)[:, PENDING].clone()))
        out.append((snaps, path_counts()))
    for (pg, rg, ng), (pc_, rc, nc) in zip(out[0][0], out[1][0]):
        assert torch.equal(pg, pc_) and torch.equal(rg, rc)
        assert torch.equal(ng, nc) and int(nc.sum()) > 0
    if B is not None:
        assert int(out[1][0][-1][2][1]) == 0
    assert out[0][1]["dag_walk" if B is None else "dag_walk_fleet"] == 1


# ---------------------------------------------------------------------------
# pipelined supersteps (``pipeline=D``): the speculative issue/collect split
# ---------------------------------------------------------------------------


def _pipe_drain(dev, s, pipeline, run=True, **kw):
    kw.setdefault("repack_min", 64)
    sim = DrainSim(s.e_var, s.e_cnst, s.e_w, s.c_bound, s.sizes, eps=1e-5,
                   dtype=np.float64, superstep=8, pipeline=pipeline,
                   device=dev, **kw)
    if run:
        sim.run()
    return sim


@pytest.mark.parametrize("arm", ["plain", "tape"])
def test_pipelined_drain_card_equals_depth0(cuda, arm):
    """``pipeline=2`` on the card gives depth 0's events, fault events
    and clock by bits, through repacks and tape fires, with the plain
    path's speculation census; one graph per buffer set."""
    from simgrid_tpu_torch.workloads import fault_drain
    s = dragonfly.build_system(3000)
    kw = {}
    if arm == "tape":
        kw["tape"] = fault_drain.tape_for(
            s.e_cnst, s.e_w, s.c_bound, seed=7, horizon=0.2, mtbf=2.0,
            mttr=0.005, link_names=dragonfly.link_names(s))
    ref = _pipe_drain(cuda, s, 0, **kw)
    got = _pipe_drain(cuda, s, 2, **kw)
    plain = _pipe_drain(torch.device("cpu"), s, 2, **kw)
    census = ("spec_issued", "spec_committed", "spec_rolled_back",
              "supersteps", "repacks", "advances")
    assert (got.events, got.fault_events, got.t) == \
        (ref.events, ref.fault_events, ref.t)
    assert [getattr(got, k) for k in census] == \
        [getattr(plain, k) for k in census]
    assert got.spec_committed > 0 and got.repacks > 0
    assert got.loop_builds <= ref.loop_builds + 3 * (1 + got.repacks)
    if arm == "tape":
        assert len(got.fault_events) > 10


def test_discard_leaves_committed_buffers_untouched(cuda):
    """Two speculative supersteps in flight on their own sets, then
    discarded: the committed flow state, bounds and clock are the head
    superstep's, bit for bit, and the drain goes on to depth 0's
    result (no repack, so no superstep stops early for one)."""
    from simgrid_tpu_torch.workloads import fault_drain
    s = dragonfly.build_system(3000)
    tape = fault_drain.tape_for(s.e_cnst, s.e_w, s.c_bound, seed=7,
                                horizon=0.2, mtbf=2.0, mttr=0.005,
                                link_names=dragonfly.link_names(s))
    kw = dict(tape=tape, repack_min=1 << 62)
    ref = _pipe_drain(cuda, s, 0, **kw)
    sim = _pipe_drain(cuda, s, 2, run=False, **kw)
    head = sim._superstep_issue()
    sim._carries.inflight.append(head)
    sim._carries.inflight.append(sim._superstep_issue(prev=head))
    sim._carries.inflight.append(sim._superstep_issue(prev=sim._carries.inflight[-1]))
    sim._carries.inflight.popleft()
    sim._superstep_collect(head)
    torch.cuda.synchronize()
    committed = [t.clone() for t in (sim._pen, sim._rem, sim.sys.c_bound)]
    t_head = sim.t
    for tok in sim._carries.inflight:     # they ran, on sets of their own
        assert tok.carry.pen is not sim._pen
        assert int(tok.carry.ring.host[1]) > 0
    sim._carries.discard(sim)
    torch.cuda.synchronize()
    for a, b in zip(committed, (sim._pen, sim._rem, sim.sys.c_bound)):
        assert torch.equal(a, b)
    assert sim.t == t_head and sim.spec_rolled_back == 2
    sim.run()
    assert (sim.events, sim.fault_events, sim.t) == \
        (ref.events, ref.fault_events, ref.t)


def test_pipelined_fleet_card_equals_depth0(cuda):
    """A faulted and a swept replica with per-replica weights, pipelined
    on the card, equal depth 0 by bits, with the plain path's census."""
    runs = []
    for dev, depth in ((cuda, 0), (cuda, 2), (torch.device("cpu"), 2)):
        s, plan = _fleet_plan(dev)
        sim = plan.executor(_fleet_specs(s), pipeline=depth)
        sim.run()
        runs.append(sim)
    ref, got, plain = runs
    for b in range(2):
        a, r = got.replicas[b], ref.replicas[b]
        assert (a.events, a.fault_events, a.t) == \
            (r.events, r.fault_events, r.t)
    census = ("spec_issued", "spec_committed", "spec_rolled_back",
              "supersteps")
    assert [getattr(got, k) for k in census] == \
        [getattr(plain, k) for k in census]
    assert got.spec_committed > 0
