"""The port's ELL layout (simgrid_tpu_torch.ops.lmm_ell, K7 ``ell_round``,
K8 ``vc_round``, K9 ``ell_chain``, K6's ELL arm and K5's ELL deltas)
against the JAX package's (``ops/lmm_jax.py`` ``ell_from_arrays``,
``fixpoint_ell``, ``_vc_round_body``, the compaction chain;
``ops/lmm_warm.py``'s ELL leg), on the CPU.

JAX's ``lmm/layout`` and ``lmm/chain`` are set for each JAX solve and
restored after it.  Results are compared as float64 bit patterns.  The
chain and the dense ELL path are different JAX programs (the chain's
init is numpy's pairwise row sum), so each port path is held against
the same JAX path: chain against chain, dense against dense.

Every row sum along a constraint row folds as XLA:CPU folds
``sum(axis=1)`` at widths up to 8 and from 64: 32-lane blocks left to
right, then the block partials.  At padded widths 16 and 32 some of
XLA:CPU's fused programs let LLVM reassociate the row into 4-lane
vectors, differently per program; the port does not follow that, and
the one case at those widths states its tolerance.
"""

import numpy as np
import pytest
import torch

import simgrid_tpu.ops.lmm_warm as jwarm
from simgrid_tpu.ops import lmm_jax
from simgrid_tpu.ops import make_new_maxmin_system as jax_system
from simgrid_tpu.ops import opstats as jstats
from simgrid_tpu.utils.config import config
from simgrid_tpu_torch import convert
from simgrid_tpu_torch.kernels import ell_round as k7
from simgrid_tpu_torch.kernels import warm_init as k6
from simgrid_tpu_torch.kernels.common import EllWork
from simgrid_tpu_torch.kernels.transition_scatter import (ELL_FIELDS,
                                                          ell_delta_scatter)
from simgrid_tpu_torch.ops import lmm_ell, lmm_torch
from simgrid_tpu_torch.ops import opstats as pstats
from simgrid_tpu_torch.ops.lmm_arrays import LmmArrays, bucket
from simgrid_tpu_torch.ops.lmm_host import LmmFlags, make_new_maxmin_system
from simgrid_tpu_torch.workloads import bench_solve, churn


def bits(x):
    a = np.asarray(x.numpy() if torch.is_tensor(x) else x)
    if a.dtype == np.float64:
        return a.view(np.int64)
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a


def same(a, b) -> bool:
    a, b = bits(a), bits(b)
    return a.shape == b.shape and bool(np.array_equal(a, b))


def same_result(p, j) -> bool:
    return p[3] == j[3] and all(same(np.asarray(x), np.asarray(y))
                                for x, y in zip(p[:3], j[:3]))


def jax_solve(arrays, eps, layout, chain, parallel=True):
    config["lmm/layout"] = layout
    config["lmm/chain"] = chain
    try:
        return lmm_jax.solve_arrays(lmm_jax.LmmArrays(*arrays), eps,
                                    parallel_rounds=parallel)
    finally:
        config["lmm/layout"] = "auto"
        config["lmm/chain"] = "auto"


def width_arrays(seed, n_c, width, deg, dtype=np.float64, bounds=0.0,
                 fat=0.0):
    """Every constraint row holds exactly ``width`` elements (``width``
    random permutations of the constraints), each variable ``deg`` of
    them; a tenth of the variables disabled, three zero-bound
    constraints; ``bounds`` of the variables bounded near their share,
    ``fat`` of the constraints FATPIPE."""
    rng = np.random.default_rng(seed)
    n_e = n_c * width
    n_v = n_e // deg
    eb, cb, vb = bucket(n_e), bucket(n_c), bucket(n_v)
    e_var = np.zeros(eb, np.int32)
    e_cnst = np.zeros(eb, np.int32)
    e_w = np.zeros(eb, dtype)
    e_var[:n_e] = np.repeat(np.arange(n_v, dtype=np.int32), deg)
    e_cnst[:n_e] = np.concatenate([rng.permutation(n_c)
                                   for _ in range(width)])
    e_w[:n_e] = rng.uniform(0.5, 1.5, n_e)
    c_bound = np.zeros(cb, dtype)
    c_bound[:n_c] = rng.uniform(1.0, 10.0, n_c)
    c_bound[:3] = 0.0
    c_fat = np.zeros(cb, bool)
    c_fat[:n_c] = rng.random(n_c) < fat
    v_pen = np.zeros(vb, dtype)
    v_pen[:n_v] = 1.0
    v_pen[rng.choice(n_v, n_v // 10, replace=False)] = 0.0
    v_bound = np.full(vb, -1.0, dtype)
    sel = rng.random(n_v) < bounds
    v_bound[:n_v][sel] = rng.uniform(0.5, 3.0, sel.sum()) / width
    return LmmArrays(e_var, e_cnst, e_w, c_bound, c_fat, v_pen, v_bound,
                     n_e, n_c, n_v)


# ---------------------------------------------------------------------------
# the host conversion


@pytest.mark.parametrize("width,deg", [(4, 2), (64, 4), (128, 3)])
def test_ell_from_arrays_equals_jax(width, deg):
    a = width_arrays(1, 96, width, deg, fat=0.1)
    a = a._replace(e_w=np.where(np.arange(len(a.e_w)) % 7 == 0, 0.0, a.e_w))
    j = lmm_jax.ell_from_arrays(lmm_jax.LmmArrays(*a))
    p = lmm_ell.ell_from_arrays(a)
    assert p.cv_var.shape == (bucket(96), width)
    for f in lmm_ell.LmmEllArrays._fields:
        x, y = getattr(p, f), getattr(j, f)
        assert (same(x, y) if isinstance(x, np.ndarray) else x == y), f
    assert lmm_ell.ell_cached(a) is lmm_ell.ell_cached(a)


def test_ell_caps_refuse_as_jax():
    """A row of 513 elements, and a fill above 8, are refused by both."""
    n_e = 513
    wide = LmmArrays(np.arange(n_e, dtype=np.int32),
                     np.zeros(n_e, np.int32), np.ones(n_e), np.ones(1),
                     np.zeros(1, bool), np.ones(1024), -np.ones(1024),
                     n_e, 1, n_e)
    ok = wide._replace(n_elem=512)
    # one element per constraint over 4,096 constraint slots: a fill of
    # 4096 * 4 / 2 = 2048 > 8
    sparse = LmmArrays(np.zeros(16, np.int32), np.arange(16, dtype=np.int32),
                       np.ones(16), np.ones(4096), np.zeros(4096, bool),
                       np.ones(16), -np.ones(16), 1, 4096, 1)
    for arrays, want in ((wide, None), (sparse, None), (ok, "ell")):
        j = lmm_jax.ell_from_arrays(lmm_jax.LmmArrays(*arrays))
        p = lmm_ell.ell_from_arrays(arrays)
        assert (j is None) == (p is None) == (want is None)


@pytest.mark.parametrize("width", [16, 64, 1024])
def test_fold_rows_is_xla_row_sum(width):
    """``fold_rows`` (K7's row-sum order) equals a jitted ``sum(axis=1)``
    bit for bit, on values spanning 30 decades."""
    import jax
    rng = np.random.default_rng(width)
    x = np.exp(rng.uniform(-35, 35, size=(512, width)))
    x[rng.random(x.shape) < 0.3] = 0.0
    want = np.asarray(jax.jit(lambda a: a.sum(1))(x))
    assert same(k7.fold_rows(torch.from_numpy(x)), want)


# ---------------------------------------------------------------------------
# fixpoint_ell: the init and every arm


@pytest.mark.parametrize("width,deg", [(4, 2), (64, 4), (128, 3)])
def test_ell_init_equals_jax(width, deg):
    a = width_arrays(2, 96, width, deg, fat=0.2)
    ell = lmm_jax.ell_from_arrays(lmm_jax.LmmArrays(*a))
    args = [ell.cv_var, ell.cv_w, ell.cv_valid, ell.vc_cnst, ell.vc_valid,
            ell.c_bound, ell.c_fatpipe, ell.v_penalty, ell.v_bound,
            ell.vc_w]
    carry = lmm_jax._solve_ell_chunk(*args, None, eps=1e-9,
                                     parallel_rounds=True, chunk=0,
                                     has_bounds=True, has_fatpipe=True)[4]
    sys, pen, vb = lmm_ell.dense_system(convert.ell_arrays(ell),
                                        torch.device("cpu"))
    w = EllWork(sys.n_v, sys.n_c, sys.wc, torch.float64, torch.device("cpu"))
    assert k7.ell_init(sys, w, pen, 1e-9, vb) is True
    for name, want in zip(("v_value", "v_fixed", "remaining", "usage",
                           "light"), carry[:5]):
        assert same(getattr(w, name), want), name
    assert same(w.cv_live, carry[6])


ARMS = {
    # name: (generator keywords, local rounds)
    "local_vc": ({}, True),
    "local_bounds": (dict(bounds=0.3), True),
    "global": (dict(bounds=0.2), False),
    "fatpipe_vc": (dict(fat=0.1), True),
    "fatpipe_bounds": (dict(fat=0.1, bounds=0.3), True),
    "global_fatpipe": (dict(fat=0.1), False),
}


@pytest.mark.parametrize("width,deg", [(4, 2), (64, 4), (128, 3)])
@pytest.mark.parametrize("arm", list(ARMS))
def test_dense_ell_arms_equal_jax(arm, width, deg):
    """``solve_arrays(layout="ell", chain="off")`` against the JAX dense
    ELL solve: values, remaining, usage and rounds, for the vc round
    (K8), the bound-first local round and the global round (K7), with
    and without FATPIPE constraints."""
    kw, local = ARMS[arm]
    n_c = 48 if not local else 96
    a = width_arrays(3, n_c, width, deg, **kw)
    j = jax_solve(a, 1e-9, "ell", "off", local)
    p = lmm_torch.solve_arrays(a, 1e-9, device="cpu", parallel_rounds=local,
                               layout="ell", chain="off")
    assert same_result(p, j), (p[3], j[3])


def test_dense_ell_width_32_within_reduction_order():
    """At a padded width of 32, XLA:CPU's vc program folds the init's row
    sums as LLVM's 4-lane vectorised loop ((x_k + x_k+16) per lane,
    4 vectors added in turn, then (l0 + l2) + (l1 + l3)), which the port
    does not follow: the rounds agree, and the rates within 1e-12
    relative (a few ulps through the solve)."""
    a = width_arrays(4, 96, 32, 4)
    j = jax_solve(a, 1e-9, "ell", "off")
    p = lmm_torch.solve_arrays(a, 1e-9, device="cpu", layout="ell",
                               chain="off")
    assert p[3] == j[3]
    for x, y in zip(p[:3], j[:3]):
        np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-15)


# ---------------------------------------------------------------------------
# the compaction chain


def chain_arrays(seed=13):
    """tests/test_lmm.py's chain system: 4,096 constraints, 33,000
    variables of degree 3 (65,536 variable slots: three stages)."""
    return bench_solve.build_arrays(np.random.default_rng(seed), 4096,
                                    33000, 3, np.float64)


def test_chain_and_dense_equal_jax():
    a = chain_arrays()
    before = pstats.snapshot()
    p_chain = lmm_torch.solve_arrays(a, 1e-9, device="cpu", layout="ell",
                                     chain="on")
    d = pstats.diff(before)
    assert d.get("ell_chain_solves") == 1 and not d.get("ell_solves")
    j_chain = jax_solve(a, 1e-9, "ell", "on")
    assert same_result(p_chain, j_chain)
    p_dense = lmm_torch.solve_arrays(a, 1e-9, device="cpu", layout="ell",
                                     chain="off")
    j_dense = jax_solve(a, 1e-9, "ell", "off")
    assert same_result(p_dense, j_dense)
    # JAX's own chain/dense agreement (test_lmm.py), held by the port too
    assert p_chain[3] == p_dense[3]


def test_chain_stage_cap_overflow_falls_back(monkeypatch):
    """A stage cap of 1 overflows the first stage: the chain returns
    None and the dense path re-solves, equal to JAX's same fallback."""
    a = chain_arrays(17)
    monkeypatch.setattr(lmm_ell, "_CHAIN_STAGE_CAP", 1)
    monkeypatch.setattr(lmm_jax, "_CHAIN_STAGE_CAP", 1)
    before = pstats.snapshot()
    p = lmm_torch.solve_arrays(a, 1e-9, device="cpu", layout="ell",
                               chain="on")
    d = pstats.diff(before)
    assert d.get("ell_chain_fallbacks") == 1 and d.get("ell_solves") == 1
    j = jax_solve(a, 1e-9, "ell", "on")
    assert same_result(p, j)
    assert same_result(p, jax_solve(a, 1e-9, "ell", "off"))


# ---------------------------------------------------------------------------
# solve_arrays: the layout choice and the upload cache


def test_layout_auto_on_cpu_stays_coo():
    a = chain_arrays()
    before = pstats.snapshot()
    p = lmm_torch.solve_arrays(a, 1e-9, device="cpu")
    d = pstats.diff(before)
    assert not d.get("ell_solves") and not d.get("ell_chain_solves")
    assert same_result(p, jax_solve(a, 1e-9, "auto", "auto"))
    with pytest.raises(ValueError):
        lmm_torch.solve_arrays(a, 1e-9, device="cpu", layout="csr")


@pytest.mark.parametrize("layout,chain", [("ell", "off"), ("ell", "on"),
                                          ("coo", "auto")])
def test_uploaded_bytes_equal_jax(layout, chain):
    """The first solve uploads what JAX uploads (its upload kinds and
    arrays), a repeated solve of the same arrays nothing (a cache hit)."""
    a = chain_arrays(21)
    got, want = [], []
    for _ in range(2):
        pb, jb = pstats.snapshot(), jstats.snapshot()
        lmm_torch.solve_arrays(a, 1e-9, device="cpu", layout=layout,
                               chain=chain)
        jax_solve(a, 1e-9, layout, chain)
        got.append(pstats.diff(pb).get("uploaded_bytes_full", 0))
        want.append(jstats.diff(jb).get("uploaded_bytes_full", 0))
    assert got == want and got[0] > 0 and got[1] == 0


def test_headline_reduced_equals_jax():
    """bench.py's headline class cut to 2,048 x 20,000 (degree 4, seed
    42): the chain (run_bench_solve's default path on an accelerator)
    against JAX's chain, and the dense path against JAX's."""
    kw = dict(n_c=2048, n_v=20_000, deg=4, seed=42, device="cpu", reps=1,
              layout="ell")
    a = bench_solve.build_arrays(np.random.default_rng(42), 2048, 20_000, 4,
                                 np.float64)
    for chain in ("on", "off"):
        res, row = bench_solve.run_bench_solve(chain=chain, **kw)
        assert row["path"] == ("chain" if chain == "on" else "dense")
        assert same_result(res, jax_solve(a, 1e-9, "ell", chain))


# ---------------------------------------------------------------------------
# the warm solver's ELL leg


def port_system(**flags):
    s = make_new_maxmin_system(True, LmmFlags(**{"backend": "torch",
                                                 "layout": "ell", **flags}))
    return lmm_torch.install(s, device="cpu")


def jax_solver_system(warm_start="on", delta_upload="on", rounds="local"):
    config["lmm/warm-start"] = warm_start
    config["lmm/delta-upload"] = delta_upload
    config["lmm/rounds"] = rounds
    config["lmm/layout"] = "ell"
    s = jax_system(True)
    s.solve_fn = lmm_jax.solve_jax
    return s


def host_state(s):
    return tuple(a.view(np.int64).tolist() for a in churn.host_state(s))


def counters(stats_mod, before, ws):
    d = stats_mod.diff(before)
    return (int(d.get("fixpoint_rounds", 0)),
            int(d.get("uploaded_bytes_full", 0)),
            int(d.get("uploaded_bytes_delta", 0)),
            int(d.get("warm_ell_fallbacks", 0)),
            None if ws is None else (ws.last_mode, ws.last_rounds,
                                     ws.last_dirty_slots, ws.warm_solves,
                                     ws.cold_solves, ws.last_layout,
                                     ws.warm_ell_fallbacks))


@pytest.mark.parametrize("rounds", ["local", "global"])
@pytest.mark.parametrize("mode", list(churn.MODES))
def test_churn_modes_ell_equal_jax(mode, rounds):
    """bench.py's churn stage at 3,000 variables (40 clusters, a
    12-constraint chain) in every mode with the ELL layout: host states,
    rounds, upload bytes, warm counters and ``warm_ell_fallbacks`` equal
    JAX's at every step."""
    warm_start, delta_upload = churn.MODES[mode]
    port = port_system(warm_start=warm_start, delta_upload=delta_upload,
                       rounds=rounds)
    jax = jax_solver_system(warm_start, delta_upload, rounds)
    n_v, clusters, chain, steps = 3000, 40, 12, 4
    rngs = [np.random.default_rng(42), np.random.default_rng(42)]
    built = [churn.build(s, r, n_v, clusters, chain)
             for s, r in zip((port, jax), rngs)]
    churn_n = max(1, int((n_v - chain + 1) * 0.01))
    for step in range(steps + 1):
        if step:
            for i, s in enumerate((port, jax)):
                churn.churn_step(s, rngs[i], *built[i], churn_n)
        pb, jb = pstats.snapshot(), jstats.snapshot()
        port.solve()
        jax.solve()
        assert host_state(port) == host_state(jax), f"step {step}"
        assert counters(pstats, pb, port.warm_solver) == \
            counters(jstats, jb, jax.warm_solver), f"step {step}"
    if mode != "legacy-subset":
        assert port.warm_solver.last_layout == "ell"
        assert port.warm_solver.warm_ell_fallbacks == 0
    if mode == "warm-selective":
        assert port.warm_solver.warm_solves == steps


def build_clusters(s, seed, n_clusters=8, per_cluster=6, chain=6):
    """tests/test_lmm_warm.py's ``_build``: a saturation chain plus
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


def grow_step(s, clusters, flows, rng, step):
    """Add a flow to a seeded cluster (lane appends), retire one every
    third step, move a bound every fourth."""
    k = int(rng.integers(len(clusters)))
    v = s.variable_new(None, float(rng.choice([0.5, 1.0])))
    s.expand(clusters[k], v, float(rng.choice([1.0, 2.0])))
    flows[k].append(v)
    if step % 3 == 0 and len(flows[k]) > 1:
        s.variable_free(flows[k].pop(0))
    if step % 4 == 0:
        s.update_constraint_bound(clusters[k], float(rng.uniform(5, 20)))


def test_ell_lane_appends_and_overflow_rebuild():
    """tests/test_lmm_warm.py's ELL warm case: through lane appends and a
    width-overflow rebuild (a cluster outgrows its 8 lanes), the port's
    ELL warm run equals its ELL cold run and JAX's ELL warm run at every
    step, with the same counters; the carry is reused, no solve leaves
    ELL."""
    cold = build_clusters(port_system(warm_start="cold"), 13)
    warm = build_clusters(port_system(warm_start="on"), 13)
    jax = build_clusters(jax_solver_system("on", "on"), 13)
    shapes = set()
    for step in range(14):
        for sysn in (cold, warm, jax):
            grow_step(*sysn, step)
        pb, jb = pstats.snapshot(), jstats.snapshot()
        for sysn in (cold, warm, jax):
            sysn[0].solve()
        assert host_state(warm[0]) == host_state(cold[0]) == \
            host_state(jax[0]), f"step {step}"
        assert counters(pstats, pb, None)[:4] != () and \
            warm[0].warm_solver.last_mode == jax[0].warm_solver.last_mode
        ws = warm[0].warm_solver
        shapes.add(ws._states[np.dtype(np.float64)].ell_shape)
    ws, jws = warm[0].warm_solver, jax[0].warm_solver
    assert ws.warm_solves == jws.warm_solves > 0
    assert ws.warm_ell_fallbacks == 0 and ws.last_layout == "ell"
    assert len(shapes) > 1, "no width-overflow rebuild happened"


def capture_warm_ell(monkeypatch, s):
    """Record the JAX warm solver's next ``_warm_init_ell`` call (its
    masters, ELL masters, carry and arguments), its output and the
    chunk result it leads to."""
    seen = {}
    orig_init, orig_run = jwarm._warm_init_ell, jwarm.WarmSolver._run_chunks

    def init(*args, **kw):
        st = s.warm_solver._states[np.dtype(np.float64)]
        seen.update(masters=[np.asarray(m) for m in st.masters],
                    ell=[np.asarray(t) for t in st.ell],
                    carry=[np.asarray(c) for c in st.carry],
                    mc=np.asarray(args[10]), eps=kw["eps"])
        out = orig_init(*args, **kw)
        seen["out"] = [np.asarray(x) for x in out]
        return out

    def run(self, *args, **kw):
        out = orig_run(self, *args, **kw)
        if "out" in seen and "result" not in seen:
            seen["result"] = out[:4]
        return out
    monkeypatch.setattr(jwarm, "_warm_init_ell", init)
    monkeypatch.setattr(jwarm.WarmSolver, "_run_chunks", run)
    return seen


@pytest.mark.parametrize("rounds", ["local", "global"])
def test_warm_init_ell_from_jax_state(monkeypatch, rounds):
    """K6's ELL arm from the JAX warm solver's own resident ELL state
    (handed across by ``convert.port_ell_warm_state``) equals
    ``_warm_init_ell`` bit for bit (cv_live included), and the rounds
    from there (K8 local, K7 global) equal the JAX warm solve."""
    s, clusters, flows, rng = build_clusters(
        jax_solver_system("on", "on", rounds), 42, per_cluster=40)
    s.solve()
    seen = capture_warm_ell(monkeypatch, s)
    grow_step(s, clusters, flows, rng, 1)
    s.solve()
    assert s.warm_solver.last_mode == "warm" and "result" in seen
    st = convert.port_warm_state(seen["masters"], seen["carry"][:6],
                                 np.float64, "cpu")
    convert.port_ell_warm_state(st, seen["ell"], seen["carry"])
    w, pen = st.ell_work, st.masters[5]
    mc = torch.from_numpy(np.array(seen["mc"]))
    assert k6.warm_init_ell(st.ell, w, pen, mc, seen["eps"]) is True
    for name, want in zip(("v_value", "v_fixed", "remaining", "usage",
                           "light"), seen["out"][:5]):
        assert same(getattr(w, name), want), name
    assert same(w.cv_live, seen["out"][6])
    view = s.array_view
    has_bounds = bool(np.any((view.v_bound > 0) & (view.v_penalty > 0)))
    got = lmm_torch.run_chunks(
        st.ell, w, pen, seen["eps"], st.masters[6], has_bounds,
        bool(view.c_fatpipe.any()), rounds == "global", 4096, ("t", "t"))
    assert same_result(got, seen["result"])


def test_ell_delta_scatter_equals_apply_deltas_ell():
    """K5's ELL use (plain version) equals ``_apply_deltas_ell``: six
    flat runs, padded as the JAX warm solver pads them, validity written
    as weight > 0 (a negative and a zero weight among them)."""
    rng = np.random.default_rng(5)
    n_c, wc, n_v, wv = 16, 8, 40, 4
    masters = [rng.integers(0, n_v, (n_c, wc)).astype(np.int32),
               rng.uniform(0, 2, (n_c, wc)), rng.random((n_c, wc)) < 0.5,
               rng.integers(0, n_c, (n_v, wv)).astype(np.int32),
               rng.random((n_v, wv)) < 0.5, rng.uniform(0, 2, (n_v, wv))]
    n, k = 16, 11
    cv_idx = np.sort(rng.choice(n_c * wc, k, replace=False))
    vc_idx = np.sort(rng.choice(n_v * wv, k, replace=False))
    w = rng.choice([-1.0, 0.0, 0.5, 2.0], k)
    cols = [cv_idx, rng.integers(0, n_v, k), w, vc_idx,
            rng.integers(0, n_c, k), w]
    pads = []
    for src, dt in zip(cols, (np.int32, np.int32, np.float64, np.int32,
                              np.int32, np.float64)):
        a = np.full(n, src[0], dt)
        a[:k] = src
        pads.append(a)
    want = jwarm._apply_deltas_ell(*masters, *pads)
    f = [x.astype(np.float64) for x in pads]
    runs = ((f[0], f[1]), (f[0], f[2]), (f[0], f[2]), (f[3], f[4]),
            (f[3], f[5]), (f[3], f[5]))
    payload = np.concatenate([x for run in runs for x in run])
    got = [torch.from_numpy(m.copy()) for m in masters]
    layout = [(ti, 2 * n * ti, n) for ti in range(len(ELL_FIELDS))]
    assert ell_delta_scatter(torch.from_numpy(payload), layout, got) is True
    for g, wnt in zip(got, want):
        assert same(g, np.asarray(wnt))
