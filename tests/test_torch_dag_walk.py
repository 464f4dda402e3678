"""K10's walk over the out-edge CSR (``simgrid_tpu_torch/kernels/
dag_walk.py``) against the JAX package's walk on the CPU, bit for bit
(tolerance 0), on ``bench.py``'s three collective schedules (the
64-rank ring allreduce and the 256- and 1,024-rank recursive-doubling
allreduces) with seeded random completion masks, two advances in a row.

The JAX walk is the JAX superstep program's own statements
(``simgrid_tpu/ops/lmm_drain.py`` ``_superstep_program``, the
``has_coll`` arm's DAG walk), taken from its source and jitted, and
vmapped over a fleet as ``simgrid_tpu/ops/lmm_batch.py`` vmaps the
program.  The port's plain walk and a model of the card's order (the
completions visited in another order, one integer decrement at a time,
a date written where a count goes from 1 to 0) are held to it.
"""

import inspect
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simgrid_tpu.collectives import CollectiveSpec as JaxSpec
from simgrid_tpu.ops import lmm_drain as jax_drain
from simgrid_tpu_torch.kernels import dag_walk as k10
from simgrid_tpu_torch.kernels.common import (ADV_OK, N_CTRL, PENDING,
                                              T_SUM, Work)

CASES = {"ring64": ("lr", 64, 1 << 17), "rdb256": ("rdb", 256, 1 << 20),
         "rdb1024": ("rdb", 1024, 1 << 20)}
#: completion densities: a handful of flows, a few percent, half
DENSITIES = (0.0005, 0.05, 0.5)


def _jax_walk():
    """The JAX program's walk statements as a jitted function of
    ``(pred_c, ready2, done, edge_src, edge_dst, t_new, exec_cost)``."""
    src = inspect.getsource(jax_drain._superstep_program)
    at = src.index("pred2 = pred_c.at[edge_dst]")
    start = src.rindex("\n", 0, at) + 1
    block = textwrap.dedent(src[start:src.index("adv_dt2 =", at)])
    code = ("def walk(pred_c, ready2, done, edge_src, edge_dst, t_new, "
            "exec_cost):\n" + textwrap.indent(block, "    ")
            + "    return pred2, ready2, newly.sum()\n")
    ns = {}
    exec(code, {"jnp": jnp}, ns)
    return ns["walk"]


WALK = _jax_walk()
JAX_WALK = jax.jit(WALK)
#: the fleet: shared edges and costs, per-lane state and clock
JAX_FLEET_WALK = jax.jit(jax.vmap(WALK, in_axes=(0, 0, 0, None, None, 0,
                                                 None)))


@pytest.fixture(scope="module", params=list(CASES))
def schedule(request):
    algo, ranks, payload = CASES[request.param]
    dc = JaxSpec("allreduce", algo, ranks, "nic", payload, bw=1e9).build()
    return dc


def _masks(seed, n_v, lead=()):
    rng = np.random.default_rng(seed)
    return [rng.random(lead + (n_v,)) < d for d in DENSITIES]


def _midway(dc, seed, lead=()):
    """Counts of a schedule part-way through: each flow's count between
    0 and its number of in-edges (``pred0``), seeded."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, dc.pred0.astype(np.int64) + 1,
                        lead + (dc.n_v,)).astype(np.int32)


def _port_walk(dc, csr, pred, ready, done, t_new, ok=None):
    """The port's walk on the CPU; a fleet when ``done`` is [B, V]."""
    V = dc.n_v
    B = None if done.ndim == 1 else done.shape[0]
    w = Work(V, 4, torch.float64, torch.device("cpu"), B=B)
    w.done.copy_(torch.from_numpy(done))
    w.ctrl.view(-1, N_CTRL)[:, ADV_OK] = torch.from_numpy(
        np.ones(1 if B is None else B, np.int32) if ok is None else ok)
    w.fctrl.view(-1, 4)[:, T_SUM] = torch.from_numpy(np.atleast_1d(t_new))
    p, r = torch.from_numpy(pred.copy()), torch.from_numpy(ready.copy())
    k10.dag_walk(w, torch.from_numpy(dc.edge_src),
                 torch.from_numpy(dc.edge_dst), p, r,
                 torch.from_numpy(dc.exec_cost), csr)
    return p.numpy(), r.numpy(), w.ctrl.view(-1, N_CTRL)[:, PENDING].numpy()


def _card_order_walk(csr, pred, ready, done, t_new, cost, seed):
    """The kernel's walk, one decrement at a time, the completions in a
    seeded random order (the blocks and threads of the card run in no
    order): a count's date is written where it goes from 1 to 0."""
    pred, ready = pred.copy(), ready.copy()
    ptr = csr.src_ptr.numpy()
    dst = csr.out_dst.numpy()
    freed = 0
    for f in np.random.default_rng(seed).permutation(np.flatnonzero(done)):
        for d in dst[ptr[f]:ptr[f + 1]]:
            pred[d] -= 1
            if pred[d] == 0:
                ready[d] = t_new + cost[d]
                freed += 1
    return pred, ready, freed


def test_csr_holds_the_edge_list(schedule):
    """Each flow's out-edges are its rows of the edge list, in order,
    and the pad rows are gone."""
    dc = schedule
    csr = k10.dag_csr(torch.from_numpy(dc.edge_src),
                      torch.from_numpy(dc.edge_dst), dc.n_v)
    ptr, dst = csr.src_ptr.numpy(), csr.out_dst.numpy()
    keep = dc.edge_dst < dc.n_v
    assert ptr[0] == 0 and ptr[-1] == keep.sum() == dc.n_edges
    assert csr.src_ptr.dtype == csr.out_dst.dtype == torch.int32
    order = np.argsort(dc.edge_src[keep], kind="stable")
    np.testing.assert_array_equal(dst, dc.edge_dst[keep][order])
    np.testing.assert_array_equal(np.diff(ptr), np.bincount(
        dc.edge_src[keep], minlength=dc.n_v))


def test_solo_walk_equals_jax(schedule):
    """Two advances in a row at each density, from the schedule's start
    and from counts part-way through it: the port's plain walk and the
    card's order equal the JAX program's walk (counts, dates, flows
    freed)."""
    dc = schedule
    csr = k10.dag_csr(torch.from_numpy(dc.edge_src),
                      torch.from_numpy(dc.edge_dst), dc.n_v)
    es, ed, cost = (jnp.asarray(a) for a in (dc.edge_src, dc.edge_dst,
                                             dc.exec_cost))
    freed = 0
    for i, (mask, start) in enumerate(
            (m, s) for m in _masks(dc.n_v, dc.n_v)
            for s in (dc.pred0.astype(np.int32), _midway(dc, dc.n_v))):
        pred = start
        ready = np.full(dc.n_v, np.inf)
        for k, t_new in enumerate((1e-3, 2.5e-3)):
            done = np.roll(mask, 7 * k)
            jp, jr, jn = JAX_WALK(jnp.asarray(pred), jnp.asarray(ready),
                                  jnp.asarray(done), es, ed,
                                  jnp.float64(t_new), cost)
            jp, jr, jn = np.asarray(jp), np.asarray(jr), int(jn)
            pp, pr, pn = _port_walk(dc, csr, pred, ready, done, t_new)
            np.testing.assert_array_equal(pp, jp)
            np.testing.assert_array_equal(pr, jr)
            assert int(pn[0]) == jn
            cp, cr, cn = _card_order_walk(csr, pred, ready, done, t_new,
                                          dc.exec_cost, 10 * i + k)
            np.testing.assert_array_equal(cp, jp)
            np.testing.assert_array_equal(cr, jr)
            assert cn == jn
            freed += jn
            pred, ready = jp, jr
    assert freed > 0


def test_fleet_walk_equals_jax(schedule):
    """A fleet of 4 whose replicas complete different flows at different
    clocks from different counts part-way through the schedule, three
    advances in a row, one replica with ``ADV_OK`` 0 (its
    advance did not commit: JAX keeps its state, the port moves
    nothing), against the vmapped JAX walk."""
    dc = schedule
    B, V = 4, dc.n_v
    csr = k10.dag_csr(torch.from_numpy(dc.edge_src),
                      torch.from_numpy(dc.edge_dst), V)
    es, ed, cost = (jnp.asarray(a) for a in (dc.edge_src, dc.edge_dst,
                                             dc.exec_cost))
    ok = np.array([1, 0, 1, 1], np.int32)
    pred = start = _midway(dc, B, (B,))
    ready = np.full((B, V), np.inf)
    for k, mask in enumerate(_masks(V + 1, V, (B,))):
        t_new = np.arange(1, B + 1) * 1e-3 * (k + 1)
        jp, jr, jn = (np.asarray(x) for x in JAX_FLEET_WALK(
            jnp.asarray(pred), jnp.asarray(ready), jnp.asarray(mask), es,
            ed, jnp.asarray(t_new), cost))
        sel = ok.astype(bool)
        jp = np.where(sel[:, None], jp, pred)
        jr = np.where(sel[:, None], jr, ready)
        jn = np.where(sel, jn, 0)
        pp, pr, pn = _port_walk(dc, csr, pred, ready, mask, t_new, ok)
        np.testing.assert_array_equal(pp, jp)
        np.testing.assert_array_equal(pr, jr)
        np.testing.assert_array_equal(pn, jn)
        assert jn.sum() > 0
        pred, ready = jp, jr
    np.testing.assert_array_equal(pred[1], start[1])


def test_walk_builds_its_csr_when_not_given(schedule):
    """``dag_walk`` without a CSR builds one from the edge list: the
    same walk as with the one built on upload."""
    dc = schedule
    csr = k10.dag_csr(torch.from_numpy(dc.edge_src),
                      torch.from_numpy(dc.edge_dst), dc.n_v)
    done = _masks(3, dc.n_v)[1]
    pred, ready = dc.pred0.astype(np.int32), np.full(dc.n_v, np.inf)
    a = _port_walk(dc, csr, pred, ready, done, 0.5)
    b = _port_walk(dc, None, pred, ready, done, 0.5)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
