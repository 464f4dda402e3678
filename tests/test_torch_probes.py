"""The op-cost probe (``simgrid_tpu_torch/probes/``, K12-K15) against the
Pallas probes P1-P8 of ``tools/``, on the CPU.

The tools define their kernels inside ``main()``, so the kernel bodies
are copied here verbatim (``test_copied_bodies_match_the_tools`` holds
each copy to its tool's source) and run with ``pl.pallas_call(...,
interpret=True)`` at small shapes drawn as the tools draw them
(``probes/data.py``).  The port's wrappers take their plain versions on
CPU tensors.  Bit equality where the function fixes every rounding: the
gathers (P1, P4, P5), the in-order segment sum against ``np.add.at``
(P2, P7), the sequential scan against ``np.cumsum`` (P6), the round loop
(P3) and ``x * 2`` (P8).  Where JAX sums in another order (``sk``'s
scatter, ``mk``'s one-hot matmul, ``ck``'s cumsum, which XLA:CPU does
not fold left to right), the port is held to JAX within the bound of a
reordered sum of m positive terms, ``2 m u |want|`` (u = 2^-24 in
float32, 2^-53 in float64; ``probes/common.reorder_tol``).
"""

import functools
import inspect
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from simgrid_tpu_torch.kernels import launch_counts
from simgrid_tpu_torch.kernels.probe_gather import probe_gather
from simgrid_tpu_torch.kernels.probe_loop import (CondLoop, LoopGraph,
                                                  probe_double,
                                                  probe_loop)
from simgrid_tpu_torch.kernels.probe_scan import probe_scan
from simgrid_tpu_torch.kernels.probe_segsum import (probe_segsum,
                                                    segment_csr)
from simgrid_tpu_torch.probes import data
from simgrid_tpu_torch.probes.common import reorder_tol
from simgrid_tpu_torch.probes.opcost import run_opcost
from simgrid_tpu_torch.probes.pallas_gather2 import layouts
from simgrid_tpu_torch.probes.pallas_probe import loop_want
from simgrid_tpu_torch.probes.scaling import run_scaling

jax.config.update("jax_enable_x64", True)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
#: the probe sizes of these tests: C = 64, V = 512 (P1-P4);
#: C = 256, E = 8,192 (P5-P7)
SMALL, SMALL3 = 1 / 256, 1 / 64
DTYPES = [(np.float32, jnp.float32, torch.float32),
          (np.float64, jnp.float64, torch.float64)]
DT_IDS = ["float32", "float64"]


# ---- the tools' kernel bodies, verbatim ---------------------------------

def p1_gk():
    def gk(tab_ref, idx_ref, o_ref):
        o_ref[:] = jnp.take(tab_ref[:], idx_ref[:], axis=0)
    return gk


def p2_sk(C, dtype):
    def sk(idx_ref, w_ref, o_ref):
        o_ref[:] = jnp.zeros((C,), dtype).at[idx_ref[:].ravel()].add(
            w_ref[:].ravel())
    return sk


def p3_lk(K_ROUNDS, dtype):
    def lk(tab_ref, idx_ref, o_ref):
        def body(i, acc):
            g = jnp.take(tab_ref[:] + acc[0, 0] * 1e-30, idx_ref[:],
                         axis=0)
            return acc + g.sum(axis=1, keepdims=True)[:8, :1] * 0 + \
                g[:8, :1]
        o_ref[:] = jax.lax.fori_loop(0, K_ROUNDS, body,
                                     jnp.zeros((8, 1), dtype))
    return lk


def p4_a(C):
    def k(tab_ref, idx_ref, o_ref):
        t8 = jnp.broadcast_to(tab_ref[:].reshape(1, C), (8, C))
        o_ref[:] = jnp.take_along_axis(t8, idx_ref[:], axis=1)
    return k


def p4_b(C):
    def k(tab_ref, idx_ref, o_ref):
        t = jnp.broadcast_to(tab_ref[:].reshape(1, C), (64, C))
        o_ref[:] = jnp.take_along_axis(t, idx_ref[:], axis=1)
    return k


def p4_c():
    def k(tab_ref, idx_ref, o_ref):
        o_ref[:] = jnp.take(tab_ref[:], idx_ref[:], axis=0)[..., 0]
    return k


def p4_d(C):
    def k(tab_ref, idx_ref, o_ref):
        t = jnp.broadcast_to(tab_ref[:].reshape(C, 1), (C, 128))
        o_ref[:] = jnp.take_along_axis(t, idx_ref[:], axis=0)
    return k


def p5_k(Cw, R):
    def k(tab_ref, idx_ref, o_ref, Cw=Cw, R=R):
        x = jnp.broadcast_to(tab_ref[:].reshape(1, Cw), (R, Cw))
        o_ref[:] = jnp.take_along_axis(x, idx_ref[:], axis=1)
    return k


def p6_ck():
    def ck(w_ref, o_ref):
        o_ref[:] = jnp.cumsum(w_ref[:], axis=1)
    return ck


def p7_mk(C, E, dtype):
    def mk(idx_ref, w_ref, o_ref):
        # process in row-blocks of 256x128 elements -> one-hot [32768,
        # C] is too big; instead loop over 16 chunks of 2048x128? keep
        # simple: one-hot per 8-row chunk (1024 elems) against C lanes
        def body(i, acc):
            ii = idx_ref[pl.ds(i * 8, 8), :].reshape(1024)
            ww = w_ref[pl.ds(i * 8, 8), :].reshape(1024)
            oh = (ii[:, None] == jax.lax.broadcasted_iota(
                jnp.int32, (1024, C), 1)).astype(dtype)
            return acc + jnp.dot(ww.reshape(1, 1024), oh,
                                 preferred_element_type=dtype)
        acc = jax.lax.fori_loop(0, E // 1024,
                                functools.partial(body),
                                jnp.zeros((1, C), dtype))
        o_ref[:] = acc
    return mk


def p8_pk():
    def pk(x_ref, o_ref):
        o_ref[:] = x_ref[:] * 2.0
    return pk


COPIES = [
    ("tpu_pallas_probe.py", p1_gk()), ("tpu_pallas_probe.py", p2_sk(1, 0)),
    ("tpu_pallas_probe.py", p3_lk(1, 0)),
    ("tpu_pallas_gather2.py", p4_a(1)), ("tpu_pallas_gather2.py", p4_b(1)),
    ("tpu_pallas_gather2.py", p4_c()), ("tpu_pallas_gather2.py", p4_d(1)),
    ("tpu_pallas_gather3.py", p5_k(1, 1)), ("tpu_pallas_gather3.py", p6_ck()),
    ("tpu_pallas_gather3.py", p7_mk(1, 1, 0)),
    ("tpu_opcost.py", p8_pk())]


@pytest.mark.parametrize("tool,fn", COPIES,
                         ids=[f"{t}:{f.__qualname__.split('.')[0]}"
                              for t, f in COPIES])
def test_copied_bodies_match_the_tools(tool, fn):
    """Each kernel body above appears, dedented, in its tool's source."""
    body = textwrap.dedent(inspect.getsource(fn)).splitlines()
    with open(os.path.join(TOOLS, tool)) as f:
        lines = f.read().splitlines()
    n = len(body)
    assert any(textwrap.dedent("\n".join(lines[i:i + n])).splitlines()
               == body for i in range(len(lines) - n + 1)), \
        f"{fn.__name__} is not a copy of {tool}"


def interpret(kernel, out_shape, dtype, *args):
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_shape, dtype),
        interpret=True)(*args))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- P1-P3 (tools/tpu_pallas_probe.py) -----------------------------------

@pytest.mark.parametrize("npdt,jdt,tdt", DTYPES, ids=DT_IDS)
def test_p1_gather_equals_gk(npdt, jdt, tdt):
    d = data.pallas_probe(SMALL)
    tab, idx = d["tab"].astype(npdt), d["idx"]
    got = interpret(p1_gk(), idx.shape, jdt, tab, idx)
    np.testing.assert_array_equal(got, tab[idx])
    for arm in ("global", "smem"):
        port = probe_gather(t(tab), t(idx), arm).numpy()
        np.testing.assert_array_equal(port, got)


@pytest.mark.parametrize("npdt,jdt,tdt", DTYPES, ids=DT_IDS)
def test_p2_segsum_inorder_equals_add_at(npdt, jdt, tdt):
    d = data.pallas_probe(SMALL)
    C, idx, w = d["C"], d["idx"], d["w"].astype(npdt)
    want = np.zeros(C, npdt)
    np.add.at(want, idx.ravel(), w.ravel())
    csr = segment_csr(t(idx), C)
    for arm in ("atomic", "smem_atomic", "inorder"):
        port = probe_segsum(t(idx), t(w), C, arm, csr=csr).numpy()
        np.testing.assert_array_equal(port, want)
    got = interpret(p2_sk(C, jdt), (C,), jdt, idx, w)
    terms = np.maximum(np.bincount(idx.ravel(), minlength=C), 1)
    assert np.all(np.abs(got - port) <= reorder_tol(port, terms, tdt))


@pytest.mark.parametrize("npdt,jdt,tdt", DTYPES, ids=DT_IDS)
def test_p3_loop_equals_lk(npdt, jdt, tdt):
    d = data.pallas_probe(SMALL)
    tab, idx = d["tab"].astype(npdt), d["idx"]
    got = interpret(p3_lk(16, jdt), (8, 1), jdt, tab, idx)
    np.testing.assert_array_equal(got, loop_want(tab, idx, 16))
    for arm in ("coop", "launch", "graph", "cond"):
        port = probe_loop(t(tab), t(idx), 16, arm).numpy()
        np.testing.assert_array_equal(port, got)
    assert np.all(got > 16)   # 16 rounds of values in [1, 2)


# ---- P4 (tools/tpu_pallas_gather2.py) ------------------------------------

@pytest.mark.parametrize("npdt,jdt,tdt", DTYPES, ids=DT_IDS)
def test_p4_forms_equal_the_flat_gather(npdt, jdt, tdt):
    d = data.pallas_gather2(SMALL)
    C, tab = d["C"], d["tab"].astype(npdt)
    lay = layouts(d["idx"], C)
    forms = {"A_tala_8xK": (p4_a(C), tab),
             "B_tala_64xK": (p4_b(C), tab),
             "C_rowgather": (p4_c(), tab.reshape(C, 1)),
             "D_tala_axis0": (p4_d(C), tab)}
    for form, (k, tab_in) in forms.items():
        ix = lay[form]
        got = interpret(k, ix.shape, jdt, tab_in, ix)
        for arm in ("global", "smem"):
            port = probe_gather(t(tab), t(ix), arm).numpy()
            np.testing.assert_array_equal(port, got, err_msg=form)


# ---- P5-P7 (tools/tpu_pallas_gather3.py) ---------------------------------

@pytest.mark.parametrize("npdt,jdt,tdt", DTYPES, ids=DT_IDS)
def test_p5_widths_equal_the_gather(npdt, jdt, tdt):
    d = data.pallas_gather3(SMALL3)
    E, tab = d["E"], d["tab"].astype(npdt)
    assert d["widths"] == (128, 256)
    for cw in d["widths"]:
        R = E // cw
        ix = (d["idx"] % cw).reshape(R, cw)
        got = interpret(p5_k(cw, R), (R, cw), jdt, tab[:cw], ix)
        np.testing.assert_array_equal(got, tab[:cw][ix])
        for arm in ("global", "smem"):
            port = probe_gather(t(tab[:cw]), t(ix), arm).numpy()
            np.testing.assert_array_equal(port, got)


@pytest.mark.parametrize("npdt,jdt,tdt", DTYPES, ids=DT_IDS)
def test_p6_scan(npdt, jdt, tdt):
    """``seq`` equals np.cumsum by bits; XLA:CPU's cumsum is not a left
    fold (not bit-equal), within the reordered-sum bound."""
    x = data.pallas_gather3(SMALL3)["w_cum"].astype(npdt)
    want = np.cumsum(x, axis=1)
    for arm in ("seq", "block"):
        np.testing.assert_array_equal(probe_scan(t(x), arm).numpy(), want)
    got = interpret(p6_ck(), x.shape, jdt, x)
    terms = np.arange(1, x.shape[1] + 1)
    assert np.all(np.abs(got - want) <= reorder_tol(want, terms, tdt))
    cm = probe_scan(t(x[0]), "seq", "min").numpy()
    np.testing.assert_array_equal(cm, np.minimum.accumulate(x[0]))


@pytest.mark.parametrize("npdt,jdt,tdt", DTYPES, ids=DT_IDS)
def test_p7_segsum_against_onehot_matmul(npdt, jdt, tdt):
    d = data.pallas_gather3(SMALL3)
    C, E, idx = d["C"], d["E"], d["idx"]
    w = d["w_seg"].astype(npdt)
    want = np.zeros(C, npdt)
    np.add.at(want, idx, w)
    port = probe_segsum(t(idx), t(w), C, "inorder").numpy()
    np.testing.assert_array_equal(port, want)
    got = interpret(p7_mk(C, E, jdt), (1, C), jdt, idx.reshape(-1, 128),
                    w.reshape(-1, 128))[0]
    terms = np.maximum(np.bincount(idx, minlength=C), 1)
    assert np.all(np.abs(got - want) <= reorder_tol(want, terms, tdt))


# ---- P8 (tools/tpu_opcost.py) --------------------------------------------

@pytest.mark.parametrize("npdt,jdt,tdt", DTYPES, ids=DT_IDS)
def test_p8_double_equals_pk(npdt, jdt, tdt):
    x = np.ones((256, 128), npdt)
    got = interpret(p8_pk(), x.shape, jdt, x)
    np.testing.assert_array_equal(probe_double(t(x)).numpy(), got)
    assert got[0, 0] == 2.0


# ---- the port's own paths on the CPU -------------------------------------

def test_segsum_channels_and_min():
    """Three channels (``scatter_add3``) and the minimum, with empty rows
    (0 and +inf, as the zeros / full(inf) scatters give)."""
    rng = np.random.default_rng(3)
    C = 40
    idx = rng.integers(0, C - 5, 300).astype(np.int32)
    w3 = rng.uniform(-1, 1, (300, 3))
    want = np.zeros((C, 3))
    np.add.at(want, idx, w3)
    for arm in ("atomic", "smem_atomic", "inorder"):
        np.testing.assert_array_equal(
            probe_segsum(t(idx), t(w3), C, arm).numpy(), want)
    want_min = np.full(C, np.inf)
    np.minimum.at(want_min, idx, w3[:, 0])
    got = probe_segsum(t(idx), t(np.ascontiguousarray(w3[:, 0])), C,
                       "inorder", "min").numpy()
    np.testing.assert_array_equal(got, want_min)
    with pytest.raises(ValueError, match="adds only"):
        probe_segsum(t(idx), t(w3), C, "atomic", "min")
    with pytest.raises(ValueError, match="shaped like idx"):
        probe_segsum(t(idx), t(w3[:10]), C)


def test_wrappers_validate_and_count_nothing_on_cpu():
    before = launch_counts()
    tab = torch.ones(16)
    idx = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        probe_gather(tab, idx, "texture")
    with pytest.raises(TypeError):
        probe_gather(tab, idx.long())
    with pytest.raises(ValueError):
        probe_scan(tab, "tree")
    with pytest.raises(ValueError):
        probe_loop(tab, idx, arm="persistent")
    with pytest.raises(ValueError, match="CUDA"):
        LoopGraph(tab, idx)
    with pytest.raises(ValueError, match="CUDA"):
        CondLoop(tab, idx)
    assert probe_loop(tab, idx, 0).eq(0).all()
    assert launch_counts() == before


def test_data_reproduces_the_tools_draws():
    """At scale 1 every tool's arrays, drawn in the tool's order."""
    rng = np.random.default_rng(7)
    d = data.pallas_probe()
    np.testing.assert_array_equal(
        d["idx"], rng.integers(0, 16384, (131072, 4)).astype(np.int32))
    np.testing.assert_array_equal(d["tab"].astype(np.float32),
                                  rng.uniform(1, 2, 16384).astype(np.float32))
    np.testing.assert_array_equal(d["w"], rng.uniform(0.5, 1.5, (131072, 4)))
    np.testing.assert_array_equal(data.pallas_gather2()["tab"], d["tab"])
    rng = np.random.default_rng(7)
    g3 = data.pallas_gather3()
    assert g3["widths"] == (128, 2048, 16384)
    np.testing.assert_array_equal(g3["tab"], rng.uniform(1, 2, 16384))
    np.testing.assert_array_equal(g3["idx"],
                                  rng.integers(0, 16384, 524288))
    np.testing.assert_array_equal(g3["w_cum"],
                                  rng.uniform(0.5, 1.5, (32, 16384)))
    np.testing.assert_array_equal(g3["w_seg"], rng.uniform(0.5, 1.5, 524288))
    oc = data.opcost()
    rng = np.random.default_rng(7)
    np.testing.assert_array_equal(
        oc["e_cnst"][:400_000], np.sort(rng.integers(0, 16384, 400_000)))
    np.testing.assert_array_equal(oc["e_w"][:400_000],
                                  rng.uniform(0.5, 1.5, 400_000))
    assert (oc["Eb"], oc["Vb"], oc["seg_end"][-1]) == (524288, 131072,
                                                       400_000)
    sc = data.scaling()
    assert sorted(sc["sizes"]) == list(data.SCALING_N)
    assert sc["idx_ops"].shape == (131072, 4)


def test_run_opcost_on_cpu_checks_every_row():
    r = run_opcost(device="cpu", scale=SMALL)
    assert r["ok"] and r["device"]["platform"] == "cpu"
    assert r["sync_ms"] is None
    names = {(x["probe"], x["name"]) for x in r["rows"]}
    assert ("pallas_probe", "P3_loop16") in names
    assert ("opcost", "P8_double") in names
    assert len(names) == 3 + 4 + 3 + 12
    for row in r["rows"]:
        assert row["ok"], row
        assert row["bound_ms"] is None     # no device bound from a CPU run
        if row["exact"]:
            assert row["max_abs_err"] == 0.0, row
    arms = {(x["name"], x["arm"], x["dtype"]) for x in r["rows"]}
    for dt in ("float32", "float64"):
        assert ("P2_segsum", "smem_atomic", dt) in arms
        assert ("P3_loop16", "graph", dt) in arms
        assert ("P3_loop16", "cond", dt) in arms
        assert ("cumsum_E", "block", dt) in arms


def test_run_scaling_on_cpu():
    r = run_scaling(device="cpu", scale=SMALL, dtypes=("float32",))
    assert r["ok"]
    names = [x["name"] for x in r["rows"]]
    assert names.count("chain8_gathers") == 4      # K15's four arms
    assert len({x["n"] for x in r["rows"] if "n" in x}) == 6
