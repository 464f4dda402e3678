"""K8's constraint-ordered entry layout and K9's stages on the CPU.

* The layout built at upload (``ops/lmm_ell.build_vc_index`` with K8's
  ``vc_prep``) equals the one ``chain_stage_plain`` re-derives over the
  kept rows after every stage, array by array.
* A torch model of the card kernels' order of operations (each
  constraint's level kept in ``Work.rou`` from round to round, ``w /
  penalty`` precomputed per entry, each constraint's sums folded over
  its entries in layout order, the live and fixed state read through one
  code a row), run in place of K8 through whole chains and dense solves,
  equals JAX's ``_ell_chain_stage``, ``_vc_chunk`` and dense program by
  bits, with and without FATPIPE constraints.
* ``pad="tight"`` (``bench.py``'s ``stage_device``): the chain and the
  dense path at exact row widths that are not multiples of 32 equal
  JAX's under ``lmm/pad: tight``; ``fold_rows`` is XLA:CPU's row sum at
  any width.
* A chain keeps its buffers and loops per shape across solves.

The systems are ``bench.py``'s headline generator cut to 512
constraints x 3,000 variables (degree 4), with ``_CHAIN_MIN_V`` at 512
so the chain runs three stages.  Tolerance 0 throughout.
"""

import numpy as np
import pytest
import torch

from simgrid_tpu.ops import lmm_jax
from simgrid_tpu.utils.config import config
from simgrid_tpu_torch.kernels import ell_chain as k9
from simgrid_tpu_torch.kernels import ell_round as k7
from simgrid_tpu_torch.kernels.common import IT, LIGHT, VLIVE, Work
from simgrid_tpu_torch.kernels.ell_round import INF, round_runs
from simgrid_tpu_torch.kernels.vc_round import vc_prep, vc_round_plain
from simgrid_tpu_torch.ops import lmm_ell, lmm_torch
from simgrid_tpu_torch.workloads.bench_solve import build_arrays

CLASS = dict(n_c=512, n_v=3000, deg=4)


@pytest.fixture(autouse=True)
def small_stages(monkeypatch):
    for mod in (lmm_ell, lmm_jax):
        monkeypatch.setattr(mod, "_CHAIN_MIN_V", 512)


def arrays(fat=False, pad="pow2", n_c=CLASS["n_c"], deg=CLASS["deg"]):
    a = build_arrays(np.random.default_rng(7), n_c, CLASS["n_v"], deg,
                     np.float64, pad)
    if fat:
        f = a.c_fatpipe.copy()
        f[:a.n_cnst] = np.random.default_rng(12).random(a.n_cnst) < 0.10
        a = a._replace(c_fatpipe=f)
    return a


def jax_solve(a, chain, pad="pow2"):
    config["lmm/layout"], config["lmm/chain"] = "ell", chain
    config["lmm/pad"] = pad
    try:
        return lmm_jax.solve_arrays(lmm_jax.LmmArrays(*a), 1e-9)
    finally:
        config["lmm/layout"], config["lmm/chain"] = "auto", "auto"
        config["lmm/pad"] = "pow2"


def same(p, j):
    return p[3] == j[3] and all(
        np.array_equal(np.asarray(x).view(np.int64),
                       np.asarray(y).view(np.int64))
        for x, y in zip(p[:3], j[:3]))


# ---------------------------------------------------------------------------
# the layout at upload and after every stage


def _fresh_layout(cs):
    """K8's layout built from scratch over the current rows, keeping the
    entries of live rows only (what a stage keeps), with its w /
    penalty."""
    s = cs.sys
    live = ~cs.w.v_fixed[:s.n_v] & (cs.pen > 0)
    lay = lmm_ell.build_vc_index(s.vc_cnst, s.vc_valid & live[:, None],
                                 s.vc_w, s.n_c)
    fresh = s._replace(**lay)
    vc_prep(fresh, cs.w, cs.pen)
    return lay


@pytest.mark.parametrize("fat", [False, True], ids=["shared", "fatpipe"])
def test_layout_at_upload_equals_rederived(fat):
    a = arrays(fat)
    ell = lmm_ell.ell_from_arrays(a)
    cpu = torch.device("cpu")
    sys, pen = lmm_ell._chain_tables([torch.from_numpy(np.array(x)) for x in (
        ell.vc_cnst, ell.vc_w, ell.vc_valid, ell.v_penalty, ell.c_bound,
        ell.c_fatpipe)])
    init = lmm_ell.chain_init(ell, 1e-9, fat)
    w = Work(sys.n_v, sys.n_c, torch.float64, cpu)
    for t, src in zip((w.v_value, w.v_fixed, w.remaining, w.usage,
                       w.light), init[:5]):
        t.copy_(torch.from_numpy(np.array(src)))
    cs = k9.ChainState(sys, pen, torch.from_numpy(init[5]), w)
    vc_prep(cs.sys, w, cs.pen)
    halves = lmm_ell.chain_halves(sys.n_v)
    assert halves == (2048, 1024, 512)
    k9.chain_arm(cs, 64, halves[0], first=True)
    for k, half in enumerate(halves):
        while vc_round_plain(cs.sys, w, cs.pen, 1e-9, fat):
            pass
        k9.chain_stage(cs, half, (64, halves[k + 1]) if k + 1 < len(halves)
                       else (-1, -1))
        assert cs.sys.n_v == half and cs.stage == k + 1
        want = _fresh_layout(cs)
        n = int(cs.sys.vcx_ptr[-1])
        assert n == len(want["vcx_idx"]) > 0
        assert torch.equal(cs.sys.vcx_ptr, want["vcx_ptr"])
        for name in ("vcx_idx", "vcx_row", "vcx_w", "vcx_upen"):
            assert torch.equal(getattr(cs.sys, name)[:n], want[name]), name
    assert int(w.ctrl[VLIVE]) <= halves[-1]


# ---------------------------------------------------------------------------
# the card kernels' order of operations, modelled, against JAX


def model_round(sys, w, pen, eps, has_fatpipe=False):
    """``csrc/vc_round.cu``'s round in its own order: ``rou`` read from
    ``w.rou`` (``vc_prep`` wrote it before the loop, each round keeps it),
    ``w / penalty`` from ``sys.vcx_upen``, each constraint's sums folded
    over its entries in layout order (the CPU's ``index_add_`` adds in
    index order), a row's state read through its code (1 fixed now, 2
    live after the round)."""
    c = w.ctrl
    if not round_runs(c):
        return False
    n, nc = sys.n_v, sys.n_c
    rou, light = w.rou, w.light
    vv, vf = w.v_value[:n], w.v_fixed[:n]
    live = (pen > 0) & ~vf
    cn, ok = sys.vc_cnst.long(), sys.vc_valid
    # v_nmin
    nmin_v = torch.where(ok & live[:, None], rou[cn], INF).amin(1)
    # c_proc over the layout (no walk for a constraint that is not light)
    m = int(sys.vcx_ptr[-1])
    row = sys.vcx_row[:m].long()
    ptr = sys.vcx_ptr.long()
    seg = torch.repeat_interleave(torch.arange(nc), ptr[1:] - ptr[:-1])
    nmin_c = torch.full((nc,), INF, dtype=rou.dtype).scatter_reduce_(
        0, seg, nmin_v[row], "amin")
    proc = light & (rou <= nmin_c)
    # v_fix
    level2 = torch.where(ok & live[:, None] & proc[cn], rou[cn],
                         INF).amin(1)
    fix = live & torch.isfinite(level2)
    value = torch.where(fix, level2 / torch.where(pen > 0, pen, 1.0), vv)
    code = torch.where(fix, 1, torch.where(live, 2, 0))[row]
    # c_apply: the in-order folds of the entries fixed now
    f, lv = code == 1, code == 2
    zero = torch.zeros(nc, dtype=rou.dtype)
    upen = sys.vcx_upen[:m]
    d_rem = zero.clone().index_add_(0, seg[f], (sys.vcx_w[:m]
                                                * value[row])[f])
    d_use = zero.clone().index_add_(0, seg[f], upen[f])
    has_live = torch.bincount(seg[lv], minlength=nc) > 0
    umax = zero.clone().scatter_reduce_(0, seg[lv], upen[lv], "amax")
    touched = d_use > 0
    ce = sys.c_bound * eps
    nr = w.remaining - d_rem
    nr = torch.where(nr < ce, 0.0, nr)
    nu = w.usage - d_use
    nu = torch.where(nu < eps, 0.0, nu)
    fat = sys.c_fatpipe if has_fatpipe else torch.zeros(nc, dtype=bool)
    use = torch.where(touched, torch.where(fat, umax, nu), w.usage)
    rem = torch.where(touched & ~fat, nr, w.remaining)
    drop = touched & (~(use > eps) | ~(rem > ce))
    light_n = light & ~drop & has_live
    vv.copy_(value)
    vf.copy_(vf | fix)
    w.remaining.copy_(rem)
    w.usage.copy_(use)
    light.copy_(light_n)
    rou.copy_(torch.where(light_n, rem / torch.where(light_n, use, 1.0),
                          INF))
    c[IT] = int(c[IT]) + 1
    c[LIGHT] = int(light_n.sum())
    c[VLIVE] = int((live & ~fix).sum())
    return True


@pytest.mark.parametrize("fat", [False, True], ids=["shared", "fatpipe"])
def test_kernel_order_model_equals_jax(monkeypatch, fat):
    a = arrays(fat)
    want = {ch: jax_solve(a, ch) for ch in ("on", "off")}
    plain = {ch: lmm_torch.solve_arrays(a, 1e-9, device="cpu",
                                        layout="ell", chain=ch)
             for ch in ("on", "off")}
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return model_round(*args, **kw)
    for mod in (lmm_ell, lmm_torch):
        monkeypatch.setattr(mod, "vc_round", counted)
    for ch in ("on", "off"):
        del calls[:]
        got = lmm_torch.solve_arrays(a, 1e-9, device="cpu", layout="ell",
                                     chain=ch)
        assert len(calls) >= got[3] > 0
        assert same(got, want[ch]) and same(plain[ch], want[ch]), ch


# ---------------------------------------------------------------------------
# tight padding


@pytest.mark.parametrize("n_c,deg,wc,fat", [
    (512, 4, 38, False), (256, 4, 65, False), (160, 3, 75, False),
    (256, 4, 65, True)])
def test_tight_padding_equals_jax(n_c, deg, wc, fat):
    """Exact row widths 38, 65 and 75 (and Wv 3 or 4), one of them with
    10% FATPIPE constraints: the chain and the dense path equal JAX's
    under ``lmm/pad: tight``."""
    a = arrays(fat, pad="tight", n_c=n_c, deg=deg)
    ell = lmm_ell.ell_from_arrays(a, "tight")
    assert ell.cv_var.shape[1] == wc and wc % 32
    assert ell.vc_cnst.shape[1] == deg
    for ch in ("on", "off"):
        got = lmm_torch.solve_arrays(a, 1e-9, device="cpu", layout="ell",
                                     chain=ch, pad="tight")
        assert same(got, jax_solve(a, ch, "tight")), ch


@pytest.mark.parametrize("width", [5, 33, 48, 65, 100, 1100])
def test_fold_rows_any_width_is_xla_row_sum(width):
    """``fold_rows`` equals a jitted ``sum(axis=1)`` at widths that are
    not powers of two: windows of 32 after ``pad // 2`` zeros on the
    left, recursively."""
    import jax
    rng = np.random.default_rng(width)
    x = np.exp(rng.uniform(-35, 35, size=(256, width)))
    x[rng.random(x.shape) < 0.3] = 0.0
    want = np.asarray(jax.jit(lambda t: t.sum(1))(x))
    got = k7.fold_rows(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


# ---------------------------------------------------------------------------
# a chain keeps its buffers per shape


def test_chain_state_kept_per_shape():
    a = arrays()
    lmm_ell._CHAIN_STATES.clear()
    first = lmm_torch.solve_arrays(a, 1e-9, device="cpu", layout="ell",
                                   chain="on")
    (cs,) = lmm_ell._CHAIN_STATES.values()
    ptrs = [b[k].data_ptr() for b in cs.bufs for k in b]
    loops = dict(cs.loops)
    again = lmm_torch.solve_arrays(a, 1e-9, device="cpu", layout="ell",
                                   chain="on")
    assert list(lmm_ell._CHAIN_STATES.values()) == [cs]
    assert [b[k].data_ptr() for b in cs.bufs for k in b] == ptrs
    assert all(cs.loops[k][1] is v[1] for k, v in loops.items())
    assert same(first, again)
    assert cs.stage == 3 and cs.sys.n_v == 512


def test_loop_ended_by_its_body_is_one_call():
    """A loop whose body's kernel ends its iteration (K8's round,
    ``Loop(..., ends=True)``) holds exactly one wrapper call; on the CPU
    it runs as any loop, and no capture is in progress to take its
    end."""
    from simgrid_tpu_torch.kernels import superstep_loop as k16
    ctrl = torch.zeros(k16.N_CTRL, dtype=torch.int32)
    with pytest.raises(ValueError):
        k16.DeviceLoop([k16.Loop(k16.PRED_COUNT, None, (lambda: 0,
                                                        lambda: 0),
                                 cap=2, ends=True)], "chain",
                       torch.device("cpu"))
    runs = []
    k16.DeviceLoop([k16.Loop(k16.PRED_COUNT, ctrl, (lambda: runs.append(
        k16.loop_end_args()),), cap=3, ends=True)], "chain",
        torch.device("cpu")).run()
    assert runs == [None] * 3
