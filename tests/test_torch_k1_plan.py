"""K1's row plan on the CPU: ``lmm_plan_plain``, the plain twin of the
planner kernel in ``csrc/lmm_round.cu``, and its upkeep on a Work.

The plan is a stable partition of the constraint rows by length: the
rows of more than ``long_min`` elements (walked by a block), then those
of more than ``short_max`` (a warp), then the rest (a thread), each class
in increasing row order.  It must be a permutation of the rows, respect
the limits, and be rebuilt for every new row index, as after the plain
K4 repack.  The card's planner is held to this twin in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from simgrid_tpu_torch.kernels import lmm_round as k1
from simgrid_tpu_torch.kernels.common import Work
from simgrid_tpu_torch.kernels.livefirst_repack import \
    livefirst_repack_plain
from simgrid_tpu_torch.ops.lmm_arrays import to2d
from simgrid_tpu_torch.ops.lmm_torch import to_device_system
from simgrid_tpu_torch.workloads import dragonfly


def check_plan(c_ptr, plan, short_max, long_min):
    """A permutation of the rows; long, medium, short in that order,
    each in increasing row order; the limits respected."""
    n = (c_ptr[1:] - c_ptr[:-1]).long()
    C = n.numel()
    order = plan.order.long()
    nl, nm, ns = (int(x) for x in plan.ncls)
    assert plan.order.dtype == plan.ncls.dtype == torch.int32
    assert nl + nm + ns == C == order.numel()
    assert torch.equal(torch.sort(order).values, torch.arange(C))
    parts = (order[:nl], order[nl:nl + nm], order[nl + nm:])
    for part in parts:
        assert bool((part[1:] > part[:-1]).all())
    assert bool((n[parts[0]] > long_min).all())
    assert bool(((n[parts[1]] > short_max) & (n[parts[1]] <= long_min))
                .all())
    assert bool((n[parts[2]] <= short_max).all())


@pytest.mark.parametrize("limits", [(k1.SHORT_ROW, k1.LONG_ROW), (0, 0),
                                    (2, 16), (8, 8)])
@pytest.mark.parametrize("C", [0, 1, 7, 4097])
def test_plan_plain_is_a_stable_partition(C, limits):
    rng = np.random.default_rng(C + 31 * limits[1])
    lens = rng.choice([0, 1, 2, 7, 8, 9, 15, 16, 17, 255, 256, 257, 700], C)
    c_ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)])
                             .astype(np.int32))
    plan = k1.lmm_plan(c_ptr, *limits)
    check_plan(c_ptr, plan, *limits)
    assert torch.equal(plan.order, k1.lmm_plan_plain(c_ptr, *limits).order)


def test_plan_limits_are_checked():
    c_ptr = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        k1.lmm_plan(c_ptr, 16, 8)
    with pytest.raises(ValueError):
        k1.lmm_plan(c_ptr, -1, 8)


def test_plan_rebuilt_after_the_plain_repack(monkeypatch):
    """The plan a Work keeps follows the row index: the plain K4 repack
    of a half-finished 2,000-flow drain system gives a new index, whose
    plan replaces the old one and is the plain plan of the new index."""
    limits = (2, 16)
    monkeypatch.setattr(k1, "SHORT_ROW", limits[0])
    monkeypatch.setattr(k1, "LONG_ROW", limits[1])
    s = dragonfly.build_system(2000)
    flat = [to2d(a).reshape(-1) for a in (s.e_var, s.e_cnst, s.e_w)]
    V = len(s.sizes)
    cpu = torch.device("cpu")
    sys_ = to_device_system(flat[0], flat[1], flat[2], s.c_bound, V,
                            torch.float64, cpu)
    w = Work(V, sys_.n_c, torch.float64, cpu)
    first = k1.plan_of(sys_, w)
    assert k1.plan_of(sys_, w) is first
    check_plan(sys_.csr.c_ptr, first, *limits)
    pen = torch.ones(V, dtype=torch.float64)
    pen[np.random.default_rng(3).choice(V, V // 2 + 100,
                                        replace=False)] = 0.0
    ev = sys_.e_var.long()
    live_e = int(((sys_.e_w > 0) & (pen[ev] > 0)).sum())
    rp = livefirst_repack_plain(sys_, pen, pen, pen, torch.arange(V),
                                V // 2, -(-(sys_.n_e // 2) // 8) * 8,
                                live_e)
    assert rp.sys.n_v == V // 2
    w2 = Work(rp.sys.n_v, rp.sys.n_c, torch.float64, cpu)
    second = k1.plan_of(rp.sys, w2)
    assert w2.k1_plan[0] is rp.sys.csr
    check_plan(rp.sys.csr.c_ptr, second, *limits)
    # the same Work handed the new system replaces its plan
    third = k1.plan_of(rp.sys, w)
    assert w.k1_plan[0] is rp.sys.csr
    assert torch.equal(third.order, second.order)
    assert not torch.equal(first.ncls, second.ncls)
