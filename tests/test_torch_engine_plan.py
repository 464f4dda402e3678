"""The engine plan's calls on the port's drain executor against the JAX
package's, on the CPU: ``apply_transitions``, ``partial_advance`` and
``solve_rates`` on the same state, then the drain to its end, in every
executor shape (superstep, fused, unfused).  The fixture and the helpers
are ``tests/test_torch_drain.py``'s; the test lives in a file of its own
because its superstep case is the longest single case of the tier-1 run,
and ``--dist loadfile`` gives each file one worker.
"""

import numpy as np
import pytest

from simgrid_tpu.ops.lmm_drain import DrainSim as JaxDrainSim
from simgrid_tpu_torch.ops.lmm_drain import DrainSim
from test_torch_drain import (K, assert_same_drain, drive_plan,  # noqa: F401
                              fat_tree, plan)


@pytest.mark.parametrize("shape", [dict(superstep=K), dict(fused=True),
                                   {}], ids=["superstep", "fused",
                                             "unfused"])
def test_engine_plan_calls_equal_jax(fat_tree, shape):
    """apply_transitions (bound, c_bound, wake, appended flow),
    partial_advance and solve_rates on the same state as JAX: the rates
    at every step, the partial advance and the whole drain equal."""
    arrays, sizes = fat_tree
    j = plan(JaxDrainSim, arrays, sizes, shape)
    t = plan(DrainSim, arrays, sizes, shape, device="cpu")
    jr = drive_plan(j, arrays)
    tr = drive_plan(t, arrays)
    assert tr[0] == jr[0] == 5 + 1 + 3 + 11 + 6 + 2
    for a, b in zip(tr[1:4], jr[1:4]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tr[4], jr[4])
    assert tr[5] == jr[5]
    assert_same_drain(j, t)
    # every flow of the fixture and the appended one completed once
    assert sorted(f for _, f in t.events) == list(range(arrays.n_var + 1))
