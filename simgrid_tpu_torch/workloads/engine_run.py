"""Engine-driven runs: the flows posted through ``s4u.Engine`` and its
network model, then ``surf_solve`` and ``extract_done_action`` in a loop,
as the JAX package's engine tests and ``bench.py`` ``stage_phase`` drive
it (actors are not ported yet: the loop here is the maestro).

* ``write_platform`` writes the two platforms of these runs: the
  65,536-host dragonfly of config #4 (``tools/scale_proof.py:29-37``)
  and the 64-host fat tree of the drain and NAS tests
  (``tests/test_drain_superstep.py:36-50``, ``bench.py:902-910``);
* ``make_engine`` builds an engine from ``--cfg`` lines and loads a
  platform (``device=`` as ``s4u.Engine``'s);
* ``post_flows`` posts one flow a (src, dst) pair of indices into the
  name-sorted host list; ``drain`` runs the engine until no flow is
  left, with the time of the latency phase (to the first advance after
  which no flow pays latency) and of the drain apart, and a hook called
  after every advance outside the timed spans;
* ``run_alternation`` is ``stage_phase``'s NAS compute/comm alternation
  (every completion posts the rank's next exec or comm);
* ``fastpath_counts`` reads the drain fast path's counters.

Every function takes the engine it drives, so a test can hand the JAX
package's engine to the same loop.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

#: the config-#4 dragonfly (tools/scale_proof.py:29-37)
DRAGONFLY_XML = """<?xml version='1.0'?>
<platform version="4.1">
  <zone id="world" routing="Full">
    <cluster id="dfly" prefix="node-" radical="0-{last}" suffix=""
             speed="1Gf" bw="125MBps" lat="50us" topology="DRAGONFLY"
             topo_parameters="{topology}"/>
  </zone>
</platform>
"""
DRAGONFLY_TOPOLOGY = "16,3;4,2;16,2;64"

#: the 64-host fat tree (tests/test_drain_superstep.py:36-50)
FAT_TREE_64_XML = """<?xml version='1.0'?>
<platform version="4.1">
  <zone id="world" routing="Full">
    <cluster id="ft" prefix="node-" radical="0-63" suffix=""
             speed="1Gf" bw="125MBps" lat="50us" topology="FAT_TREE"
             topo_parameters="2;8,8;1,2;1,1"/>
  </zone>
</platform>
"""

#: the flags of config #4 through the engine: FULL-mode network, no
#: selective update, the device solve (the drain flags at their defaults)
ENGINE_CFG = ("network/optim:Full", "network/maxmin-selective-update:no",
              "lmm/backend:torch")

#: the drain fast path's counters, as the JAX tests read them
FASTPATH_COUNTERS = ("plans", "advances_served", "speculations",
                     "spec_commits", "spec_discards", "rollbacks",
                     "transitions_absorbed", "partial_advances")


def dragonfly_hosts(topology: str = DRAGONFLY_TOPOLOGY) -> int:
    groups, chassis, blades, nodes = (int(p.split(",")[0])
                                      for p in topology.split(";"))
    return groups * chassis * blades * nodes


def write_platform(path: str, kind: str = "dragonfly",
                   topology: str = DRAGONFLY_TOPOLOGY) -> str:
    """Write the ``dragonfly`` (``topology``'s host count) or the
    ``fat_tree`` platform to ``path``; returns ``path``."""
    if kind == "dragonfly":
        xml = DRAGONFLY_XML.format(last=dragonfly_hosts(topology) - 1,
                                   topology=topology)
    elif kind == "fat_tree":
        xml = FAT_TREE_64_XML
    else:
        raise ValueError(f"unknown platform {kind!r}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(xml)
    return path


def make_engine(s4u, cfg, platform: str, **kw):
    """``s4u.Engine`` (the port's or the JAX package's module) with
    ``--cfg=`` lines ``cfg``, the platform loaded; ``kw`` passes on to
    the constructor (the port's ``device=``).  Returns ``(engine, parse
    seconds)``."""
    s4u.Engine._reset()
    e = s4u.Engine(["engine-run"] + [f"--cfg={c}" for c in cfg], **kw)
    t0 = time.perf_counter()
    e.load_platform(platform)
    return e, time.perf_counter() - t0


def post_flows(e, pairs: np.ndarray, sizes) -> List:
    """One ``communicate`` a row of ``pairs`` (indices into the
    name-sorted host list, ``src == dst`` moved to the next host as
    ``tools/e2e_drain.py:80-87`` does), ``sizes`` a float or one a flow;
    each action carries its row as ``drain_idx``."""
    hosts = e.get_all_hosts()
    n_hosts = len(hosts)
    model = e.pimpl.network_model
    sizes = np.broadcast_to(np.asarray(sizes, np.float64), (len(pairs),))
    actions = []
    for k in range(len(pairs)):
        src, dst = int(pairs[k, 0]), int(pairs[k, 1])
        if src == dst:
            dst = (dst + 1) % n_hosts
        a = model.communicate(hosts[src], hosts[dst], float(sizes[k]), -1.0)
        a.drain_idx = k
        actions.append(a)
    return actions


def drain(e, hook: Optional[Callable] = None, bound_step: float = 0.0,
          max_iter: int = 10_000_000) -> Dict:
    """Run the engine until its network model has no started flow,
    reaping completions as the kernel's activity layer does
    (``tests/test_drain_superstep.py:339``): ``(finish_time,
    drain_idx)`` events.  ``bound_step`` > 0 bounds each advance at
    ``now + bound_step`` (run-until-style partial advances).
    ``hook(e)`` runs after every advance, outside the timed spans.
    Returns events, the advances, the seconds of the latency phase (to
    the first advance after which no flow pays latency) and of the
    drain after it, and the hook's seconds."""
    model = e.pimpl.network_model
    events: List[Tuple[float, int]] = []

    def reap():
        while True:
            done = model.extract_done_action()
            if done is None:
                return
            events.append((done.finish_time, done.drain_idx))
            done.unref()

    lat_s = hook_s = 0.0
    lat_done = False
    advances = 0
    t0 = time.perf_counter()
    for _ in range(max_iter):
        reap()
        if not len(model.started_action_set):
            break
        max_date = e.pimpl.now + bound_step if bound_step else -1.0
        if e.pimpl.surf_solve(max_date) < 0 and not bound_step:
            break
        advances += 1
        if not lat_done and not model.latency_phase_count:
            lat_done = True
            lat_s = time.perf_counter() - t0 - hook_s
        if hook is not None:
            t1 = time.perf_counter()
            hook(e)
            hook_s += time.perf_counter() - t1
    reap()
    total = time.perf_counter() - t0 - hook_s
    return dict(events=events, advances=advances, latency_s=lat_s,
                drain_s=total - lat_s, hook_s=hook_s, clock=e.pimpl.now)


def run_alternation(e, ranks: int = 64, rounds: int = 4, seed: int = 7
                    ) -> Tuple[List, float, float]:
    """``bench.py:913`` ``stage_phase``'s NAS alternation on the loaded
    engine ``e``: each of the first ``ranks`` hosts chains comm -> exec
    -> comm ... for ``rounds`` rounds, every completion posting the
    rank's successor.  Returns the tagged completion stream
    ``[(finish_time, (rank, stage))]``, the final clock and the wall
    seconds of the loop."""
    hosts = e.get_all_hosts()[:ranks]
    model = e.pimpl.network_model
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, ranks, size=(ranks, rounds))
    sizes = rng.choice(np.linspace(2e5, 2e6, 12), (ranks, rounds))
    flops = rng.choice(np.linspace(5e5, 5e6, 8), (ranks, rounds))
    stage = [0] * ranks
    tag_of = {}
    events = []

    def post_next(r):
        st = stage[r]
        j = st // 2
        if j >= rounds:
            return
        if st % 2 == 0:
            d = int(dst[r, j])
            if d == r:
                d = (d + 1) % ranks
            a = model.communicate(hosts[r], hosts[d], float(sizes[r, j]),
                                  -1.0)
        else:
            a = hosts[r].cpu.execution_start(float(flops[r, j]))
        tag_of[id(a)] = (r, st)
        stage[r] = st + 1

    for r in range(ranks):
        post_next(r)
    t0 = time.perf_counter()
    for _ in range(200_000):
        if not any(len(m.started_action_set) for m in e.pimpl.models):
            break
        e.pimpl.surf_solve(-1.0)
        for m in list(e.pimpl.models):
            while True:
                done = m.extract_done_action()
                if done is None:
                    break
                t = tag_of.pop(id(done), None)
                if t is not None:
                    events.append((done.finish_time, t))
                    post_next(t[0])
                done.unref()
    return events, e.pimpl.now, time.perf_counter() - t0


def fastpath_counts(model) -> Dict[str, int]:
    """The drain fast path's counters of a network model."""
    fp = model.drain_fastpath
    return {k: int(getattr(fp, k)) for k in FASTPATH_COUNTERS}
