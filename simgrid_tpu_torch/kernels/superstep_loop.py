"""K16: the superstep's and the fixpoint's while loops on the card.

Replaces the loops of the JAX programs whose bodies the port runs as
K1-K3, K7, K8 and K10: ``simgrid_tpu/ops/lmm_drain.py``
``_superstep_program``'s ``lax.while_loop`` (cond ``:332-342``, loop
``:506``) with the ``fixpoint`` loop inside its body (``:355-359``,
``simgrid_tpu/ops/lmm_jax.py:174-183``), the fleet's vmapped copy
(``simgrid_tpu/ops/lmm_batch.py:477``), the chunked solves' bounded
fixpoint, and the compaction chain's stage and finisher loops
(``lmm_jax.py:760-765``, ``:793-799``).  The CUDA source is
``csrc/superstep_loop.cu``.

A :class:`DeviceLoop` is a list of steps: callables (wrapper calls, in
order) and :class:`Loop` s (``while pred: body``, nested as deep as the
program needs).  On the card it is one CUDA graph, built at the first
:meth:`DeviceLoop.run` by capturing each run of callables on a side
stream into the graph (or a loop's body graph) and adding a conditional
WHILE node for each loop, and then launched once per run.  The
wrappers' launches inside the graph are not counted (capture launches
nothing); each graph launch counts once under ``superstep_loop_<kind>``,
and each loop adds its iterations to a device word of its own, read
back once after a run: with the loop's tally name (:func:`device_tally`:
the device rounds of a path) and the wrapper launches its body captured
per iteration (:func:`graph_launches`: each kernel's launches inside
the graphs).  On CPU tensors the
same steps run as Python ``while`` loops over the plain versions, with
:func:`pred_plain` as the condition: the same conditions as the
kernel's, so the grouping of advances into supersteps and every round
count are the JAX program's on both.

The graph bakes in every pointer and scalar its wrappers were called
with: its owner keeps the buffers alive (``refs``) and builds a new one
when any of them is replaced (:func:`cached`).
"""

from __future__ import annotations

import ctypes
import sys
import weakref
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from . import build
from .common import (ARMED, COUNTERS, HALF, IT, LIGHT, LIMIT, N_CTRL,
                     PENDING, SS_ACTIVE, SS_ADV, SS_BUDGET, SS_FLAG, SS_K,
                     SS_NLIVE, SS_ROUNDS, SS_STOP, FLAG_OK, VLIVE, I, P,
                     check, counter, ptr)

#: the loop conditions (keep in sync with csrc/superstep_loop.cu)
PRED_SUPERSTEP = 0
PRED_ROUND = 1
PRED_VC_ROUND = 2
PRED_COUNT = 3

#: graph launches by kind of loop nest
KINDS = ("superstep", "superstep_fleet", "rescue_fleet", "chunk",
         "chunk_fleet", "chain", "probe")
COUNTS = {k: counter(f"superstep_loop_{k}") for k in KINDS}
#: graphs built on the card since the last reset (first runs, and
#: rebuilds after a replaced buffer); not a launch count
BUILDS = {"graphs": 0}

#: names a loop's iterations count under (:func:`device_tally`): the
#: advance slots of a superstep, and the rounds of each round kernel
TALLIES = ("slots", "lmm_round", "lmm_round_fleet", "ell_round",
           "vc_round", "probe")

_SIG = {
    "loop_versions": [P, P],
    "loop_graph_new": [P],
    "loop_capture_begin": [P, P, P],
    "loop_capture_end": [P, P, P],
    "loop_while": [P, P, I, I, P, P, I, P, P],
    "loop_end": [P, P, I, I, P, P, I, P, ctypes.c_ulonglong],
    "loop_body_nodes": [P, P, P, P],
    "loop_instantiate": [P, P],
    "loop_launch": [P, P],
    "loop_destroy": [P, P],
}

#: dropped graphs whose words are held at most before a build folds
#: them in (one fetch a card for all of them)
MAX_DROPPED = 1024
#: the plain loops' iterations by tally name
_PLAIN_TALLY: Dict[str, int] = {t: 0 for t in TALLIES}
#: the built graphs' words: (the DeviceLoop, weakly; one int32 word per
#: loop, its iterations since the last reset; per loop, its tally name
#: and the wrapper launches its body holds per iteration)
_WORDS: list = []
#: what the words of graphs since dropped had counted (tally names, and
#: wrapper launches), folded in at a read
_FOLDED: Dict[str, Dict[str, int]] = {"tally": {}, "launches": {}}
#: entries of ``_WORDS`` whose graph was dropped since the last fold
_DROPPED = [0]
#: wrapper launches of the graphs' top levels (once per graph launch)
_TOP: Dict[str, int] = {}
#: the round loops' bodies of the graphs built (:func:`bodies`): the
#: graphs that built each distinct body, since the process started and
#: since the last reset
_BODIES: Dict[tuple, int] = {}
_BODIES_RESET: Dict[tuple, int] = {}


def _lib():
    return build.load("superstep_loop", _SIG)


class Loop(NamedTuple):
    """``while pred(ctrl) [and iterations < cap]: body``.  ``ctrl`` is
    a :class:`~.common.Work`'s control words (``[N_CTRL]`` or ``[B,
    N_CTRL]``; None with ``PRED_COUNT``), ``body`` a tuple of steps,
    ``cap`` 0 for no cap, ``cnt`` the loop's count word (an int32 tensor
    of one element; the :class:`DeviceLoop` makes one when a capped loop
    has none), ``tally`` a name of :data:`TALLIES` or None.  ``ends``:
    the body is one wrapper call whose last kernel evaluates the
    condition itself, counts the iteration and sets the WHILE node's
    handle (it takes them from :func:`loop_end_args` while it is
    captured; K1's, K7's and K8's rounds), so the body has no
    ``loop_cond`` node."""
    pred: int
    ctrl: Optional[torch.Tensor]
    body: tuple
    cap: int = 0
    cnt: Optional[torch.Tensor] = None
    tally: Optional[str] = None
    ends: bool = False


class LoopEnd(NamedTuple):
    """What a kernel that ends a loop's body needs (``Loop.ends``): the
    loop's count word and cap (None and 0: no cap), its tally word, the
    WHILE node's conditional handle, and the control words the loop's
    condition reads (the kernel evaluates it over them)."""
    cnt: Optional[int]
    cap: int
    tally: int
    handle: int
    ctrl: Optional[torch.Tensor] = None


#: the loop body being captured whose last kernel sets the condition,
#: and whether a wrapper took it
_ENDING: list = [None, False]


def loop_end_args() -> Optional[LoopEnd]:
    """The :class:`LoopEnd` of the loop whose body is being captured, if
    its last kernel is to end it (``Loop.ends``); None anywhere else.  A
    wrapper that passes it to its kernel calls this once per capture."""
    if _ENDING[0] is not None:
        _ENDING[1] = True
    return _ENDING[0]


def pred_plain(pred: int, ctrl: Optional[torch.Tensor]) -> bool:
    """The condition ``loop_cond`` evaluates, over every replica's
    control words (a superstep's writes each replica's ``SS_ACTIVE``)."""
    if pred == PRED_COUNT:
        return True
    rows = ctrl.reshape(-1, N_CTRL)
    go = False
    for r in range(rows.shape[0]):
        c = [int(x) for x in rows[r].tolist()]
        if pred == PRED_SUPERSTEP:
            on = (c[SS_FLAG] == FLAG_OK and c[SS_ADV] < c[SS_K]
                  and c[SS_ROUNDS] < c[SS_BUDGET]
                  and (c[SS_NLIVE] > c[SS_STOP] or c[PENDING] > 0))
            rows[r, SS_ACTIVE] = int(on)
        else:
            on = c[ARMED] != 0 and c[LIGHT] > 0 and c[IT] < c[LIMIT]
            if pred == PRED_VC_ROUND:
                on = on and c[VLIVE] > c[HALF]
        go = go or on
    return go


def _fetch(entries) -> list:
    """Each entry's words as ints, one fetch a device."""
    out = [None] * len(entries)
    by_dev: Dict[str, list] = {}
    for i, e in enumerate(entries):
        by_dev.setdefault(str(e[1].device), []).append(i)
    for idx in by_dev.values():
        flat = torch.cat([entries[i][1] for i in idx]).tolist()
        at = 0
        for i in idx:
            n = entries[i][1].numel()
            out[i], at = flat[at:at + n], at + n
    return out


def _add(per, counts, tally: Dict[str, int], launches: Dict[str, int]):
    for (name, body), n in zip(per, counts):
        if name is not None:
            tally[name] = tally.get(name, 0) + n
        for k, v in body.items():
            launches[k] = launches.get(k, 0) + v * n


def _fold_dropped() -> None:
    """Fold the words of graphs since dropped into ``_FOLDED`` and let
    them go."""
    alive, dead = [], []
    for e in _WORDS:
        (dead if e[0]() is None else alive).append(e)
    for e, counts in zip(dead, _fetch(dead)):
        _add(e[2], counts, _FOLDED["tally"], _FOLDED["launches"])
    _WORDS[:] = alive
    _DROPPED[0] = 0


def _read() -> Tuple[Dict[str, int], Dict[str, int]]:
    """Iterations by tally name and wrapper launches inside the graphs
    since the last reset (a fetch a card)."""
    _fold_dropped()
    tally, launches = dict(_FOLDED["tally"]), dict(_FOLDED["launches"])
    for e, counts in zip(_WORDS, _fetch(_WORDS)):
        _add(e[2], counts, tally, launches)
    return tally, launches


def _dropped(_ref) -> None:
    _DROPPED[0] += 1


def device_tally() -> Dict[str, int]:
    """Loop iterations by tally name since the last reset, on every
    device (one fetch a card) and on the plain path."""
    out = dict(_PLAIN_TALLY)
    for name, n in _read()[0].items():
        out[name] = out.get(name, 0) + n
    return out


def graph_launches() -> Dict[str, int]:
    """Each wrapper's kernel launches inside K16's graphs since the last
    reset, by the wrapper's counter: each loop's body launches per
    iteration (recorded at capture) times the iterations its word
    counted, and a graph's top level once per graph launch."""
    out = dict(_TOP)
    for name, n in _read()[1].items():
        out[name] = out.get(name, 0) + n
    return out


def bodies(since_reset: bool = True) -> list:
    """The round loops' bodies (``PRED_ROUND``, ``PRED_VC_ROUND``) of
    the graphs built on the card since the last reset (or since the
    process started), one entry per distinct body:
    the nest's kind, the loop's condition and tally, the wrapper
    launches its body captured per iteration (``arms``: for a round
    loop, the round's arm counter), its nodes, kernel nodes and
    ``loop_cond`` nodes as the graph holds them, whether its last kernel
    ends it, and how many graphs built it."""
    return [dict(key, graphs=n) for key, n in
            (_BODIES_RESET if since_reset else _BODIES).items()]


def summary() -> dict:
    """What a path's loops did since the last reset: graph launches by
    kind, graphs built, device iterations by tally, the round wrappers'
    own calls from the host (K1, K7, K8: none where the loops run them)
    and the bodies of the graphs built (:func:`bodies`)."""
    host = {name: c.n for name, c in COUNTERS.items()
            if name.startswith(("lmm_round", "ell_round", "vc_round"))
            and c.n}
    return dict(graph_launches={k: c.n for k, c in COUNTS.items() if c.n},
                graph_builds=BUILDS["graphs"],
                device_tally={k: v for k, v in device_tally().items() if v},
                host_round_calls=host, bodies=bodies())


def kernel_nodes(fn: Callable[[], object]) -> int:
    """The CUDA kernels one ``fn()`` launches, counted as the kernel
    nodes of the graph that capturing the call builds
    (``torch.cuda.graph``).  The graph is dropped unlaunched, so the
    card runs nothing; copies and fills are nodes of other types.  The
    wrappers' host counters do count the captured call.  Run ``fn``
    for real at the same shapes first: a wrapper that sizes its scratch
    on first use (K4) would otherwise capture that fill, never run it,
    and count it."""
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    n, k, c = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    check(_lib().loop_body_nodes(ctypes.c_void_p(g.raw_cuda_graph()),
                                 ctypes.byref(n), ctypes.byref(k),
                                 ctypes.byref(c)), "loop_body_nodes")
    g.reset()
    return k.value


def reset_tally() -> None:
    _WORDS[:] = [e for e in _WORDS if e[0]() is not None]
    _DROPPED[0] = 0
    for _, words, _ in _WORDS:
        words.zero_()
    for d in _FOLDED.values():
        d.clear()
    for name in _PLAIN_TALLY:
        _PLAIN_TALLY[name] = 0
    _TOP.clear()
    _BODIES_RESET.clear()
    BUILDS["graphs"] = 0


def versions() -> Tuple[int, int]:
    """The CUDA runtime's and driver's versions (1000 * major + 10 *
    minor), as the loop's library sees them."""
    rt, drv = ctypes.c_int(0), ctypes.c_int(0)
    check(_lib().loop_versions(ctypes.byref(rt), ctypes.byref(drv)),
          "loop_versions")
    return int(rt.value), int(drv.value)


def _ctrl_b(ctrl: Optional[torch.Tensor]) -> int:
    return 0 if ctrl is None else int(ctrl.numel() // N_CTRL)


class DeviceLoop:
    """The steps as one CUDA graph (built at the first run on the card)
    or as Python loops over the plain versions (on the CPU).  ``kind``
    names the launch counter; ``refs`` are kept alive with the graph;
    ``prepare`` runs before the capture (whatever a wrapper would
    allocate at its first launch, such as K1's row plan)."""

    def __init__(self, steps: Sequence, kind: str, device: torch.device,
                 refs: tuple = (), prepare: Optional[Callable] = None):
        self._graph = ctypes.c_void_p(None)
        self._exec = ctypes.c_void_p(None)
        self._top: Dict[str, int] = {}
        #: per loop, in the order of its word: (tally name, the wrapper
        #: launches its body captured per iteration)
        self._per: list = []
        if kind not in COUNTS:
            raise ValueError(f"loop kind {kind!r} not in {KINDS}")
        self.kind = kind
        self.device = device
        self.refs = refs
        self.prepare = prepare
        self._n_loops = 0
        self.steps = tuple(self._with_counts(steps))
        self._words = (None if device.type == "cpu" else torch.zeros(
            self._n_loops, dtype=torch.int32, device=device))

    def _with_counts(self, steps):
        for st in steps:
            if isinstance(st, Loop):
                if st.tally is not None and st.tally not in TALLIES:
                    raise ValueError(f"tally {st.tally!r} not in {TALLIES}")
                self._n_loops += 1
                if st.ends and (len(st.body) != 1
                                or isinstance(st.body[0], Loop)):
                    raise ValueError("a loop its body ends is one call")
                cnt = st.cnt
                if st.cap and cnt is None:
                    cnt = torch.zeros(1, dtype=torch.int32,
                                      device=self.device)
                st = st._replace(body=tuple(self._with_counts(st.body)),
                                 cnt=cnt)
            yield st

    # -- the plain loops -----------------------------------------------

    def _run_plain(self, steps) -> None:
        for st in steps:
            if not isinstance(st, Loop):
                st()
                continue
            n = 0
            while pred_plain(st.pred, st.ctrl) and (not st.cap
                                                    or n < st.cap):
                self._run_plain(st.body)
                n += 1
                if st.tally is not None:
                    _PLAIN_TALLY[st.tally] += 1

    # -- the graph ---------------------------------------------------------

    def _emit(self, lib, graph, steps, side):
        """Append the steps to ``graph``; returns its last node and the
        wrapper launches its own steps captured (nested loops apart)."""
        prev = ctypes.c_void_p(None)
        run = []
        sp = ctypes.c_void_p(side.cuda_stream)
        launches: Dict[str, int] = {}

        def flush():
            if not run:
                return
            before = {name: c.n for name, c in COUNTERS.items()}
            with torch.cuda.stream(side):
                check(lib.loop_capture_begin(sp, graph, prev),
                      "loop_capture_begin")
                try:
                    for f in run:
                        f()
                finally:
                    rc = lib.loop_capture_end(sp, graph, ctypes.byref(prev))
            check(rc, "loop_capture_end")
            for name, c in COUNTERS.items():
                d = c.n - before.get(name, 0)
                if d:
                    launches[name] = launches.get(name, 0) + d
            run.clear()

        for st in steps:
            if not isinstance(st, Loop):
                run.append(st)
                continue
            flush()
            body = ctypes.c_void_p(None)
            handle = ctypes.c_ulonglong(0)
            ctrl = None if st.ctrl is None else ptr(st.ctrl)
            cnt = None if not st.cap else ptr(st.cnt)
            args = (st.pred, _ctrl_b(st.ctrl), ctrl, cnt, int(st.cap))
            check(lib.loop_while(graph, ctypes.byref(prev), *args,
                                 ctypes.byref(body), ctypes.byref(handle)),
                  "loop_while")
            at = len(self._per)
            self._per.append(None)
            word = ctypes.c_void_p(self._words.data_ptr() + 4 * at)
            if st.ends:
                _ENDING[:] = [LoopEnd(cnt.value if cnt else None,
                                      int(st.cap), word.value,
                                      handle.value, st.ctrl), False]
            try:
                last, inner = self._emit(lib, body, st.body, side)
                ended = _ENDING[1]
            finally:
                _ENDING[:] = [None, False]
            self._per[at] = (st.tally, inner)
            if not ended:
                check(lib.loop_end(body, last, *args, word, handle),
                      "loop_end")
            if st.pred in (PRED_ROUND, PRED_VC_ROUND):
                self._record_body(lib, body, st, inner, ended)
        flush()
        return prev, launches

    def _record_body(self, lib, body, st: Loop, inner: Dict[str, int],
                     ended: bool) -> None:
        """Count the nodes of a finished round loop's body into
        :func:`bodies` (a body of kernel nodes only: the runtime does
        not read every node of a body that holds a conditional node)."""
        n, k, c = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
        check(lib.loop_body_nodes(body, ctypes.byref(n), ctypes.byref(k),
                                  ctypes.byref(c)), "loop_body_nodes")
        key = (("kind", self.kind), ("pred", st.pred), ("tally", st.tally),
               ("arms", ",".join(sorted(inner))), ("nodes", n.value),
               ("kernel_nodes", k.value), ("cond_nodes", c.value),
               ("ends", ended))
        for d in (_BODIES, _BODIES_RESET):
            d[key] = d.get(key, 0) + 1

    def _build(self) -> None:
        lib = _lib()
        if self.prepare is not None:
            self.prepare()
        self._per = []
        saved = {name: c.n for name, c in COUNTERS.items()}
        graph = ctypes.c_void_p(None)
        check(lib.loop_graph_new(ctypes.byref(graph)), "loop_graph_new")
        self._graph = graph
        try:
            _, self._top = self._emit(lib, graph, self.steps,
                                      torch.cuda.Stream(device=self.device))
        finally:
            # captured calls launch nothing: they count nothing
            for name, c in COUNTERS.items():
                c.n = saved.get(name, 0)
        exe = ctypes.c_void_p(None)
        check(lib.loop_instantiate(graph, ctypes.byref(exe)),
              "loop_instantiate")
        self._exec = exe
        BUILDS["graphs"] += 1
        if _DROPPED[0] >= MAX_DROPPED:
            _fold_dropped()
        _WORDS.append((weakref.ref(self, _dropped), self._words, self._per))

    def run(self) -> None:
        """Run the steps once: one graph launch on the card."""
        if self.device.type == "cpu":
            self._run_plain(self.steps)
            return
        if not self._exec.value:
            self._build()
        rc = _lib().loop_launch(self._exec, ctypes.c_void_p(
            torch.cuda.current_stream(self.device).cuda_stream))
        check(rc, f"superstep_loop ({self.kind})")
        COUNTS[self.kind].n += 1
        for name, n in self._top.items():
            _TOP[name] = _TOP.get(name, 0) + n

    def __del__(self):
        if sys.is_finalizing() or not (self._graph.value or self._exec.value):
            return
        try:
            _lib().loop_destroy(self._graph, self._exec)
        except Exception:
            pass


def _same(a, b) -> bool:
    if isinstance(a, (bool, int, float, str)) or a is None:
        return type(a) is type(b) and a == b
    return a is b


def cached(owner: dict, name: str, refs: tuple,
           make: Callable[[], DeviceLoop]) -> DeviceLoop:
    """The loop ``name`` kept in ``owner``, built by ``make`` when there
    is none yet or when any of ``refs`` (the buffers and flags its graph
    bakes in) is no longer the one it was built on."""
    hit = owner.get(name)
    if hit is not None and len(hit[0]) == len(refs) and all(
            _same(a, b) for a, b in zip(hit[0], refs)):
        return hit[1]
    loop = make()
    owner[name] = (refs, loop)
    return loop
