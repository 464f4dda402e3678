#!/usr/bin/env python3
"""Smoke run of simgrid_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one JSON line of its results):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the time to build the kernels from ``csrc/``;
2. kernels: each of K1-K4 on the card at the shapes of the config-#4
   drain (100,000 flows on the 65,536-host dragonfly, float64), held
   against its plain PyTorch version on the same inputs (run on the
   host CPU, so every sum is in element order; the tolerance is 0:
   results must be bit-identical), with its mean time from CUDA events,
   the plain version's time on the card, and the least time the card
   could take (bytes over 3.35 TB/s).  K1's rows (here, in phases 5-6
   and 17), K2's and K3's rows here, K3's tape and replica arms, K10's
   replica arm and K11's admissions are timed twice: ``ms``, the card's
   own time, the calls queued behind ``torch.cuda._sleep``
   (``probes/timing.py`` ``time_rounds``/``time_call``), and
   ``paced_ms``, CUDA events around the host's calls as before.  K1's
   row plan (``lmm_plan``, built at
   system build and after every repack) is held against its plain
   version by bits on this system (main path 1's shape) and timed; the
   plan each K1 row ran on (here, phases 5 and 16: the alltoall's index
   and main path 10's) is held the same way, and the row logs its
   classes (rows a block, a warp and a thread walk).  Main paths 1, 10
   and 11 must launch the plan;
3. main path: the full config-#4 drain, superstep=16, float64, through
   the kernels, with every kernel's launch count from that run: each
   superstep is one launch of K16's graph (``kernels/superstep_loop.py``:
   conditional WHILE nodes over the advance slots and K1's rounds), and
   the card's time of each is read from CUDA events around the launch.
   K16's row: the first superstep of 4 advances from the drain's start
   as one graph launch on the card against the plain loops on the host
   CPU (by bits: the packed result, events, clock, rounds), its card
   time, the plain loops' time on the card, and as its bound the sum of
   its bodies' bounds (K1's over its rounds, K2's and K3's over its
   advances).  At the end of the run the same row gets K1's kernel
   nodes a round by arm over every round loop K16 built
   (``k1_round_bodies``): a round's last kernel ends its loop's
   iteration, so no round body may hold a ``loop_cond`` node;
4. reduced drain: 10,000 flows of the same generator through the
   kernels on the card and through the plain path on the host CPU;
   events and clock must be equal.

Then BASELINE config #4 as named: the 320-rank alltoall (102,080 flows
of 1e6 bytes) on the same dragonfly, each flow with the LV08 penalty and
TCP-gamma rate bound the engine gives it, float64, tolerance 0:

5. K1's bound-first arm at the alltoall's full shapes, from init to the
   first converged solve, card against the plain version on the host
   CPU: (a) the LV08 system (no bound binds), (b) its bounds redrawn
   as (a)'s rates times U(0.5, 1.5) (``default_rng(11)``; about half
   bind), (c) (a) with a seeded 10% of its links FATPIPE; ms per round
   (CUDA events), the plain version's ms per round on the card, and
   the bytes bound.  (a) and (c) take some 300 rounds, and the plain
   version runs each whole solve beside the card.  (b) takes tens of
   thousands of rounds (the rule fixes about one bound per constraint a
   round), beyond the CPU's reach at this size: the plain version runs
   windows of ``B_WINDOW`` rounds, from init, then every ``B_EVERY``
   rounds and at the end from the card's state (its whole solve is held
   at 48 ranks in phase 6);
6. the global arm (one level per round) at 48 ranks with bounds binding
   as in 5(b): ``solve_arrays(parallel_rounds=False)`` on the card
   against the plain path on the CPU, and 5(b)'s local arm and 5(c)'s
   FATPIPE arm at that size through the whole solve;
7. main path 2, the solve: ``drain_run.run_solve`` of the alltoall
   (local rounds, eps 1e-5), its time, rounds and launch counts;
8. main path 3, the engine-plan drain: ``drain_run.run_engine_plan`` of
   the alltoall (1% latency lanes, one superstep, a transition batch,
   a partial advance, then ``PLAN_ADVANCES`` advances: a cut of depth,
   as the whole drain is ~50,000 advances), and one more advance from
   the state it left on the card and, handed over, on the CPU; then the
   same plan at full width to its end on config #4's 100,000 random
   flows with their LV08 values (its live set halves, so the drain
   repacks with the bound rows), timed, then again with windows held
   against the CPU (``run_engine_plan_held``: after the partial advance
   and after each repack); then the alltoall plan at ``PLAN_RANKS``
   ranks, run to its end with ``repack_min=64`` (it repacks twice), on
   the card and on the CPU (events,
   clock, penalties and remains equal); then K2's forced mode, K5 and
   K4 with the bound rows against their plain versions at the
   alltoall's shapes.

Then the System API, float64, ``strict=True`` (a failed device solve
raises; no solve may fall back to the host):

9. main path 4, the 100,000-variable churn of ``bench.py``'s churn
   stage (``workloads/churn.py``, seed 42) in all four modes on the
   card, with the fields ``bench.py`` reports; every step of
   ``warm-selective`` is held against the plain path on the CPU, and
   every step of ``cold-full`` and ``cold-delta`` against
   ``warm-selective`` on the card (warm equals cold), bit for bit; the
   counts must be the recorded ones (``bench_results/lmm_churn.jsonl``);
   then K5's delta use (seven masters, a bool target among them) and
   K6 against their plain versions at this path's shapes;
10. main path 5, the Lazy-mode 320-rank alltoall
   (``workloads/lazy_alltoall.py``): the System built through
   ``communicate``'s calls (its wall time apart), the first solve, one
   solve per latency-end date, a 1% retirement and a 1% bandwidth
   change; after the last latency-end solve the host state must equal a
   cold ``solve_arrays`` of the same arrays on the card, bit for bit;
   then the whole sequence at 48 ranks on the card and on the CPU,
   equal.

Then the ELL layout, the JAX package's default solve on an accelerator
(float64, tolerance 0):

11. main path 6, ``bench.py``'s headline solve (16,384 constraints,
   100,000 flows of degree 4, seed 42, eps 1e-9, local rounds;
   ``workloads/bench_solve.py``): (a) the card's default path, the
   compaction chain (K8 rounds in K16's stage and finisher graphs,
   none from the host; K9's partitions and fetches), a first solve
   and the median of 3, held against the plain chain on the CPU with the same rounds and stages; (b) the chain off:
   K7's init and K8's rounds, held against the plain dense path; (c) a
   stage cap of 1: the chain overflows and the dense path re-solves,
   equal to (b); then K7's init and prep, K8 and K9 held against their
   plain versions at the headline's shapes with their ms, and K7's round
   arms (the bound-first rule, FATPIPE, the global order) held whole at
   the same widths (2,048 x 12,500, Wc 64, Wv 4; the global order on
   bench.py's 2,000 x 2,000 class), timed at full width as host-queued
   rounds and inside K16's loop, with the kernel nodes of each round
   body read from the solve's graph (none may be a ``loop_cond``
   node);
12. main path 7, the 100k churn of phase 9 under the default layout
   (ELL): all four modes, every step of warm-selective and of
   legacy-subset held against the plain path on the CPU (``layout``
   ``ell``, ``chain`` on: the card's default), cold against warm, ELL
   throughout with no ``warm_ell_fallbacks``; then K6's ELL arm and
   K5's ELL deltas against their plain versions at this path's shapes.

Then the superstep's event arms (float64, tolerance 0):

13. main path 8, the config-#4 drain of phase 3 under a fault tape
   (``workloads/fault_drain.py``): a ``FaultCampaign`` (seed 42, horizon
   2 s) over every used link in slot order, exponential MTBF 100 s and
   MTTR 0.1 s, failures clamped to 5% of the link's bound, run to its
   end through K2's event arm and K3's tape arm (K4's time per repack
   taken inside the run); it fails unless more than ``MIN_FIRES``
   entries fire.  (a) The same drain under the tape shifted past its
   end: the arm peeks on every advance, never fires, and the events and
   clock must equal phase 3's bit for bit.  (b) The 10,000 flows of
   phase 4 under their own campaign at the same rates, on the card and
   through the plain path on the host CPU: events, fault events and
   clock equal;
14. main path 9, ``bench.py``'s collective stage as recorded
   (``workloads/collective_run.py``, superstep 8): the ring allreduce
   at 64 ranks and recursive doubling at 256 and 1,024, each as a tape
   drain (K2's event arm, K3's collective arm, K10) and through the
   host maestro (K1, K2's forced mode, K5), both on the card: equal
   completions, activations and Kahan pair, the recorded counts
   (flows, edges, activations, dispatches of each leg), and at 64 and
   256 ranks the tape drain equal to the plain path on the CPU;
15. both arms at once: the 1,024-rank case with rank 0's uplink down to
   2% of its bandwidth at 0.7x the middle completion date and restored
   at 1.3x: the tape drain equals the maestro under the same tape, a
   fault fires and the events move;
   then K2's event arm and K3's tape arm at phase 13's shapes, K3's
   collective arm and K10 at the 1,024-rank case's, each against its
   plain version, with its ms, the plain ms and the library call's
   (``index_put_`` for the bound scatter, ``index_add_`` on int32 for
   K10's decrements).

Then scenario fleets (float64, tolerance 0): one launch of K1-K3 serves
every replica (their replica arms) and K11 materialises each replica's
state on the card:

16. main path 10, a fleet of ``FLEET_B`` replicas over phase 3's system
   through the port's ``Campaign`` (superstep ``FLEET_K``): four sweep
   replicas (bandwidth 1.0-1.3, sizes 1.0/1.05, one with 11 dead flows,
   one with 64 element weights overridden, so the weights are per
   replica) and four under phase 13's campaign at seeds 42-45; after
   ``ADMIT_AT`` supersteps replica 1 is retired and a fresh spec
   admitted into its row.  (a) Replicas 0 and 4 equal their solo
   ``DrainSim`` on the card (``ScenarioPlan.solo``) by bits, events,
   fault events and clock; (d) so does the admitted replica; (b) a
   reduced fleet (``REDUCED_FLOWS``, two sweep and two faulted
   replicas) on the card equals the plain fleet on the host CPU;
   (c) the host's launches of each of the first 4 supersteps are the
   same at B = 1 and B = ``FLEET_B``, one of them K16's graph;
17. ``bench.py``'s sweep and fault stages (``workloads/fleet_run.py``)
   on the card, whose counts must be those the JAX package gives on the
   CPU (``fleet_run.JAX_COUNTS``); then K11 (birth: state and weights,
   at most ``K11_BIRTH_MAX_LAUNCHES`` CUDA launches a call; admission:
   state, tape and weight rows, exactly ``K11_ADMIT_LAUNCHES``) and
   the replica arms of K1 (init and local round, at phase 16's shapes;
   the bound-first, FATPIPE and global arms through whole
   ``solve_arrays_batch`` solves), K2's event arm and K3's tape arm at
   B = ``FLEET_B``, each against its plain version.

Then collective fleets (float64, tolerance 0): one compiled collective
swept over bandwidth, link and fault scenarios, every replica walking
the shared schedule with its own DAG state:

18. main path 11, ``Campaign.for_collective`` over phase 14's 1,024-rank
   recursive doubling (``workloads/collective_fleet.py``, superstep 8)
   at B = ``COLL_B``: half the replicas sweep ``bw_scale`` (the plain
   scenario first, then 0.5-2.0), a quarter scale rank 0's uplink by
   0.25-1.0, a quarter carry fault campaigns (seeds 42, 43, ..., MTBF
   20 t_end, MTTR 0.1 t_end, horizon t_end, t_end phase 14's completion
   date); after ``COLL_ADMIT_AT`` supersteps replica 1 is retired and a
   fresh spec admitted into its row.  (a) Replicas 0, 2, 16, 24 and the
   admitted one equal their solo ``DrainSim(collective=)`` on the card
   by bits (completions, activations, fault events, clock), replica 0
   also phase 14's tape drain (its Kahan pair too), and every faulted
   replica fires before its last completion; (b) fleets of
   ``COLL_B_SMALL`` over the 64-rank ring and the 256-rank recursive
   doubling (the same mix), and the 64-rank fleet at ``COLL_B_CPU`` on
   the card against the plain fleet on the host CPU; (c) the host's
   launches of each of the first 3 supersteps at B = 1 (the plain
   replica) and B = ``COLL_B``, equal, one of them K16's graph; (d) K2's
   event arm and K3's collective arm on the fleet's dates, K10's replica arm and K11's
   collective admission (state, tape and DAG-walk rows in exactly
   ``K11_ADMIT_LAUNCHES`` launch) at (a)'s shapes, each against its
   plain version (K10 beside ``index_add_`` on int32, K11 beside
   ``index_put_`` of a row).

19. the op-cost probe (on no main path; ``simgrid_tpu_torch/probes/``):
   ``run_opcost`` (P1-P8 of the TPU tools and ``tools/tpu_opcost.py``'s
   table at their full shapes, float32 and float64: every kernel arm
   checked against the tools' numpy want, timed beside its library
   call) and ``run_scaling`` (per-element against per-op cost), with
   the launch counts zeroed before and read after (every arm of K12-K15
   and ``probe_double`` must launch); then every arm on the card
   against its plain version on the host CPU at P1's, P2's, P3's and
   P6's shapes (by bits: the gathers, the in-order segment sum, the
   sequential scan, the minima and the four loop arms; the atomic
   segment sums and the block scan within the reordered-sum bound
   ``2 m u |want|``), and the kernel rows K12-K15, K15's cond arm (a
   CUDA-graph conditional WHILE node, K16's mechanism) in a row of its
   own; the phase's line records the CUDA runtime, driver and nvcc
   versions.

20. the pipelined drains (``pipeline=D``, the speculative issue/collect
   split of ``ops/lmm_drain.py`` and ``ops/lmm_batch.py``): main paths
   1 and 11 at depths 0, ``PIPE_DEPTH``, ``PIPE_DEPTH``, 0, main path
   8 at 0 and ``PIPE_DEPTH`` and main path 10 at 0 (path 10 on phase
   16's campaign, whose tapes are built, without its admission; path 11
   on phase 18's), every depth equal to depth 0 by bits (events, fault and
   collective events, clocks, Kahan pairs), each run with its kernels'
   path counts zeroed before and read after; per run its wall, the
   card's busy share (``timed_graphs``: CUDA events around each launch
   of a superstep graph, after its build, over the run after the build;
   the reset, the uploads, ``superstep_finish``, the copies into a
   speculative set and the fused rescue lie outside, and where the
   stream is idle at a launch a span also holds the launch's host
   latency), blocking fetches
   per advance, the speculation census and commit rate, and the graphs
   built (at depth D at most depth 0's plus D + 1 per buffer set
   rebuild: the first use and each repack).  One more run of path 8 at
   ``PIPE_DEPTH`` holds the base clock each speculative superstep
   derived on the card against the host's clock after the collect of
   the superstep before it, by bits (not timed: the check syncs).  Then
   ``bench.py``'s pipeline stage (``workloads/pipeline.py``: the solo
   wave with 500 us of host work an advance, the fleet wave at B = 64)
   at depths 0-2 on the card, its counts held against the recorded rows
   of ``bench_results/lmm_pipeline.jsonl``.

Then the engine (``s4u.Engine`` on the card: ``platform/``, ``routing/``,
``models/``, ``kernel/engine.py`` ``surf_solve`` and the drain fast path
``ops/drain_path.py``; float64, tolerance 0):

21. main path 12, config #4 through the engine: the 65,536-host
   dragonfly of ``tools/scale_proof.py:29-37`` written by this script
   and parsed, the 100,000 random flows of ``tools/e2e_drain.py:80-87``
   posted with ``communicate`` (LV08, ``network/optim:Full``, no
   selective update, ``lmm/backend:torch``, the drain flags at their
   defaults), every flow's elements (link names, weights, constraint
   bounds), latency-end penalty and rate bound equal to
   ``workloads/dragonfly.build_system(lv08=True)``'s by bits, then
   ``surf_solve`` and ``extract_done_action`` to the end: every flow
   completes once at non-decreasing times, the clock is the last
   event's, every live flow's penalty after the latency phase is the
   one posted, the fast path serves advances after the latency phase,
   K16's supersteps, K1's bound-first arm and K5 launch; the parse,
   posting, latency-phase and drain times, the fast path's counters,
   the launches and the card's busy share around the superstep graphs
   (``timed_graphs``); two of its supersteps (the first after the
   latency phase and the first under ``HELD_LATE_SHARE`` of the flows)
   held against the plain path on the CPU from the card's state
   (``drain_run.held_handover``/``held_from``); then the first
   ``ENGINE_REDUCED_FLOWS`` of the same draw through the engine on the
   card and with ``device="cpu"``: events, clock and counters equal.
   Main path 13, ``bench.py:913`` ``stage_phase``'s NAS alternation (64
   ranks on the 64-host fat tree, 4 rounds, seed 7, ``drain/superstep:
   16``, ``drain/min-flows:32``) on the card and on the CPU, equal by
   bits, its counts printed beside ``bench_results/lmm_phase.jsonl``'s
   device row.

Each main path zeroes the launch counts just before it runs and reads
them just after; a kernel of the path that did not launch fails the run.
A kernel that K16's graphs run counts once for every iteration of the
loop body that holds it (the card's tally words, read after the path;
``kernels.path_counts``), beside its wrapper's launches from the host.
Every superstep path (main paths 1, 8, 9, 10 and 11) and the headline
chain must show K16's graph launches, one a superstep, its device
rounds above zero, and no call of a round wrapper from the host.
Then the card line again, one JSON line with a record per kernel, and
last ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without CUDA it exits non-zero before printing any result.
Longer output goes to ``chiprun_out/chip_smoke.json``.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: published H100 SXM memory rate (bytes/s) for the bounds
HBM_BYTES_PER_S = 3.35e12
FLOWS = 100_000
REDUCED_FLOWS = 10_000
K = 16
#: launches of the first superstep timed for K16's row (their median)
K16_REPS = 5
RANKS = 320
REDUCED_RANKS = 48
#: ranks of the alltoall engine plan run to its end on card and CPU
PLAN_RANKS = 32
#: the recorded local-rounds count of the 320-rank alltoall solve
#: (bench_results/e2e_probe.jsonl row 1)
RECORDED_ROUNDS = 283
#: rounds of each window of 5(b) held against the plain CPU version, and
#: the rounds between the windows' starts (the last window ends the solve)
B_WINDOW = 32
B_EVERY = 4096
#: advances of the full-size engine-plan drain past its partial advance
#: (a cut of depth: the whole drain is some 50,000 advances, and its
#: first ones take hundreds of rounds each)
PLAN_ADVANCES = 128
#: bench.py's headline solve class (bench.py:1411-1421) and the
#: precision its stage_device uses off the TPU (f64)
HEADLINE = dict(n_c=16384, n_v=100_000, deg=4, seed=42)
HL_EPS = 1e-9
#: CUDA kernels a call (the kernel nodes of one captured call,
#: ``superstep_loop.kernel_nodes``): at most this many for K4 (22 before
#: its redesign), exactly these for K8's round (its four passes) and
#: K9's stage (rows, then entries), exactly one for K5 in each arm (one
#: a run before its redesign), at most two for K6 in both arms (four
#: and five before), at most two for K11's birth and exactly one for its
#: admission (five and up to seven before)
K4_MAX_LAUNCHES = 5
K5_LAUNCHES = 1
K6_MAX_LAUNCHES = 2
K11_BIRTH_MAX_LAUNCHES = 2
K11_ADMIT_LAUNCHES = 1
K8_ROUND_LAUNCHES = 4
K9_STAGE_LAUNCHES = 2


def launch_gate(name: str, n: int, most: int, exact: bool = False) -> int:
    """Fail unless ``n`` CUDA launches a call is within the gate."""
    if n <= 0 or n > most or (exact and n != most):
        raise AssertionError(f"{name} launches {n} CUDA kernels a call, "
                             f"not {'' if exact else '1 to '}{most}")
    return n


#: the reduced class K7's round arms are held whole at (same widths)
ARMS_CLASS = dict(n_c=2048, n_v=12_500, deg=4)
#: the fault campaign of phase 13: every used link of the config-#4
#: drain fails with exponential MTBF 100 s and MTTR 0.1 s over a 2 s
#: horizon (failures clamp the link to 5% of its bandwidth)
FAULT = dict(seed=42, horizon=2.0, mtbf=100.0, mttr=0.1)
#: phase 13 fails unless more tape entries than this fire mid-drain
MIN_FIRES = 1000
#: bench.py's churn stage as recorded (bench.py:1503-1527)
CHURN = dict(n_v=100_000, seed=42, clusters=960, chain=96, churn=0.01,
             steps=6)
#: its counts in bench_results/lmm_churn.jsonl (platform-independent):
#: those of every mode, then each mode's own
CHURN_COMMON = dict(flows=99_905, rounds_first=94,
                    bytes_full_first=4_212_736)
CHURN_RECORDED = {
    "legacy-subset": dict(rounds_med=1, dirty_slots_med=-1,
                          bytes_full_med=2_106_368, bytes_delta_med=0,
                          warm_solves=0),
    "cold-full": dict(rounds_med=94, dirty_slots_med=5_994,
                      bytes_full_med=4_194_304, bytes_delta_med=0,
                      warm_solves=0),
    "cold-delta": dict(rounds_med=94, dirty_slots_med=5_994,
                       bytes_full_med=0, bytes_delta_med=98_304,
                       warm_solves=0),
    "warm-selective": dict(rounds_med=1, dirty_slots_med=5_994,
                           bytes_full_med=0, bytes_delta_med=102_400,
                           warm_solves=6)}


#: phase 16: the fleet's width, superstep, and the superstep after which
#: replica 1 is retired and a new spec admitted
FLEET_B = 8
FLEET_K = 8
ADMIT_AT = 4
#: phase 17: K1's bound-first, FATPIPE and global replica arms
ARMS_FLEET = dict(n_c=128, n_v=1000, deg=3)
#: phase 18: the 1,024-rank collective fleet's width, the other cases'
#: width, the width of the 64-rank fleet held against the plain CPU
#: fleet, and the superstep after which replica 1 is retired and a new
#: spec admitted
COLL_B = 32
COLL_B_SMALL = 8
COLL_B_CPU = 4
COLL_ADMIT_AT = 2

T0 = time.perf_counter()


def log(rec: dict) -> None:
    """One JSON line; a phase record also says when it was written
    (seconds since the script started)."""
    if "phase" in rec:
        rec = {**rec, "at_s": time.perf_counter() - T0}
    print(json.dumps(rec), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def held_plan(w) -> dict:
    """K1's row plan on the row index the Work ``w`` last ran on, held
    against ``lmm_plan_plain`` of that index on the host CPU (order and
    class sizes equal, or raise); returns its classes: the rows a block
    walks (long), a warp (medium) and a thread (short)."""
    import torch
    from simgrid_tpu_torch.kernels import lmm_round as k1
    csr, plan = w.k1_plan
    want = k1.lmm_plan_plain(csr.c_ptr.cpu(), k1.SHORT_ROW, k1.LONG_ROW)
    if not (torch.equal(plan.order.cpu(), want.order)
            and torch.equal(plan.ncls.cpu(), want.ncls)):
        raise AssertionError(f"K1's row plan of {csr.c_ptr.shape[0] - 1} "
                             f"rows differs from its plain version")
    n = [int(x) for x in want.ncls.tolist()]
    return {"long": n[0], "medium": n[1], "short": n[2],
            "short_max": k1.SHORT_ROW, "long_min": k1.LONG_ROW,
            "plan_held": True}


def ids_bytes(*masks) -> int:
    """The bytes of int32 flow ids a commit needs: 4 for each flow that
    completes or activates in some replica (a commit reads the id of
    such a flow only, and an id read once serves every replica).  Each
    mask is ``[V]`` or ``[B, V]``."""
    hit = None
    for m in masks:
        m = m.reshape(-1, m.shape[-1]).bool().any(0).cpu()
        hit = m if hit is None else hit | m
    return 4 * int(hit.sum())


class timed_graphs:
    """Within the block, CUDA events around every launch of a K16 graph
    of ``kind`` (recorded after its build), appended to ``spans`` as
    (start, end) pairs: the card's time of each launch, read after a
    sync."""

    def __init__(self, kind: str, spans: list):
        self.kind, self.spans = kind, spans

    def __enter__(self):
        import torch
        from simgrid_tpu_torch.kernels import superstep_loop as k16
        self.cls, self.orig = k16.DeviceLoop, k16.DeviceLoop.run
        orig, kind, spans = self.orig, self.kind, self.spans

        def run(loop):
            if loop.kind != kind or loop.device.type != "cuda":
                return orig(loop)
            if not loop._exec.value:
                loop._build()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            orig(loop)
            b.record()
            spans.append((a, b))
        self.cls.run = run
        return self

    def __exit__(self, *exc):
        import torch
        self.cls.run = self.orig
        torch.cuda.synchronize()
        return False


def _tensors(obj, seen=None) -> list:
    """Every tensor reachable from ``obj`` through tuples, lists and
    objects' attributes (the buffers a loop's ``refs`` keep alive)."""
    import torch
    seen = {} if seen is None else seen
    if isinstance(obj, torch.Tensor):
        seen.setdefault((obj.data_ptr(), obj.numel()), obj)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _tensors(x, seen)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        for x in vars(obj).values():
            if isinstance(x, (torch.Tensor, tuple, list)):
                _tensors(x, seen)
    return list(seen.values())


class replayed_graph:
    """Within the block, the first launch of a K16 graph of ``kind`` is
    timed in steady state: its buffers (the loop's ``refs``, the state
    the superstep starts from) are saved, the graph is launched once to
    warm it up (a graph's first launch uploads it), then ``reps`` times
    from the saved state restored, with CUDA events around each launch
    alone, appended to ``spans``.  The last replay leaves the state one
    launch leaves."""

    def __init__(self, kind: str, reps: int, spans: list):
        self.kind, self.reps, self.spans = kind, reps, spans

    def __enter__(self):
        import torch
        from simgrid_tpu_torch.kernels import superstep_loop as k16
        self.cls, self.orig = k16.DeviceLoop, k16.DeviceLoop.run
        orig, kind, spans, reps = self.orig, self.kind, self.spans, self.reps

        def run(loop):
            if loop.kind != kind or loop.device.type != "cuda" or spans:
                return orig(loop)
            if not loop._exec.value:
                loop._build()
            bufs = _tensors(loop.refs)
            saved = [t.clone() for t in bufs]
            orig(loop)
            for _ in range(reps):
                for t, c in zip(bufs, saved):
                    t.copy_(c)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                orig(loop)
                b.record()
                spans.append((a, b))
        self.cls.run = run
        return self

    def __exit__(self, *exc):
        import torch
        self.cls.run = self.orig
        torch.cuda.synchronize()
        return False


class plain_on_card:
    """Within the block, the solo drain's kernels (K1-K3) run their plain
    versions on the card's tensors and K16's loops run as Python loops:
    the plain superstep, timed on the card."""

    def __enter__(self):
        from simgrid_tpu_torch.kernels import drain_advance as k2
        from simgrid_tpu_torch.kernels import lmm_round as k1
        from simgrid_tpu_torch.kernels import superstep_commit as k3
        from simgrid_tpu_torch.kernels import superstep_loop as k16
        self.mods = [(m, m.on_cpu) for m in (k1, k2, k3)]
        for m, _ in self.mods:
            m.on_cpu = lambda *t: True
        self.cls, self.run = k16.DeviceLoop, k16.DeviceLoop.run
        self.cls.run = lambda loop: loop._run_plain(loop.steps)
        return self

    def __exit__(self, *exc):
        for m, f in self.mods:
            m.on_cpu = f
        self.cls.run = self.run
        return False


def need_loop(row: dict, where: str, kind: str, tally: str,
              supersteps: int = 0) -> dict:
    """What K16 did on a path (its row's ``loop``): the graph launches
    of ``kind``, the device iterations of the tally ``tally`` (rounds)
    and the round wrappers' calls from the host.  Fails unless the
    graphs ran and ran rounds, no round wrapper was called from the
    host, and, on a superstep path (``supersteps``), there was one graph
    launch a superstep."""
    loop = row["loop"]
    g = loop["graph_launches"].get(kind, 0)
    r = loop["device_tally"].get(tally, 0)
    host = sum(loop["host_round_calls"].values())
    if g <= 0 or r <= 0:
        raise AssertionError(f"K16 never ran {tally} on {where} ({g} "
                             f"graph launches, {r} device rounds)")
    if host:
        raise AssertionError(f"{where}: {host} round wrapper calls from "
                             f"the host (the loops run them on the card)")
    if supersteps and g != supersteps:
        raise AssertionError(f"{where}: {g} graph launches for "
                             f"{supersteps} supersteps")
    return {"graph_launches": g, "device_rounds": r,
            "device_slots": loop["device_tally"].get("slots", 0),
            "host_round_calls": host,
            "graph_launches_per_superstep": (g / supersteps
                                             if supersteps else None)}


def k1_round_bodies() -> dict:
    """K1's round loops over the whole run (every graph K16 built): the
    kernel nodes of one round by arm (the round's launch counter) and
    the loop_cond nodes inside those bodies.  Fails unless every K1 round
    body ends its own iteration (no loop_cond node), a round takes at
    most 4 kernel nodes (8 with bounds, 5 in global order with bounds),
    and the solo local and bound-first arms both ran in a loop.  K7's
    round loops (phase 11(d)) are read the same way: their kernel nodes
    a round by arm, and no K7 body may hold a loop_cond node either."""
    from simgrid_tpu_torch.kernels import superstep_loop as k16
    nodes, conds, graphs, k7 = {}, 0, 0, {}
    for b in k16.bodies(since_reset=False):
        if b["tally"] == "ell_round":
            if not b["ends"] or b["cond_nodes"]:
                raise AssertionError(f"a K7 round body keeps its loop_cond "
                                     f"node: {b}")
            k7.setdefault(b["arms"], set()).add(b["kernel_nodes"])
            continue
        if b["tally"] not in ("lmm_round", "lmm_round_fleet"):
            continue
        arm = b["arms"]
        nodes.setdefault(arm, set()).add(b["kernel_nodes"])
        conds += b["cond_nodes"] * b["graphs"]
        graphs += b["graphs"]
        if not b["ends"] or b["cond_nodes"]:
            raise AssertionError(f"a K1 round body keeps its loop_cond "
                                 f"node: {b}")
        glob, bnd = "_global" in arm, "_bounds" in arm
        most = 5 if glob and bnd else 4 if glob else 8 if bnd else 4
        if b["kernel_nodes"] > most:
            raise AssertionError(f"K1 takes {b['kernel_nodes']} kernel "
                                 f"nodes a round ({arm}; at most {most})")
    for arm in ("lmm_round", "lmm_round_bounds"):
        if arm not in nodes:
            raise AssertionError(f"{arm} never ran inside a K16 loop")
    if not k7:
        raise AssertionError("K7 never ran inside a K16 loop")
    return {"k1_nodes_per_round": {a: sorted(v) for a, v in
                                   sorted(nodes.items())},
            "k7_nodes_per_round": {a: sorted(v) for a, v in
                                   sorted(k7.items())},
            "round_body_loop_conds": conds, "round_body_graphs": graphs}


def fleet_phases(ctx: dict):
    """Phases 16-17 (module docstring): the config-#4 fleet, the stage
    counts, and K11 and the replica arms of K1-K3 against their plain
    versions.  ``ctx`` carries main's systems, helpers and records.
    Returns main path 10's campaign (its tapes built) for phase 20."""
    import numpy as np
    import torch
    from simgrid_tpu_torch.kernels import fleet_materialize as k11
    from simgrid_tpu_torch.kernels import path_counts, reset_launch_counts
    from simgrid_tpu_torch.kernels import superstep_loop as k16
    from simgrid_tpu_torch.kernels.common import (ADV_GO, FFIRE, IT, LIGHT,
                                                  SS_ACTIVE, TPOS)
    from simgrid_tpu_torch.kernels.common import LmmSystem, Work
    from simgrid_tpu_torch.kernels.drain_advance import (
        drain_advance, drain_advance_plain)
    from simgrid_tpu_torch.kernels.lmm_round import (
        lmm_init, lmm_init_plain, lmm_round, lmm_round_plain)
    from simgrid_tpu_torch.ops.csr import build_csr
    from simgrid_tpu_torch.kernels.superstep_commit import (
        packed_size, superstep_commit, superstep_commit_plain)
    from simgrid_tpu_torch.ops.lmm_batch import (_pack_elem_w,
                                                 _pack_overrides,
                                                 _pow2_bucket,
                                                 solve_arrays_batch)
    from simgrid_tpu_torch.parallel.campaign import ScenarioSpec
    from simgrid_tpu_torch.probes.timing import time_call, time_rounds
    from simgrid_tpu_torch.workloads import dragonfly, fleet_run
    from simgrid_tpu_torch.workloads.bench_solve import build_arrays
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    dsys, rsys = ctx["dsys"], ctx["rsys"]
    events_ms, nbytes, bound_ms, diff = (ctx[k] for k in (
        "events_ms", "nbytes", "bound_ms", "diff"))
    kernels, report = ctx["kernels"], ctx["report"]
    EPS = ctx["EPS"]

    def same(a, b):
        return (a.events == b.events and a.t == b.t
                and a.fault_events == b.fault_events)

    # ---- 16. main path 10: a fleet over the config-#4 drain --------------
    specs16 = fleet_run.fleet_specs(FLOWS, len(dsys.e_var), FAULT)
    admit16 = ScenarioSpec(seed=50, bw_scale=1.15, size_scale=0.95,
                           label="admitted")
    admitted = []
    names16 = dragonfly.link_names(dsys)
    camp16 = fleet_run.fleet_campaign(dsys, specs16, cuda, FLEET_K,
                                      names16, EPS)
    plan16 = camp16.plan

    def admit(sim):
        if sim.supersteps == ADMIT_AT and not admitted:
            sim.retire(1)
            sim.admit_lane(1, plan16.overrides_for(admit16),
                           plan16.tape_for(admit16))
            admitted.append(sim.supersteps)

    sim16, row16 = fleet_run.run_fleet_full(camp16, between=admit)
    c16 = row16["launches"]
    for name in ("fleet_materialize", "fleet_admit", "lmm_plan",
                 "lmm_init_fleet", "lmm_round_fleet",
                 "drain_advance_event_fleet", "superstep_commit_tape_fleet",
                 "superstep_reset_fleet", "superstep_finish_fleet",
                 "superstep_loop_superstep_fleet"):
        if c16.get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched on main path 10")
    row16["k16"] = need_loop(row16, "main path 10", "superstep_fleet",
                             "lmm_round_fleet", row16["supersteps"])
    plan_row = next(k for k in kernels if k["name"] == "lmm_plan")
    plan_row["launches_main_path_10"] = c16["lmm_plan"]
    t0 = time.perf_counter()
    solo = {b: plan16.solo(specs16[b]) for b in (0, 4)}
    solo_adm = plan16.solo(admit16)
    solo_s = time.perf_counter() - t0
    held_a = all(same(sim16.replicas[b], solo[b]) for b in solo)
    held_d = bool(admitted) and same(sim16.replicas[1], solo_adm)
    # (b) the reduced fleet, card against the plain fleet on the CPU
    specs16b = fleet_run.fleet_specs(REDUCED_FLOWS, len(rsys.e_var), FAULT,
                                     sweep=2, faulted=2)
    names16b = dragonfly.link_names(rsys)
    devs = (("cuda", cuda), ("cpu", cpu))
    red = {k: fleet_run.run_fleet_full(fleet_run.fleet_campaign(
        rsys, specs16b, dev, FLEET_K, names16b, EPS)) for k, dev in devs}
    held_b = all(same(a, b) for a, b in zip(red["cuda"][0].replicas,
                                            red["cpu"][0].replicas))
    # (c) launches per superstep at B = 1 and B = FLEET_B: the same
    # host launches, one of them the graph's
    per = {}
    for width, sp in ((1, specs16[:1]), (FLEET_B, specs16)):
        per[width] = fleet_run.launches_per_superstep(plan16.executor(sp),
                                                      4)
    held_c = all((a["launches"], a["graph_launches"])
                 == (b["launches"], b["graph_launches"]) == (
                     a["launches"], 1)
                 for a, b in zip(per[1], per[FLEET_B]))
    fires16 = sum(row16["fires"])
    rec = {"phase": "main_path_fleet", **row16,
           "phase13_solo_wall_s": ctx["wall13"],
           "eight_solo_walls_s": 8 * ctx["wall13"],
           "admitted_at_superstep": admitted,
           "a_replicas_0_4_equal_solo": held_a, "solo_walls_s": solo_s,
           "d_admitted_equals_solo": held_d,
           "b_flows": REDUCED_FLOWS, "b_card_equals_cpu": held_b,
           "b_cuda_wall_s": red["cuda"][1]["wall_s"],
           "b_cpu_wall_s": red["cpu"][1]["wall_s"],
           "b_fires": red["cuda"][1]["fires"],
           "c_launches_b1": per[1], "c_launches_b8": per[FLEET_B],
           "c_equal": held_c}
    log(rec)
    report["main_path_fleet"] = rec
    if not (held_a and held_b and held_c and held_d):
        raise AssertionError(f"fleet phase failed: (a) {held_a}, (b) "
                             f"{held_b}, (c) {held_c}, (d) {held_d}")
    if fires16 <= 0 or any(e is not None for e in row16["errors"]):
        raise AssertionError("fleet: no fault fired, or a replica failed")
    del red, sim16
    torch.cuda.empty_cache()

    # ---- 17. bench.py's sweep and fault stages ---------------------------
    rows17 = fleet_run.run_sweep(device=cuda) \
        + fleet_run.run_fault_modes(device=cuda)
    bad17 = []
    for row in rows17:
        key = (f"sweep_b{row['batch']}" if row["stage"] == "sweep"
               else f"fault_{row['fault_mode']}")
        want = fleet_run.JAX_COUNTS[key]
        got = {k: row[k] for k in want}
        if got != want:
            bad17.append((key, got, want))
        if row.get("events_consistent") is False \
                or row.get("solo_bit_identical") is False:
            bad17.append((key, "events"))
        log({"phase": "fleet_stage", **row, "jax_counts": want})
    report["fleet_stages"] = rows17
    if bad17:
        raise AssertionError(f"fleet stage counts differ: {bad17}")

    # K11, K1-K3 replica arms at phase 16's shapes (B = FLEET_B)
    V, C = FLOWS, dsys.n_cnst
    plans = {k: plan16.with_device(dev) for k, dev in devs}
    sims = {k: p.executor(specs16) for k, p in plans.items()}
    g, c = sims["cuda"], sims["cpu"]
    Bk = g.B
    ovs = [plans["cuda"].overrides_for(sp) for sp in specs16]
    pay = _pack_overrides(ovs, C, V)
    ei, ewv = _pack_elem_w(ovs, g.sys.n_e, np.float64)
    outs = {k: ([torch.empty((Bk, n), dtype=torch.float64, device=d)
                 for n in (C, V, V, V)],
                torch.empty((Bk, g.sys.n_e), dtype=torch.float64, device=d))
            for k, d in devs}

    def birth(dev, plain=False):
        s_ = sims[dev]
        o, ew = outs[dev]
        (k11.materialize_plain if plain else k11.materialize)(
            s_._base_dev, pay, o, 1e-4, True, ew=(s_._base_ew, ew, ei, ewv))
    birth("cuda")
    birth("cpu")
    torch.cuda.synchronize()
    err = max(max(diff(a, b) for a, b in zip(outs["cuda"][0],
                                             outs["cpu"][0])),
              diff(outs["cuda"][1], outs["cpu"][1]))
    if err != 0.0:
        raise AssertionError(f"K11 (birth) differs from its plain "
                             f"version ({err})")
    m_nodes = launch_gate("K11 (birth)", k16.kernel_nodes(
        lambda: birth("cuda")), K11_BIRTH_MAX_LAUNCHES)
    m_ms = events_ms(lambda: birth("cuda"), 20)
    m_t = time_call(lambda: birth("cuda"))
    m_plain = events_ms(lambda: birth("cuda", plain=True), 3)
    base_b = nbytes(*g._base_dev, g._base_ew)
    m_bytes = (base_b + sum(a.nbytes for a in pay) + ei.nbytes + ewv.nbytes
               + nbytes(*outs["cuda"][0], outs["cuda"][1]))
    kernels.append(dict(
        name="fleet_materialize", route="cuda",
        source="simgrid_tpu_torch/csrc/fleet_materialize.cu",
        replaces="simgrid_tpu/ops/lmm_batch.py:390",
        launches=c16["fleet_materialize"], max_abs_err=err, ms=m_t["ms"],
        paced_ms=m_ms, queued=m_t["queued"], plain_ms=m_plain,
        bound_ms=bound_ms(m_bytes), bound_by="bytes", library_ms=None,
        cuda_launches_per_call=m_nodes, replicas=Bk,
        launches_from="main path 10 (the config-#4 fleet's birth: its "
                      "state and its weights in one launch)"))
    log({"phase": "kernel", **kernels[-1]})

    # admission: the admitted spec into row 1 (state, tape row, weights)
    ov1 = plans["cuda"].overrides_for(admit16)
    wid = (_pow2_bucket(len(ov1.link_scale)),
           _pow2_bucket(len(ov1.flow_scale)),
           _pow2_bucket(len(ov1.dead_flows)))
    pay1 = _pack_overrides([ov1], C, V, wid)
    ei1, ewv1 = _pack_elem_w([ov1], g.sys.n_e, np.float64, 1)
    # the admitted spec has no tape: K11 pads its whole row on the card
    row_t = (np.zeros(0), np.zeros(0, np.int32), np.zeros(0))

    def admit_row(dev, plain=False):
        s_ = sims[dev]
        o, ew = outs[dev]
        (k11.admit_plain if plain else k11.admit)(
            s_._base_dev, pay1, o, 1, 1e-4, True,
            ew=(s_._base_ew, ew, ei1, ewv1), tape=(s_._tape, row_t))
    admit_row("cuda")
    admit_row("cpu")
    torch.cuda.synchronize()
    err = max(max(diff(a, b) for a, b in zip(outs["cuda"][0],
                                             outs["cpu"][0])),
              diff(outs["cuda"][1], outs["cpu"][1]),
              max(diff(a, b) for a, b in zip(g._tape, c._tape)))
    if err != 0.0:
        raise AssertionError(f"K11 (admission) differs from its plain "
                             f"version ({err})")
    a_nodes = launch_gate("K11 (admission)", k16.kernel_nodes(
        lambda: admit_row("cuda")), K11_ADMIT_LAUNCHES, exact=True)
    # the card's time (queued behind a sleep) beside the host-paced one
    a_paced = events_ms(lambda: admit_row("cuda"), 20)
    a_t = time_call(lambda: admit_row("cuda"))
    a_plain = events_ms(lambda: admit_row("cuda", plain=True), 5)
    rem_row = outs["cuda"][0][2][1].clone()
    idx1 = torch.tensor([1], device=cuda)

    def a_lib_fn():
        outs["cuda"][0][2].index_put_((idx1,), rem_row[None])
    a_lib_paced = events_ms(a_lib_fn, 20)
    a_lib = time_call(a_lib_fn)["ms"]
    a_bytes = (base_b + sum(a.nbytes for a in pay1) + ei1.nbytes
               + ewv1.nbytes + nbytes(*(t[1] for t in g._tape))
               + 8 * (C + 3 * V) + 8 * g.sys.n_e)
    kernels.append(dict(
        name="fleet_admit", route="cuda",
        source="simgrid_tpu_torch/csrc/fleet_materialize.cu",
        replaces="simgrid_tpu/ops/lmm_batch.py:409",
        launches=c16["fleet_admit"], max_abs_err=err, ms=a_t["ms"],
        paced_ms=a_paced, queued=a_t["queued"], plain_ms=a_plain,
        bound_ms=bound_ms(a_bytes), bound_by="bytes", library_ms=a_lib,
        library_paced_ms=a_lib_paced,
        library="a partial yardstick: index_put_ of one row of the "
                "remains, one of the admission's writes (one call)",
        cuda_launches_per_call=a_nodes,
        launches_from="main path 10 (one admission: its state, tape and "
                      "weight rows in one launch)"))
    log({"phase": "kernel", **kernels[-1]})

    # K1's replica arm: init and the first rounds card vs plain, then the
    # whole first solve of every replica timed on the card
    def init_rounds(s_, n):
        lmm_init(s_.sys, s_.w, s_._pen, EPS)
        for _ in range(n):
            lmm_round(s_.sys, s_.w, s_._pen, EPS)
    init_rounds(g, 4)
    init_rounds(c, 4)
    torch.cuda.synchronize()
    err = max(diff(getattr(g.w, n), getattr(c.w, n)) for n in (
        "v_value", "v_fixed", "remaining", "usage", "light", "ctrl"))
    if err != 0.0:
        raise AssertionError(f"K1's replica arm differs from its plain "
                             f"version ({err})")
    lmm_init(g.sys, g.w, g._pen, EPS)
    rounds_k = 0
    while int(g.w.ctrl[:, LIGHT].max()):
        for _ in range(16):
            lmm_round(g.sys, g.w, g._pen, EPS)
        rounds_k = int(g.w.ctrl[:, IT].max())
    k1f = time_rounds(lambda: init_rounds(g, 0),
                      lambda: lmm_round(g.sys, g.w, g._pen, EPS), rounds_k)

    def plain_rounds(s_, n, **kw):
        """The plain fleet on the card's tensors: the solo plain
        functions over each replica's views."""
        for b in range(s_.B):
            sb, wb = s_.sys.replica(b), s_.w.replica(b)
            lmm_init_plain(sb, wb, s_._pen[b], EPS)
            for _ in range(n):
                lmm_round_plain(sb, wb, s_._pen[b], EPS, **kw)
    k1f_plain = (events_ms(lambda: plain_rounds(g, 2), 1)
                 - events_ms(lambda: plain_rounds(g, 0), 1)) / 2
    w = g.w
    k1f_bytes = (nbytes(g.sys.e_var, g.sys.e_cnst, g.sys.e_w,
                        g.sys.c_bound, g._pen)
                 + 2 * nbytes(w.v_value, w.v_fixed, w.remaining, w.usage,
                              w.light))
    kernels.append(dict(
        name="lmm_round_fleet", route="cuda",
        source="simgrid_tpu_torch/csrc/lmm_round.cu",
        replaces="simgrid_tpu/ops/lmm_batch.py:508",
        launches=c16["lmm_round_fleet"], max_abs_err=err, ms=k1f["ms"],
        paced_ms=k1f["paced_ms"], queued=k1f["queued"],
        plain_ms=k1f_plain, bound_ms=bound_ms(k1f_bytes), bound_by="bytes",
        library_ms=None, replicas=Bk, first_solve_rounds=rounds_k,
        row_classes=held_plan(g.w),
        launches_from=f"main path 10; lmm_init_fleet "
                      f"{c16['lmm_init_fleet']}"))
    log({"phase": "kernel", **kernels[-1]})

    # K1's bound-first, FATPIPE and global arms with the replica axis:
    # whole solves of B = FLEET_B replicas (solve_arrays_batch) card
    # against the plain fleet on the CPU, and ms per round from init
    rng = np.random.default_rng(5)
    n_c17, n_v17 = ARMS_FLEET["n_c"], ARMS_FLEET["n_v"]
    arr = build_arrays(rng, n_c17, n_v17, ARMS_FLEET["deg"], np.float64)
    E17 = arr.n_elem
    cb17 = arr.c_bound[:n_c17] * rng.uniform(0.8, 1.2, (Bk, n_c17))
    pen17 = np.ones((Bk, n_v17))
    vb17 = np.where(rng.random((Bk, n_v17)) < 0.5,
                    rng.uniform(1e-3, 1e-2, (Bk, n_v17)), -1.0)
    fat17 = np.zeros(n_c17, bool)
    fat17[rng.choice(n_c17, n_c17 // 10, replace=False)] = True
    args17 = (arr.e_var[:E17], arr.e_cnst[:E17], arr.e_w[:E17], cb17,
              fat17, pen17, vb17, 1e-9)
    ev17, ec17 = (torch.from_numpy(a.copy()).to(cuda) for a in args17[:2])
    ew17 = torch.from_numpy(args17[2].copy()).to(cuda)
    s17 = LmmSystem(ev17, ec17, ew17, torch.from_numpy(cb17).to(cuda),
                    build_csr(ev17, ec17, ew17, n_c17, n_v17), n_v17,
                    torch.from_numpy(fat17).to(cuda))
    p17, vb17_g = (torch.from_numpy(a).to(cuda) for a in (pen17, vb17))
    w17 = Work(n_v17, n_c17, torch.float64, cuda, B=Bk)
    for label, glob in (("lmm_round_bounds_fatpipe_fleet", False),
                        ("lmm_round_global_bounds_fatpipe_fleet", True)):
        kw = dict(parallel_rounds=not glob)
        reset_launch_counts()
        got = solve_arrays_batch(*args17, device=cuda, **kw)
        torch.cuda.synchronize()
        n_l = path_counts().get(label, 0)
        want = solve_arrays_batch(*args17, device=cpu, **kw)
        err = max(diff(torch.from_numpy(np.asarray(a)),
                       torch.from_numpy(np.asarray(b)))
                  for a, b in zip(got, want))
        if err != 0.0 or n_l <= 0:
            raise AssertionError(f"{label}: card differs from plain "
                                 f"({err}) or never launched")
        rk = int(np.max(got[3]))
        t17 = time_rounds(
            lambda: lmm_init(s17, w17, p17, 1e-9, has_fatpipe=True),
            lambda: lmm_round(s17, w17, p17, 1e-9, vb17_g, True, True,
                              glob), rk)

        def plain(n):
            for b in range(Bk):
                sb, wb = s17.replica(b), w17.replica(b)
                lmm_init_plain(sb, wb, p17[b], 1e-9, has_fatpipe=True)
                for _ in range(n):
                    lmm_round_plain(sb, wb, p17[b], 1e-9, vb17_g[b], True,
                                    True, glob)
        plain_ms = (events_ms(lambda: plain(2), 1)
                    - events_ms(lambda: plain(0), 1)) / 2
        k1b_bytes = (nbytes(ev17, ec17, ew17, s17.c_bound, p17, vb17_g,
                            s17.c_fatpipe)
                     + 2 * nbytes(w17.v_value, w17.v_fixed, w17.remaining,
                                  w17.usage, w17.light))
        kernels.append(dict(
            name=label, route="cuda",
            source="simgrid_tpu_torch/csrc/lmm_round.cu",
            replaces="simgrid_tpu/ops/lmm_jax.py:1054",
            launches=n_l, max_abs_err=err, ms=t17["ms"],
            paced_ms=t17["paced_ms"], queued=t17["queued"],
            plain_ms=plain_ms, bound_ms=bound_ms(k1b_bytes),
            bound_by="bytes",
            library_ms=None, replicas=Bk, rounds=rk, **ARMS_FLEET,
            launches_from="its own whole solve (solve_arrays_batch; no "
                          "main path has rate bounds)"))
        log({"phase": "kernel", **kernels[-1]})
    del s17, w17

    # K2's event arm and K3's tape arm with the replica axis: the first
    # advance of every replica from the converged rates of the card solve
    rates = g.w.v_value.clone()
    st = {}

    def k2_setup(s_, dev):
        st[dev] = dict(pen=g._pen.to(dict(devs)[dev], copy=True),
                       rem=g._rem.to(dict(devs)[dev], copy=True))
        s_.w.v_value.copy_(rates)
        for t in (s_.w.ctrl, s_.w.fctrl, s_.w.evf):
            t.zero_()
    k2_setup(g, "cuda")
    k2_setup(c, "cpu")
    drain_advance(st["cuda"]["pen"], st["cuda"]["rem"], g._thresh, g.w,
                  tape_t=g._tape[0])
    drain_advance_plain_fleet = [drain_advance_plain(
        st["cpu"]["pen"][b], st["cpu"]["rem"][b], c._thresh[b],
        c.w.replica(b), tape_t=c._tape[0][b]) for b in range(Bk)]
    torch.cuda.synchronize()
    err = max(diff(st["cuda"]["pen"], st["cpu"]["pen"]),
              diff(st["cuda"]["rem"], st["cpu"]["rem"]),
              diff(g.w.done, c.w.done), diff(g.w.ctrl, c.w.ctrl),
              diff(g.w.fctrl, c.w.fctrl), diff(g.w.evf, c.w.evf))
    fired = int((c.w.ctrl[:, FFIRE] > 0).sum())
    if err != 0.0 or not fired or not all(drain_advance_plain_fleet):
        raise AssertionError(f"K2's replica event arm differs from its "
                             f"plain version ({err}) or no tape fired")
    def k2f_fn():
        drain_advance(st["cuda"]["pen"], st["cuda"]["rem"], g._thresh, g.w,
                      tape_t=g._tape[0])
    k2f_ms = events_ms(k2f_fn, 20, lambda: k2_setup(g, "cuda"))
    k2f_plain = events_ms(lambda: [drain_advance_plain(
        st["cuda"]["pen"][b], st["cuda"]["rem"][b], g._thresh[b],
        g.w.replica(b), tape_t=g._tape[0][b]) for b in range(Bk)], 2,
        lambda: k2_setup(g, "cuda"))
    k2f_bytes = (nbytes(g._pen, g._rem, g._thresh, rates)
                 + 2 * nbytes(g._pen) + Bk * V + 8 * Bk)
    kernels.append(dict(
        name="drain_advance_event_fleet", route="cuda",
        source="simgrid_tpu_torch/csrc/drain_advance.cu",
        replaces="simgrid_tpu/ops/lmm_batch.py:508",
        launches=c16["drain_advance_event_fleet"], max_abs_err=err,
        ms=k2f_ms, plain_ms=k2f_plain, bound_ms=bound_ms(k2f_bytes),
        bound_by="bytes", library_ms=None, replicas=Bk, fired=fired,
        launches_from="main path 10 (the config-#4 fleet)"))
    log({"phase": "kernel", **kernels[-1]})

    ring_n = V + FLEET_K
    psz = packed_size(FLEET_K, ring_n)
    pk = {k: torch.zeros((Bk, psz), dtype=torch.float64, device=d)
          for k, d in devs}
    cb0 = g.sys.c_bound.clone()
    snap = (g.w.ctrl.clone(), g.w.fctrl.clone())

    def k3_prime(s_, dev):
        s_.w.ctrl[:, SS_ACTIVE] = 1
        s_.w.ctrl[:, ADV_GO] = 1
        s_.w.ctrl[:, TPOS] = 0
        pk[dev].zero_()
        s_.sys.c_bound.copy_(cb0)
    k3_prime(g, "cuda")
    k3_prime(c, "cpu")
    superstep_commit(g.w, g._ids, pk["cuda"], FLEET_K, ring_n,
                     tape=g._tape[1:], c_bound=g.sys.c_bound)
    for b in range(Bk):
        superstep_commit_plain(c.w.replica(b), c._ids, pk["cpu"][b],
                               FLEET_K, ring_n,
                               tape=(c._tape[1][b], c._tape[2][b]),
                               c_bound=c.sys.c_bound[b])
    torch.cuda.synchronize()
    err = max(diff(pk["cuda"], pk["cpu"]), diff(g.w.ctrl, c.w.ctrl),
              diff(g.w.fctrl, c.w.fctrl),
              diff(g.sys.c_bound, c.sys.c_bound))
    if err != 0.0 or int((c.w.ctrl[:, TPOS] > 0).sum()) != fired:
        raise AssertionError(f"K3's replica tape arm differs from its "
                             f"plain version ({err})")

    def k3_setup():
        g.w.ctrl.copy_(snap[0])
        g.w.fctrl.copy_(snap[1])
        k3_prime(g, "cuda")

    def k3f_fn():
        superstep_commit(g.w, g._ids, pk["cuda"], FLEET_K, ring_n,
                         tape=g._tape[1:], c_bound=g.sys.c_bound)
    k3f_paced = events_ms(k3f_fn, 20, k3_setup)
    k3f_t = time_call(k3f_fn, k3_setup)
    k3f_plain = events_ms(lambda: [superstep_commit_plain(
        g.w.replica(b), g._ids, pk["cuda"][b], FLEET_K, ring_n,
        tape=(g._tape[1][b], g._tape[2][b]), c_bound=g.sys.c_bound[b])
        for b in range(Bk)], 2, k3_setup)
    n_done = int(c.w.done.sum())
    k3f_bytes = (Bk * V + ids_bytes(c.w.done) + (n_done + fired) * 16
                 + fired * 16)
    slot0 = torch.tensor([0], device=cuda)

    def k3f_lib_fn():
        g.sys.c_bound[0].index_put_((slot0,), cb0[0, :1])
    k3f_lib_paced = events_ms(k3f_lib_fn, 20)
    k3f_lib = time_call(k3f_lib_fn)["ms"]
    kernels.append(dict(
        name="superstep_commit_tape_fleet", route="cuda",
        source="simgrid_tpu_torch/csrc/superstep_commit.cu",
        replaces="simgrid_tpu/ops/lmm_batch.py:508",
        launches=c16["superstep_commit_tape_fleet"], max_abs_err=err,
        ms=k3f_t["ms"], paced_ms=k3f_paced, queued=k3f_t["queued"],
        plain_ms=k3f_plain, bound_ms=bound_ms(k3f_bytes),
        bound_by="bytes", library_ms=k3f_lib,
        library_paced_ms=k3f_lib_paced,
        library="a partial yardstick: index_put_ of one fired bound, one "
                "of the commit's writes (one call)", replicas=Bk,
        launches_from="main path 10 (the config-#4 fleet)"))
    log({"phase": "kernel", **kernels[-1]})
    del sims, g, c, outs
    torch.cuda.empty_cache()
    return camp16


def collective_fleet_phase(ctx: dict):
    """Phase 18 (module docstring): collective fleets over phase 14's
    cases, the lanes held against their solo drains and the plain CPU
    fleet, the launches per superstep, and K10's replica arm, K3's
    collective arm and K2's event arm on a fleet, and K11's collective
    admission against their plain versions.  ``ctx`` carries main's
    helpers and phase 14's tape drains (``tape14``, by rank count).
    Returns main path 11's campaign for phase 20."""
    import numpy as np
    import torch
    from simgrid_tpu_torch.kernels import fleet_materialize as k11
    from simgrid_tpu_torch.kernels.common import (AANY, ADV_OK, LIGHT,
                                                  PENDING, SS_ACTIVE, T_SUM,
                                                  Work)
    from simgrid_tpu_torch.kernels.dag_walk import (dag_csr, dag_walk,
                                                    dag_walk_plain)
    from simgrid_tpu_torch.kernels.drain_advance import (
        drain_advance, drain_advance_plain)
    from simgrid_tpu_torch.kernels.lmm_round import lmm_init, lmm_round
    from simgrid_tpu_torch.kernels.superstep_commit import (
        packed_size, superstep_commit, superstep_commit_plain)
    from simgrid_tpu_torch.kernels import superstep_loop as k16
    from simgrid_tpu_torch.ops.lmm_arrays import to2d
    from simgrid_tpu_torch.ops.lmm_batch import _pack_overrides, _pow2_bucket
    from simgrid_tpu_torch.ops.lmm_torch import to_device_system
    from simgrid_tpu_torch.probes.timing import time_call
    from simgrid_tpu_torch.parallel.campaign import ScenarioSpec
    from simgrid_tpu_torch.workloads import collective_fleet as cf
    from simgrid_tpu_torch.workloads import collective_run, fleet_run
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    f64 = torch.float64
    events_ms, nbytes, bound_ms, diff = (ctx[k] for k in (
        "events_ms", "nbytes", "bound_ms", "diff"))
    kernels, report, tape14 = ctx["kernels"], ctx["report"], ctx["tape14"]

    def slim(row):
        return {k: v for k, v in row.items()
                if k not in ("t_sim", "advances", "errors")}

    # ---- 18. main path 11: collective fleets ----------------------------
    cs = collective_run.CASES[2]
    t14 = tape14[cs.ranks]
    specs = cf.fleet_specs(cs, t14["t"], COLL_B)
    camp = cf.fleet_campaign(cs, specs, cuda)
    plan = camp.plan
    fresh = ScenarioSpec(seed=50, bw_scale=1.15, size_scale=0.95,
                         collective=cs, label="admitted")
    admitted = []

    def admit(sim):
        if sim.supersteps == COLL_ADMIT_AT and not admitted:
            sim.retire(1)
            sim.admit_lane(1, plan.overrides_for(fresh),
                           plan.tape_for(fresh))
            admitted.append(sim.supersteps)

    sim, row = fleet_run.run_fleet_full(camp, between=admit)
    c18 = row["launches"]
    for name in ("fleet_materialize_coll", "fleet_admit_coll", "lmm_plan", "lmm_init_fleet", "lmm_round_fleet",
                 "drain_advance_event_fleet", "superstep_commit_coll_fleet",
                 "dag_walk_fleet",
                 "superstep_reset_fleet", "superstep_finish_fleet",
                 "superstep_loop_superstep_fleet"):
        if c18.get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched on main path 11")
    row["k16"] = need_loop(row, "main path 11", "superstep_fleet",
                           "lmm_round_fleet", row["supersteps"])
    plan_row = next(k for k in kernels if k["name"] == "lmm_plan")
    plan_row["launches_main_path_11"] = c18["lmm_plan"]
    faulted = range(COLL_B - COLL_B // 4, COLL_B)
    fires = {b: cf.fires_before_end(sim.replicas[b]) for b in faulted}
    t0 = time.perf_counter()
    lanes = {b: plan.solo(specs[b]) for b in (0, 2, 16, 24)}
    lanes["admitted"] = plan.solo(fresh)
    solo_s = time.perf_counter() - t0
    rep_of = lambda k: sim.replicas[1 if k == "admitted" else k]  # noqa
    held_a = {str(k): cf.same_lane(rep_of(k), r) for k, r in lanes.items()}
    lane0 = sim.replicas[0]
    held_14 = (lane0.events == t14["events"]
               and lane0.collective_events == t14["collective_events"]
               and sim.collective_clock_of(0) == tuple(t14["clock"]))
    rec = {"phase": "main_path_collective_fleet", **slim(row),
           "admitted_at_superstep": admitted,
           "solo_tape_wall_s": t14["wall_s"],
           "b_times_solo_wall_s": COLL_B * t14["wall_s"],
           "a_lanes_equal_solo": held_a, "a_lane0_equals_phase14": held_14,
           "solo_walls_s": solo_s,
           "faulted_fires_before_end": list(fires.values()),
           "advances_max": max(row["advances"]),
           "t_sim_range": [min(row["t_sim"]), max(row["t_sim"])]}
    log(rec)
    report["main_path_collective_fleet"] = dict(rec, t_sim=row["t_sim"],
                                                advances=row["advances"])
    if not (all(held_a.values()) and held_14 and admitted):
        raise AssertionError(f"collective fleet (a) failed: {held_a}, "
                             f"lane 0 == phase 14: {held_14}, admitted "
                             f"{admitted}")
    if min(fires.values()) <= 0 or any(e is not None
                                       for e in row["errors"]):
        raise AssertionError(f"collective fleet: a faulted lane never "
                             f"fired before its end ({fires}) or a lane "
                             f"failed ({row['errors']})")

    # (b) the 64-rank ring and the 256-rank recursive doubling at a
    # quarter the width, and the 64-rank fleet at COLL_B_CPU on the card
    # and through the plain fleet on the host CPU
    rows_b = []
    for cs_b in collective_run.CASES[:2]:
        tb = tape14[cs_b.ranks]
        sp_b = cf.fleet_specs(cs_b, tb["t"], COLL_B_SMALL)
        sim_b, row_b = fleet_run.run_fleet_full(
            cf.fleet_campaign(cs_b, sp_b, cuda))
        fires_b = [cf.fires_before_end(sim_b.replicas[b])
                   for b in range(COLL_B_SMALL - COLL_B_SMALL // 4,
                                  COLL_B_SMALL)]
        held_b = (sim_b.replicas[0].events == tb["events"]
                  and sim_b.replicas[0].collective_events
                  == tb["collective_events"]
                  and sim_b.collective_clock_of(0) == tuple(tb["clock"]))
        rec_b = {"phase": "collective_fleet", **slim(row_b),
                 "lane0_equals_phase14": held_b,
                 "faulted_fires_before_end": fires_b}
        if cs_b.ranks == collective_run.CASES[0].ranks:
            sp_c = cf.fleet_specs(cs_b, tb["t"], COLL_B_CPU)
            pair = {k: fleet_run.run_fleet_full(
                        cf.fleet_campaign(cs_b, sp_c, dev))
                    for k, dev in (("cuda", cuda), ("cpu", cpu))}
            g_c, c_c = pair["cuda"][0], pair["cpu"][0]
            rec_b["cpu_b"] = COLL_B_CPU
            rec_b["card_equals_cpu"] = all(
                cf.same_lane(g_c.replicas[b], c_c.replicas[b],
                             g_c.collective_clock_of(b),
                             c_c.collective_clock_of(b))
                for b in range(COLL_B_CPU))
            rec_b["cpu_b_cuda_wall_s"] = pair["cuda"][1]["wall_s"]
            rec_b["cpu_b_cpu_wall_s"] = pair["cpu"][1]["wall_s"]
        log(rec_b)
        rows_b.append(rec_b)
        if not held_b or min(fires_b) <= 0 \
                or not rec_b.get("card_equals_cpu", True) \
                or any(e is not None for e in row_b["errors"]):
            raise AssertionError(f"collective fleet (b) failed: {rec_b}")
    report["collective_fleets_b"] = rows_b

    # (c) launches of each of the first 3 supersteps at B = 1 (the plain
    # lane) and COLL_B
    per = {w_: fleet_run.launches_per_superstep(plan.executor(sp), 3)
           for w_, sp in ((1, specs[:1]), (COLL_B, specs))}
    held_c = all((a["launches"], a["graph_launches"])
                 == (b["launches"], b["graph_launches"]) == (
                     a["launches"], 1)
                 for a, b in zip(per[1], per[COLL_B]))
    rec = {"phase": "collective_fleet_launches", "c_launches_b1": per[1],
           f"c_launches_b{COLL_B}": per[COLL_B], "c_equal": held_c}
    log(rec)
    report["collective_fleet_launches"] = rec
    if not held_c:
        raise AssertionError(f"collective fleet (c): launches per "
                             f"superstep grow with B: {per}")
    del sim
    torch.cuda.empty_cache()

    # (d) the kernels at (a)'s shapes, B = COLL_B: from the converged
    # rates of the schedule's roots, every replica's first advance with
    # a quarter of the dormant flows (a different quarter per replica)
    # pending inside it: K2's event arm on the replicas' dates, then
    # K3's collective arm; then K10 with the roots completed; then K11's
    # admission of one row
    dc = plan._dc
    V, C, Bk = dc.n_v, dc.n_c, COLL_B
    flat = [to2d(a).reshape(-1) for a in (dc.e_var, dc.e_cnst, dc.e_w)]
    s1 = to_device_system(flat[0], flat[1], flat[2], dc.c_bound, V, f64,
                          cuda)
    pen0 = torch.from_numpy(dc.penalty0.copy())
    w1 = Work(V, C, f64, cuda)
    lmm_init(s1, w1, pen0.to(cuda), cf.EPS)
    while True:
        for _ in range(16):
            lmm_round(s1, w1, pen0.to(cuda), cf.EPS)
        if int(w1.ctrl[LIGHT]) == 0:
            break
    rates = w1.v_value.clone()
    dormant = np.flatnonzero(dc.penalty0 == 0)
    ready0 = np.full((Bk, V), np.inf)
    for b in range(Bk):
        ready0[b, dormant[b % 4::4]] = 1e-6 * (1 + b % 3)
    ready0 = torch.from_numpy(ready0)
    pend0 = torch.isfinite(ready0).sum(1).to(torch.int32)
    rem0 = torch.from_numpy(np.tile(dc.sizes, (Bk, 1)))
    thr0 = 1e-4 * rem0
    ids_g = torch.arange(V, dtype=torch.int32, device=cuda)
    ring_n = 2 * V
    works = {k: Work(V, C, f64, d, B=Bk) for k, d in (("cuda", cuda),
                                                      ("cpu", cpu))}
    st = {}

    def k2_setup(k):
        d = dict(cuda=cuda, cpu=cpu)[k]
        w = works[k]
        st[k] = dict(pen=pen0.to(d).repeat(Bk, 1), rem=rem0.to(d, copy=True),
                     ready=ready0.to(d, copy=True), thr=thr0.to(d),
                     pk=torch.zeros((Bk, packed_size(cf.SUPERSTEP, ring_n)),
                                    dtype=f64, device=d))
        w.v_value.copy_(rates.expand(Bk, V))
        for t in (w.ctrl, w.fctrl, w.evf):
            t.zero_()
        w.ctrl[:, SS_ACTIVE] = 1
        w.ctrl[:, PENDING] = pend0.to(d)

    def k2_run(k):
        x = st[k]
        drain_advance(x["pen"], x["rem"], x["thr"], works[k], gated=True,
                      ready=x["ready"])

    def k3_run(k):
        x = st[k]
        superstep_commit(works[k], ids_g if k == "cuda" else ids_g.cpu(),
                         x["pk"], cf.SUPERSTEP, ring_n, n_c=C,
                         ready=x["ready"], pen=x["pen"])
    for k in ("cuda", "cpu"):
        k2_setup(k)
        k2_run(k)
    torch.cuda.synchronize()
    wg, wc = works["cuda"], works["cpu"]
    xg, xc = st["cuda"], st["cpu"]
    err2 = max(diff(wg.ctrl, wc.ctrl), diff(wg.fctrl, wc.fctrl),
               diff(wg.evf, wc.evf), diff(wg.done, wc.done),
               diff(xg["pen"], xc["pen"]), diff(xg["rem"], xc["rem"]))
    aany = int(wc.ctrl[:, AANY].sum())
    if err2 != 0.0 or aany != Bk:
        raise AssertionError(f"K2's event arm on a collective fleet "
                             f"differs from its plain version ({err2}) or "
                             f"did not land on the dates ({aany})")
    snap = [t.clone() for t in (wg.ctrl, wg.fctrl, wg.evf, wg.done)]
    for k in ("cuda", "cpu"):
        k3_run(k)
    torch.cuda.synchronize()
    err3 = max(diff(xg["pk"], xc["pk"]), diff(wg.ctrl, wc.ctrl),
               diff(wg.fctrl, wc.fctrl), diff(xg["pen"], xc["pen"]),
               diff(xg["ready"], xc["ready"]))
    n_act = int(pend0.sum())
    if err3 != 0.0 or int(wc.ctrl[:, PENDING].sum()) != 0:
        raise AssertionError(f"K3's collective arm on a fleet differs "
                             f"from its plain version ({err3}) or left "
                             f"activations pending")
    n_done = int(wc.done.sum())

    def k2_restore():
        xg["pen"].copy_(pen0.expand(Bk, V))
        xg["rem"].copy_(rem0)
        xg["ready"].copy_(ready0)
        for t in (wg.ctrl, wg.fctrl, wg.evf):
            t.zero_()
        wg.ctrl[:, SS_ACTIVE] = 1
        wg.ctrl[:, PENDING] = pend0.to(cuda)

    def k3_restore():
        for t, s_ in zip((wg.ctrl, wg.fctrl, wg.evf, wg.done), snap):
            t.copy_(s_)
        xg["pen"].copy_(pen0.expand(Bk, V))
        xg["ready"].copy_(ready0)
    k2_ms = events_ms(lambda: k2_run("cuda"), 20, k2_restore)
    k2_plain = events_ms(lambda: [drain_advance_plain(
        xg["pen"][b], xg["rem"][b], xg["thr"][b], wg.replica(b), True,
        ready=xg["ready"][b]) for b in range(Bk)], 2, k2_restore)
    k3_ms = events_ms(lambda: k3_run("cuda"), 20, k3_restore)
    k3_plain = events_ms(lambda: [superstep_commit_plain(
        wg.replica(b), ids_g, xg["pk"][b], cf.SUPERSTEP, ring_n, n_c=C,
        ready=xg["ready"][b], pen=xg["pen"][b]) for b in range(Bk)], 2,
        k3_restore)
    # K2: flow state, rates and dates read, flow state and mask written
    k2_bytes = (nbytes(xg["pen"], xg["rem"], xg["thr"], xg["ready"])
                + Bk * V * 8 + 2 * nbytes(xg["pen"]) + Bk * V)
    kernels.append(dict(
        name="drain_advance_event_fleet_coll", route="cuda",
        source="simgrid_tpu_torch/csrc/drain_advance.cu",
        replaces="simgrid_tpu/ops/lmm_batch.py:508",
        launches=c18["drain_advance_event_fleet"], max_abs_err=err2,
        ms=k2_ms, plain_ms=k2_plain, bound_ms=bound_ms(k2_bytes),
        bound_by="bytes", library_ms=None, replicas=Bk, flows=V,
        launches_from="main path 11 (the 1,024-rank collective fleet)"))
    log({"phase": "kernel", **kernels[-1]})
    # K3: the masks and dates read, the ids of the flows that complete
    # or activate; per completion a ring entry, per activation a ring
    # entry, a penalty and a date written
    k3_bytes = (Bk * V + nbytes(xg["ready"])
                + ids_bytes(wc.done, torch.isfinite(ready0)) + n_done * 16
                + n_act * 32)
    kernels.append(dict(
        name="superstep_commit_coll_fleet", route="cuda",
        source="simgrid_tpu_torch/csrc/superstep_commit.cu",
        replaces="simgrid_tpu/ops/lmm_batch.py:508",
        launches=c18["superstep_commit_coll_fleet"], max_abs_err=err3,
        ms=k3_ms, plain_ms=k3_plain, bound_ms=bound_ms(k3_bytes),
        bound_by="bytes", library_ms=None, replicas=Bk, activations=n_act,
        launches_from="main path 11 (the 1,024-rank collective fleet)"))
    log({"phase": "kernel", **kernels[-1]})

    # K10's replica arm: every replica's roots complete in one advance,
    # at a clock that differs per replica
    es, ed, ex = (torch.from_numpy(a.copy()) for a in (
        dc.edge_src, dc.edge_dst, dc.exec_cost))
    edges_g = [t.to(cuda) for t in (es, ed, ex)]
    # the out-edge CSR, built once per schedule as the drains build it
    edges_g.append(dag_csr(*edges_g[:2], V))
    csr_c = dag_csr(es, ed, V)
    roots = torch.from_numpy(dc.penalty0 > 0)
    pred0 = torch.from_numpy(dc.pred0.copy())
    walk = {}

    def k10_setup(k):
        d = dict(cuda=cuda, cpu=cpu)[k]
        w = works[k]
        w.ctrl[:, ADV_OK] = 1
        w.ctrl[:, PENDING] = 0
        w.fctrl[:, T_SUM] = torch.arange(1, Bk + 1, dtype=f64) * 1e-3
        w.done.copy_(roots.expand(Bk, V))
        walk[k] = dict(pred=pred0.to(d).repeat(Bk, 1),
                       ready=torch.full((Bk, V), float("inf"), dtype=f64,
                                        device=d))
    for k in ("cuda", "cpu"):
        k10_setup(k)
    dag_walk(wg, *edges_g[:2], walk["cuda"]["pred"], walk["cuda"]["ready"],
             *edges_g[2:])
    dag_walk(wc, es, ed, walk["cpu"]["pred"], walk["cpu"]["ready"], ex,
             csr_c)
    torch.cuda.synchronize()
    err10 = max(diff(walk["cuda"]["pred"], walk["cpu"]["pred"]),
                diff(walk["cuda"]["ready"], walk["cpu"]["ready"]),
                diff(wg.ctrl[:, PENDING], wc.ctrl[:, PENDING]))
    freed = int(wc.ctrl[:, PENDING].sum())
    if err10 != 0.0 or freed <= 0:
        raise AssertionError(f"K10's replica arm differs from its plain "
                             f"version ({err10}) or freed nothing")
    k10_ms = events_ms(lambda: dag_walk(
        wg, *edges_g[:2], walk["cuda"]["pred"], walk["cuda"]["ready"],
        *edges_g[2:]), 20, lambda: k10_setup("cuda"))
    k10_t = time_call(lambda: dag_walk(
        wg, *edges_g[:2], walk["cuda"]["pred"], walk["cuda"]["ready"],
        *edges_g[2:]), lambda: k10_setup("cuda"))
    k10_plain = events_ms(lambda: [dag_walk_plain(
        wg.replica(b), edges_g[3], walk["cuda"]["pred"][b],
        walk["cuda"]["ready"][b], edges_g[2]) for b in range(Bk)], 2,
        lambda: k10_setup("cuda"))
    keep = edges_g[1] < V
    src, dst = edges_g[0][keep].long(), edges_g[1][keep].long()
    flat_dst = (dst[None, :] + V * torch.arange(Bk, device=cuda)[:, None]
                ).reshape(-1)
    dec = (-wg.done[:, src].to(torch.int32)).reshape(-1)

    def k10_lib_fn():
        walk["cuda"]["pred"].view(-1).index_add_(0, flat_dst, dec)
    k10_lib_paced = events_ms(k10_lib_fn, 20, lambda: k10_setup("cuda"))
    k10_lib = time_call(k10_lib_fn, lambda: k10_setup("cuda"))["ms"]
    n_dec = Bk * int(roots[es[ed < V].long()].sum())
    # the shared edge list read once, each replica's done flag of every
    # edge source once; per decrement a count read and written; per freed
    # flow a cost read and a date written
    k10_bytes = (nbytes(es, ed) + Bk * int(torch.unique(es).numel())
                 + n_dec * 8 + freed * 16)
    kernels.append(dict(
        name="dag_walk_fleet", route="cuda",
        source="simgrid_tpu_torch/csrc/dag_walk.cu",
        replaces="simgrid_tpu/ops/lmm_batch.py:479",
        launches=c18["dag_walk_fleet"], max_abs_err=err10,
        ms=k10_t["ms"], paced_ms=k10_ms, queued=k10_t["queued"],
        plain_ms=k10_plain, bound_ms=bound_ms(k10_bytes), bound_by="bytes",
        library_ms=k10_lib, library_paced_ms=k10_lib_paced,
        library="a partial yardstick: index_add_ of every replica's "
                "decrements on int32, the walk's counts without its freed "
                "dates (one call)", replicas=Bk, edges=dc.n_edges,
        decrements=n_dec,
        freed=freed,
        launches_from="main path 11 (the 1,024-rank collective fleet)"))
    log({"phase": "kernel", **kernels[-1]})

    # K11's admission of row 1 of the collective fleet (state, tape row,
    # DAG-walk rows) from its rows mid-walk (counts down by one, dates
    # set, a clock running), card against plain on copies of the rows
    gk = plan.executor(specs)
    ovk = plan.overrides_for(fresh)
    payk = _pack_overrides([ovk], gk.n_c, gk.n_v, tuple(
        _pow2_bucket(len(x)) for x in (ovk.link_scale, ovk.flow_scale,
                                       ovk.dead_flows)))
    tk = plan.tape_for(fresh)
    rowk = (np.zeros(0), np.zeros(0, np.int32), np.zeros(0))
    if tk is not None and len(tk[0]):
        rowk = (np.asarray(tk[0], np.float64), np.asarray(tk[1], np.int32),
                np.asarray(tk[2], np.float64))
    mid = (gk._coll[0] - 1, torch.full_like(gk._coll[1], 0.25),
           torch.full_like(gk._coll[2], 0.5))
    ka = {k: dict(base=[t.to(d) for t in gk._base_dev],
                  out=[t.to(d, copy=True) for t in (
                      gk.sys.c_bound, gk._pen, gk._rem, gk._thresh)],
                  tape=[t.to(d, copy=True) for t in gk._tape]
                  if gk.has_tape else None,
                  coll=[t.to(d, copy=True) for t in mid],
                  rows=[t.to(d) for t in gk._coll_base])
          for k, d in (("cuda", cuda), ("cpu", cpu))}
    del gk

    def admit_k(dev, plain=False):
        a = ka[dev]
        (k11.admit_plain if plain else k11.admit)(
            a["base"], payk, a["out"], 1, 1e-4, True,
            tape=None if a["tape"] is None else (a["tape"], rowk),
            coll=(a["coll"], a["rows"]))
    admit_k("cuda")
    admit_k("cpu")
    torch.cuda.synchronize()
    outs_k = {k: [*a["out"], *(a["tape"] or ()), *a["coll"]]
              for k, a in ka.items()}
    err11 = max(diff(a, b) for a, b in zip(outs_k["cuda"], outs_k["cpu"]))
    if err11 != 0.0 or float(ka["cpu"]["coll"][2][1].abs().sum()) != 0.0:
        raise AssertionError(f"K11's collective admission differs from "
                             f"its plain version ({err11})")
    a_nodes = launch_gate("K11 (collective admission)", k16.kernel_nodes(
        lambda: admit_k("cuda")), K11_ADMIT_LAUNCHES, exact=True)
    a_ms = events_ms(lambda: admit_k("cuda"), 20)
    a_t = time_call(lambda: admit_k("cuda"))
    a_plain = events_ms(lambda: admit_k("cuda", plain=True), 20)
    idx1 = torch.tensor([1], device=cuda)
    ready_g, ready0_g = ka["cuda"]["coll"][1], ka["cuda"]["rows"][1]

    def a_lib_fn():
        ready_g.index_put_((idx1,), ready0_g[None])
    a_lib_paced = events_ms(a_lib_fn, 20)
    a_lib = time_call(a_lib_fn)["ms"]
    # the base and birth rows read once, the replica's rows, tape row
    # and clock pair written once
    a_bytes = (nbytes(*ka["cuda"]["base"]) + sum(a.nbytes for a in payk)
               + sum(a.nbytes for a in rowk)
               + (nbytes(*(t[1] for t in ka["cuda"]["tape"]))
                  if ka["cuda"]["tape"] is not None else 0)
               + sum(nbytes(t[1]) for t in ka["cuda"]["out"])
               + 2 * nbytes(*ka["cuda"]["rows"]) + 16)
    kernels.append(dict(
        name="fleet_admit_coll", route="cuda",
        source="simgrid_tpu_torch/csrc/fleet_materialize.cu",
        replaces="simgrid_tpu/ops/lmm_batch.py:453",
        launches=c18["fleet_admit_coll"], max_abs_err=err11,
        ms=a_t["ms"], paced_ms=a_ms, queued=a_t["queued"],
        plain_ms=a_plain, bound_ms=bound_ms(a_bytes), bound_by="bytes",
        library_ms=a_lib, library_paced_ms=a_lib_paced,
        library="a partial yardstick: index_put_ of the admitted row of "
                "the dates, one of the admission's writes (one call)",
        birth_launches=c18["fleet_materialize_coll"],
        cuda_launches_per_call=a_nodes,
        launches_from="main path 11 (one admission: its state, tape and "
                      "DAG-walk rows in one launch; the birth of every "
                      "row is fleet_materialize_coll)"))
    log({"phase": "kernel", **kernels[-1]})
    del ka
    del works, walk, st
    torch.cuda.empty_cache()
    return camp


def probe_phase(ctx: dict) -> None:
    """Phase 19 (module docstring): the op-cost probe, P1-P8 on K12-K15,
    its launches, every arm held against its plain version, and the four
    kernel rows.  ``ctx`` carries main's helpers and output directory."""
    import numpy as np
    import torch
    from simgrid_tpu_torch.kernels import launch_counts, reset_launch_counts
    from simgrid_tpu_torch.kernels import probe_gather as k12
    from simgrid_tpu_torch.kernels import build
    from simgrid_tpu_torch.kernels import probe_loop as k15
    from simgrid_tpu_torch.kernels import probe_scan as k14
    from simgrid_tpu_torch.kernels import superstep_loop as k16
    from simgrid_tpu_torch.kernels import probe_segsum as k13
    from simgrid_tpu_torch.probes import data
    from simgrid_tpu_torch.probes.common import reorder_tol, torch_dtype
    from simgrid_tpu_torch.probes.opcost import run_opcost
    from simgrid_tpu_torch.probes.scaling import run_scaling
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    events_ms, diff, kernels, report = (ctx[k] for k in (
        "events_ms", "diff", "kernels", "report"))
    t0 = time.perf_counter()

    # (a) the probe through its entry points, launches counted
    reset_launch_counts()
    runs = [run_opcost(cuda), run_scaling(cuda)]
    counts = {k: v for k, v in launch_counts().items()
              if k.startswith("probe_") or k == "superstep_loop_probe"}
    rows = [r for run in runs for r in run["rows"]]
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"phase 19: {len(bad)} probe rows failed "
                             f"their check: {bad[:3]}")
    arms = {"probe_gather": k12.ARMS, "probe_segsum": k13.ARMS,
            "probe_scan": k14.ARMS, "probe_loop": k15.ARMS}
    # the cond arm's graph launches count under K16's probe kind
    names = [k15.COUNTS[a].name if k == "probe_loop" else f"{k}_{a}"
             for k, al in arms.items() for a in al] + ["probe_double"]
    idle = [n for n in names if counts.get(n, 0) == 0]
    if idle:
        raise AssertionError(f"phase 19: {idle} never launched")
    a_s = time.perf_counter() - t0
    with open(os.path.join(ctx["out_dir"], "torch_opcost.jsonl"), "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")

    # (b) every arm against its plain version on the host CPU, on the
    # same inputs at the tools' full shapes, in both dtypes
    d1, d3 = data.pallas_probe(), data.pallas_gather3()
    C1, C3 = d1["C"], d3["C"]
    held, errs = {}, {k: 0.0 for k in arms}

    def hold(kernel, label, got, want, tol=None):
        got = got.cpu()
        err = diff(got, want)
        errs[kernel] = max(errs[kernel], err)
        if tol is None:
            ok = err == 0.0
        else:
            g, w = got.double().numpy(), want.double().numpy()
            ok = bool(np.all(np.abs(g - w) <= tol))
        held[label] = ok
        if not ok:
            raise AssertionError(f"phase 19: {label} differs from its "
                                 f"plain version ({err})")

    idx_c = torch.from_numpy(d1["idx"])
    idx_g = idx_c.to(cuda)
    csr = k13.segment_csr(idx_g, C1)
    terms = np.maximum(np.bincount(d1["idx"].ravel(), minlength=C1), 1)
    for name in ("float32", "float64"):
        dt = torch_dtype(name)
        tab_c = torch.from_numpy(data.as_dtype(d1["tab"], dt))
        w_c = torch.from_numpy(data.as_dtype(d1["w"], dt))
        tab_g, w_g = tab_c.to(cuda), w_c.to(cuda)
        want = k12.probe_gather_plain(tab_c, idx_c)
        for arm in k12.ARMS:
            hold("probe_gather", f"K12 {arm} {name}",
                 k12.probe_gather(tab_g, idx_g, arm), want)
        want = k13.probe_segsum_plain(idx_c, w_c, C1)
        tol = reorder_tol(want.numpy(), terms, dt)
        for arm in k13.ARMS:
            hold("probe_segsum", f"K13 {arm} {name}",
                 k13.probe_segsum(idx_g, w_g, C1, arm, csr=csr), want,
                 None if arm == "inorder" else tol)
        hold("probe_segsum", f"K13 inorder min {name}",
             k13.probe_segsum(idx_g, w_g, C1, "inorder", "min", csr),
             k13.probe_segsum_plain(idx_c, w_c, C1, "min"))
        x_c = torch.from_numpy(data.as_dtype(d3["w_cum"], dt))
        x_g = x_c.to(cuda)
        for op in k14.OPS:
            want = k14.probe_scan_plain(x_c, op)
            tol = reorder_tol(want.numpy(), np.arange(1, C3 + 1), dt) \
                if op == "sum" else None
            for arm in k14.ARMS:
                hold("probe_scan", f"K14 {arm} {op} {name}",
                     k14.probe_scan(x_g, arm, op), want,
                     tol if arm == "block" else None)
        want = k15.probe_loop_plain(tab_c, idx_c)
        for arm in k15.ARMS:
            hold("probe_loop", f"K15 {arm} {name}",
                 k15.probe_loop(tab_g, idx_g, arm=arm), want)
        x8 = torch.ones((256, 128), dtype=dt)
        hold("probe_loop", f"P8 probe_double {name}",
             k15.probe_double(x8.to(cuda)), k15.probe_double_plain(x8))
    torch.cuda.synchronize()

    # (c) the kernel rows: each kernel's float32 row at its probe's
    # shape (the tools' dtype), every arm and dtype beside it; the plain
    # version timed on the card at the same shape
    def pick(probe, name, dtype="float32"):
        return [r for r in rows if r["probe"] == probe and r["name"] == name
                and r["dtype"] == dtype]

    def arm_list(kernel_rows):
        return [{k: r[k] for k in ("probe", "name", "arm", "dtype", "ms",
                                   "paced_ms", "enqueue_us", "bound_ms",
                                   "library_ms", "max_abs_err")}
                for r in kernel_rows]
    tab32 = torch.from_numpy(data.as_dtype(d1["tab"], torch.float32)) \
        .to(cuda)
    w32 = torch.from_numpy(data.as_dtype(d1["w"], torch.float32)).to(cuda)
    x32 = torch.from_numpy(data.as_dtype(d3["w_cum"], torch.float32)) \
        .to(cuda)
    plain_ms = {
        "probe_gather": events_ms(lambda: k12.probe_gather_plain(
            tab32, idx_g), 10),
        "probe_segsum": events_ms(lambda: k13.probe_segsum_plain(
            idx_g, w32, C1, csr=csr), 3),
        "probe_scan": events_ms(lambda: k14.probe_scan_plain(x32), 1),
        "probe_loop": events_ms(lambda: k15.probe_loop_plain(tab32, idx_g),
                                3)}
    # (kernel, its probe, its row at the tools' shape, main arm, the TPU
    # kernel, the rows listed beside it: every arm and dtype there)
    spec = [
        ("probe_gather", "pallas_probe", "P1_gather", "global",
         "tools/tpu_pallas_probe.py:59", ("P1_gather",)),
        ("probe_segsum", "pallas_probe", "P2_segsum", "inorder",
         "tools/tpu_pallas_probe.py:80", ("P2_segsum",)),
        ("probe_scan", "pallas_gather3", "P6_cumsum_axis1", "seq",
         "tools/tpu_pallas_gather3.py:93", ("P6_cumsum_axis1",)),
        ("probe_loop", "pallas_probe", "P3_loop16", "coop",
         "tools/tpu_pallas_probe.py:105", ("P3_loop16", "P8_double"))]
    for kernel, probe, main_name, main_arm, replaces, listed in spec:
        main = [r for r in pick(probe, main_name) if r["arm"] == main_arm][0]
        own = [r for r in rows if r["name"] in listed]
        mine = {k: v for k, v in counts.items() if k.startswith(kernel)
                or (kernel == "probe_loop" and k == "probe_double")}
        row = dict(
            name=kernel, route="cuda",
            source=f"simgrid_tpu_torch/csrc/{kernel}.cu", replaces=replaces,
            launches=sum(mine.values()), launch_counts=mine,
            max_abs_err=errs[kernel], ms=main["ms"],
            plain_ms=plain_ms[kernel], bound_ms=main["bound_ms"],
            bound_by="bytes", library_ms=main["library_ms"],
            library=main["library"],
            main_row=f"{probe} {main_name} {main_arm} float32",
            arms=arm_list(own),
            launches_from="phase 19 (the op-cost probe; on no main path)")
        if kernel == "probe_loop":
            launch = [r for r in pick(probe, main_name)
                      if r["arm"] == "launch"][0]
            row["yardstick_ms"] = launch["ms"]
            row["yardstick"] = "the launch arm (16 launches of one round)"
        kernels.append(row)
        log({"phase": "kernel", **{k: v for k, v in row.items()
                                   if k != "arms"}})
    # K15's cond arm: the same rounds as one graph of a conditional WHILE
    # node (the mechanism K16 runs the port's loops on), beside the graph
    # arm's replayed launches
    cond = [r for r in pick("pallas_probe", "P3_loop16")
            if r["arm"] == "cond"][0]
    graph = [r for r in pick("pallas_probe", "P3_loop16")
             if r["arm"] == "graph"][0]
    kernels.append(dict(
        name="probe_loop_cond", route="cuda",
        source="simgrid_tpu_torch/csrc/probe_loop.cu",
        replaces="tools/tpu_pallas_probe.py:105",
        launches=counts.get("superstep_loop_probe", 0),
        max_abs_err=errs["probe_loop"], ms=cond["ms"],
        paced_ms=cond["paced_ms"], plain_ms=plain_ms["probe_loop"],
        bound_ms=cond["bound_ms"], bound_by="bytes",
        library_ms=cond["library_ms"], yardstick_ms=graph["ms"],
        yardstick="the graph arm (16 captured launches, replayed)",
        main_row="pallas_probe P3_loop16 cond float32",
        launches_from="phase 19 (the op-cost probe; on no main path): "
                      "graph launches, 16 rounds each"))
    log({"phase": "kernel", **kernels[-1]})
    rt, drv = k16.versions()
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True).stdout
    rec = {"phase": "opcost_probe", "rows": len(rows), "a_s": a_s,
           "cuda_runtime": rt, "cuda_driver": drv,
           "nvcc": nvcc.strip().splitlines()[-2:],
           "sync_ms": runs[0]["sync_ms"], "launches": counts,
           "held": all(held.values()), "n_held": len(held),
           "wall_s": time.perf_counter() - t0,
           "columns": ["probe", "name", "arm", "dtype", "ms", "paced_ms",
                       "enqueue_us", "bound_ms", "library_ms"],
           "table": [[r["probe"], r["name"], r["arm"], r["dtype"],
                      r["ms"], r["paced_ms"], r["enqueue_us"], r["bound_ms"],
                      r["library_ms"]] for r in rows]}
    log(rec)
    report["opcost_probe"] = {**rec, "rows": rows, "held": held}

#: the pipeline depth phase 20 holds against depth 0
PIPE_DEPTH = 2
#: kernels every pipelined run of a path must launch (path counts)
PIPE_KERNELS = {
    1: ("superstep_loop_superstep", "superstep_reset", "superstep_finish",
        "lmm_round", "drain_advance", "superstep_commit"),
    8: ("superstep_loop_superstep", "superstep_reset", "superstep_finish",
        "lmm_round", "drain_advance_event", "superstep_commit_tape"),
    10: ("superstep_loop_superstep_fleet", "superstep_reset_fleet",
         "superstep_finish_fleet", "lmm_round_fleet",
         "drain_advance_event_fleet", "superstep_commit_tape_fleet"),
    11: ("superstep_loop_superstep_fleet", "superstep_reset_fleet",
         "superstep_finish_fleet", "lmm_round_fleet",
         "drain_advance_event_fleet", "superstep_commit_coll_fleet",
         "dag_walk_fleet"),
}


def pipeline_phase(ctx: dict) -> None:
    """Phase 20 (module docstring): main paths 1, 8, 10 and 11 at
    pipeline depths 0 and ``PIPE_DEPTH``, equal by bits, with walls,
    busy shares, blocking fetches per advance, commit rates and graph
    builds, then ``bench.py``'s pipeline stage on the card."""
    import torch
    from simgrid_tpu_torch.kernels import path_counts, reset_launch_counts
    from simgrid_tpu_torch.ops import opstats
    from simgrid_tpu_torch.ops.lmm_batch import BatchDrainSim
    from simgrid_tpu_torch.ops.lmm_drain import DrainSim
    from simgrid_tpu_torch.workloads import fault_drain, fleet_run
    from simgrid_tpu_torch.workloads import pipeline as pl
    from simgrid_tpu_torch.workloads.drain_run import run_drain
    cuda = torch.device("cuda")
    dsys, tape13, report = ctx["dsys"], ctx["tape13"], ctx["report"]
    spans, t0_bits = [], []

    check_t0 = [False]

    def checked(orig):
        # the base clock of the speculative superstep behind the one just
        # collected, derived on the card, against the clock the host's
        # collect left (whether that superstep then commits or not); the
        # fetch of the derived clock syncs, so this run is not timed
        def collect(sim, tok):
            out = orig(sim, tok)
            nxt = sim._carries.inflight[0] if sim._carries.inflight else None
            if check_t0[0] and nxt is not None and nxt.speculative:
                t0_bits.append(float(nxt.t0[0]) == sim.t)
            return out
        return collect

    saved = [(DrainSim, "_superstep_collect", DrainSim._superstep_collect)]
    DrainSim._superstep_collect = checked(saved[0][2])

    def drain(path, depth):
        """One run of a path: (sim, its lanes' records, its row)."""
        spans.clear()
        kind = "superstep" if path in (1, 8) else "superstep_fleet"
        with opstats.scoped(f"pipeline/path{path}-d{depth}") as st, \
                timed_graphs(kind, spans):
            if path == 1:
                sim, row = run_drain(dsys, device=cuda, superstep=K,
                                     pipeline=depth)
            elif path == 8:
                sim, row = fault_drain.run_fault_drain(
                    dsys, tape13, device=cuda, superstep=K, pipeline=depth)
            else:
                camp = ctx["camp16"] if path == 10 else ctx["camp18"]
                sim, row = fleet_run.run_fleet_full(camp, pipeline=depth)
        torch.cuda.synchronize()
        busy_s = sum(a.elapsed_time(b) for a, b in spans) / 1e3
        run_s = row["wall_s"] - row.get("executor_s", 0.0)
        if path in (1, 8):
            lanes = [(sim.events, sim.fault_events, sim.collective_events,
                      sim.t)]
            adv = sim.advances
        else:
            lanes = [(r.events, r.fault_events, r.collective_events, r.t,
                      sim.collective_clock_of(b) if sim.has_coll else None)
                     for b, r in enumerate(sim.replicas)]
            adv = sum(r.advances for r in sim.replicas)
        missing = [k for k in PIPE_KERNELS[path]
                   if row["launches"].get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"main path {path} at pipeline={depth}: "
                                 f"{missing} never launched")
        blocking = int(st.get("blocking_fetches", 0))
        rec = dict(depth=depth, wall_s=row["wall_s"], run_s=run_s,
                   busy_s=busy_s, busy_share=busy_s / run_s,
                   supersteps=sim.supersteps, advances=adv,
                   fetches=int(st.get("fetches", 0)),
                   blocking_fetches=blocking,
                   blocking_per_advance=blocking / max(adv, 1),
                   host_block_ms=float(st.get("host_block_ms", 0.0)),
                   spec_issued=sim.spec_issued,
                   spec_committed=sim.spec_committed,
                   spec_rolled_back=sim.spec_rolled_back,
                   commit_rate=(sim.spec_committed / sim.spec_issued
                                if sim.spec_issued else None),
                   loop_builds=sim.loop_builds,
                   repacks=getattr(sim, "repacks", 0))
        del sim
        torch.cuda.empty_cache()
        return lanes, rec

    t_phase = time.perf_counter()
    paths = {}
    try:
        # path 10 runs at depth 0 only (its wall and busy share): the
        # fleet's pipelined run is held by path 11 at PIPE_DEPTH (the same
        # BatchDrainSim loop) and by tests/test_torch_pipeline.py
        for path, order in ((1, (0, PIPE_DEPTH, PIPE_DEPTH, 0)),
                            (8, (0, PIPE_DEPTH)),
                            (10, (0,)),
                            (11, (0, PIPE_DEPTH, PIPE_DEPTH, 0))):
            runs = [drain(path, d) for d in order]
            if path == 8:
                check_t0[0] = True
                runs.append(drain(path, PIPE_DEPTH))
                check_t0[0] = False
                runs[-1][1]["derived_t0_checked_run"] = True
            if len(runs) == 1:
                paths[path] = dict(runs=[runs[0][1]])
                continue
            lanes0 = runs[0][0]
            for lanes, rec in runs[1:]:
                if lanes != lanes0:
                    raise AssertionError(
                        f"main path {path} at pipeline={rec['depth']} "
                        "differs from pipeline=0")
            d0 = [r for _, r in runs if r["depth"] == 0]
            dp = [r for _, r in runs if r["depth"] == PIPE_DEPTH]
            most = d0[0]["loop_builds"] + (PIPE_DEPTH + 1) * (
                1 + dp[0]["repacks"])
            # path 8 fires nearly every superstep: its speculation is
            # issued and discarded, committed only where none fired
            if dp[0]["loop_builds"] > most or not dp[0]["spec_issued"] or (
                    path != 8 and not dp[0]["spec_committed"]):
                raise AssertionError(
                    f"main path {path}: {dp[0]['loop_builds']} graphs built "
                    f"at depth {PIPE_DEPTH} (at most {most}), "
                    f"{dp[0]['spec_issued']} speculations issued, "
                    f"{dp[0]['spec_committed']} committed")
            paths[path] = dict(runs=[r for _, r in runs],
                               equal_by_bits=True, loop_builds_most=most)
    finally:
        for cls, name, orig in saved:
            setattr(cls, name, orig)
    if not t0_bits or not all(t0_bits):
        raise AssertionError(f"main path 8: {t0_bits.count(False)} of "
                             f"{len(t0_bits)} derived base clocks differ "
                             "from the host's")
    stage = pl.run_stage(cuda)
    bad = {k: v for k, v in stage["mismatches"].items() if v}
    if bad or not stage["events_consistent"]:
        raise AssertionError(f"bench.py's pipeline stage on the card: {bad}, "
                             f"events consistent {stage['events_consistent']}")
    rec = {"phase": "main_path_pipeline", "card": ctx["smi"],
           "depth": PIPE_DEPTH, "paths": paths,
           "path8_derived_t0_checked": len(t0_bits),
           "stage_rows": stage["rows"], "phase_s": time.perf_counter()
           - t_phase}
    log({k: v for k, v in rec.items() if k != "stage_rows"})
    log({"phase": "main_path_pipeline_stage", "card": ctx["smi"],
         "rows": [{k: r[k] for k in (
             "workload", "depth", "advances", "supersteps", "fetches",
             "blocking_fetches", "blocking_per_advance", "host_block_ms",
             "wall_ms", "spec_issued", "spec_committed", "spec_rolled_back",
             "loop_builds")} for r in stage["rows"]]})
    report["main_path_pipeline"] = rec


#: phase 21: main path 12's flows at the reduced width, run through the
#: engine on the card and on the CPU
ENGINE_REDUCED_FLOWS = 10_000
#: advances of main path 12's first held superstep (the first after the
#: latency phase: each advance at the full population takes the plain
#: path on the CPU about 3 s)
HELD_FIRST_K = 1
#: main path 12's late held superstep: the first after the started flows
#: fall below this share of the flows, or below twice the fast path's
#: ``drain/min-flows`` (under it a plan the view's compaction drops is not
#: rebuilt), whichever is more
HELD_LATE_SHARE = 0.05
#: main path 13, ``bench.py:913`` ``stage_phase`` at its recorded size on
#: the 64-host fat tree
NAS_RANKS, NAS_ROUNDS, NAS_SEED = 64, 4, 7
NAS_CFG = ("drain/fastpath:auto", "drain/min-flows:32", "drain/superstep:16")
#: the device row of ``bench_results/lmm_phase.jsonl`` (stage_phase with
#: the JAX package's backend on the CPU), under the opstats names
NAS_RECORDED = dict(events=512, fastpath_advances=589, native_advances=93,
                    drain_transitions=340, drain_transition_slots=9546,
                    drain_cause_transition=340,
                    drain_cause_partial_advance=375,
                    drain_cause_profile_event=0, drain_cause_stall=0,
                    drain_cause_unrecognized=9)
#: kernels main path 12 must launch (its supersteps, K1's bound-first arm,
#: K5's transition batches)
ENGINE_KERNELS = ("superstep_loop_superstep", "superstep_reset",
                  "superstep_finish", "lmm_round_bounds", "drain_advance",
                  "superstep_commit", "transition_scatter")
#: the opstats counters an engine run reports
ENGINE_STATS = ("fastpath_advances", "native_advances", "drain_transitions",
                "drain_transition_slots", "drain_cause_transition",
                "drain_cause_partial_advance", "drain_cause_profile_event",
                "drain_cause_stall", "drain_cause_unrecognized",
                "speculations_issued", "speculations_committed",
                "speculations_rolled_back", "phase_pure_drain")


def engine_flows_system(actions):
    """Per flow, as the engine posted it: the link name, weight and
    constraint bound of each element in order, the penalty its latency's
    end installs (``NetworkAction.effective_penalty``) and its rate
    bound."""
    out = []
    for a in actions:
        v = a.variable
        out.append(([(el.constraint.id.name, el.consumption_weight,
                      el.constraint.bound) for el in v.cnsts],
                     a.effective_penalty, v.bound))
    return out


def generator_flows_system(gen, names):
    """The same per-flow records from ``dragonfly.build_system``'s arrays
    (``names``: the link name of each constraint)."""
    import numpy as np
    ev = gen.e_var
    start = np.searchsorted(ev, np.arange(len(gen.sizes) + 1))
    out = []
    for k in range(len(gen.sizes)):
        lo, hi = start[k], start[k + 1]
        cs = gen.e_cnst[lo:hi]
        out.append(([(names[c], float(w), float(gen.c_bound[c]))
                     for c, w in zip(cs.tolist(), gen.e_w[lo:hi].tolist())],
                    float(gen.v_penalty[k]), float(gen.v_bound[k])))
    return out


def engine_run(dev, platform, flows, posted=None, hook=None, spans=None):
    """Main path 12's sequence on ``dev``: an engine with config #4's
    flags, the platform parsed, the random flows of
    ``tools/e2e_drain.py:80-87`` posted (1e6 bytes each; then
    ``posted(actions)``, untimed), the launch counts zeroed, the engine
    driven to its end (``hook(e, actions)`` after every advance, outside
    the timed spans; ``spans`` collects CUDA events around each
    superstep graph).  Returns the engine, its row, its events and its
    actions."""
    import torch
    from simgrid_tpu_torch import s4u
    from simgrid_tpu_torch.kernels import path_counts, reset_launch_counts
    from simgrid_tpu_torch.kernels import superstep_loop as k16
    from simgrid_tpu_torch.ops import opstats
    from simgrid_tpu_torch.workloads import dragonfly
    from simgrid_tpu_torch.workloads import engine_run as er
    e, parse_s = er.make_engine(s4u, er.ENGINE_CFG, platform, device=dev)
    n_hosts = e.get_host_count()
    t0 = time.perf_counter()
    actions = er.post_flows(e, dragonfly.flow_pairs(flows, n_hosts), 1e6)
    post_s = time.perf_counter() - t0
    if posted is not None:
        posted(actions)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    reset_launch_counts()
    before = opstats.snapshot()
    lat_stats = []

    def each(e_):
        if not lat_stats and not e_.pimpl.network_model.latency_phase_count:
            lat_stats.append(opstats.diff(before))
        if hook is not None:
            hook(e_, actions)
    ctx = (timed_graphs("superstep", spans) if spans is not None
           and dev.type == "cuda" else contextlib.nullcontext())
    with ctx:
        out = er.drain(e, hook=each)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    stats = opstats.diff(before)
    counts = path_counts()
    loop = k16.summary()
    lat = lat_stats[0] if lat_stats else {}
    after_lat = {k: stats.get(k, 0) - lat.get(k, 0)
                 for k in ("fastpath_advances", "native_advances")}
    row = dict(flows=flows, hosts=n_hosts, parse_s=parse_s, post_s=post_s,
               latency_s=out["latency_s"], drain_s=out["drain_s"],
               hook_s=out["hook_s"], advances=out["advances"],
               clock=out["clock"],
               counters=er.fastpath_counts(e.pimpl.network_model),
               stats={k: stats.get(k, 0) for k in ENGINE_STATS},
               after_latency=after_lat, launches=counts,
               # one K16 graph launch a superstep
               supersteps=loop["graph_launches"].get("superstep", 0),
               graph_launches=loop["graph_launches"],
               graph_builds=loop["graph_builds"])
    return e, row, out["events"], actions


def nas_run(dev, platform):
    """Main path 13: ``stage_phase``'s alternation through the engine on
    ``dev`` (the device mode: config #4's flags with ``NAS_CFG``).
    Returns its row and events."""
    from simgrid_tpu_torch import s4u
    from simgrid_tpu_torch.kernels import path_counts, reset_launch_counts
    from simgrid_tpu_torch.ops import opstats
    from simgrid_tpu_torch.utils.config import config
    from simgrid_tpu_torch.workloads import engine_run as er
    with config.scoped():
        e, _ = er.make_engine(s4u, er.ENGINE_CFG + NAS_CFG, platform,
                              device=dev)
        reset_launch_counts()
        before = opstats.snapshot()
        events, clock, wall = er.run_alternation(e, NAS_RANKS, NAS_ROUNDS,
                                                 NAS_SEED)
        stats = opstats.diff(before)
        row = dict(events=len(events), clock=clock, wall_s=wall,
                   counters=er.fastpath_counts(e.pimpl.network_model),
                   stats={k: stats.get(k, 0) for k in ENGINE_STATS},
                   launches=path_counts())
    s4u.Engine._reset()
    return row, events


def engine_phase(ctx: dict) -> None:
    """Phase 21 (module docstring): main paths 12 and 13 through
    ``s4u.Engine``."""
    import gc
    import torch
    from simgrid_tpu_torch import s4u
    from simgrid_tpu_torch.utils.config import config
    from simgrid_tpu_torch.workloads import dragonfly
    from simgrid_tpu_torch.workloads import engine_run as er
    from simgrid_tpu_torch.workloads.drain_run import (check_events,
                                                       held_from,
                                                       held_handover)
    cuda, cpu = ctx.get("cuda", torch.device("cuda")), torch.device("cpu")
    report, smi = ctx["report"], ctx["smi"]
    flows = ctx.get("flows", FLOWS)
    reduced = ctx.get("reduced_flows", ENGINE_REDUCED_FLOWS)
    build = os.path.join(HERE, "build")
    plat = er.write_platform(os.path.join(build, "engine_dragonfly.xml"),
                             "dragonfly", ctx.get("topology",
                                                  er.DRAGONFLY_TOPOLOGY))
    t_phase = time.perf_counter()

    # ---- main path 12: config #4's flows through the engine, full width
    held, checked, spans = [], {}, []
    topo = ctx.get("topology", dragonfly.TOPOLOGY)

    def posted(actions):
        # every flow's elements, latency-end penalty and rate bound as the
        # engine built them, against dragonfly.build_system's by bits
        t0 = time.perf_counter()
        gen = dragonfly.build_system(flows, lv08=True, topology=topo)
        got = engine_flows_system(actions)
        want = generator_flows_system(gen, dragonfly.link_names(gen, topo))
        bad = [k for k in range(flows) if got[k] != want[k]]
        checked["system"] = dict(flows=flows, differ=len(bad),
                                 elements=int(len(gen.e_var)),
                                 check_s=time.perf_counter() - t0)
        checked["penalty"] = [p for _, p, _ in got]
        if bad:
            raise AssertionError(f"main path 12: {len(bad)} flows' systems "
                                 "differ from dragonfly.build_system "
                                 f"(first {bad[:5]})")

    def hook(e, actions):
        model = e.pimpl.network_model
        if model.latency_phase_count:
            return
        if "latency_end" not in checked:
            # the penalty installed at each live flow's latency end
            pen = checked.pop("penalty")
            live = [(a.variable.sharing_penalty, pen[k])
                    for k, a in enumerate(actions)
                    if a.variable is not None]
            bad = sum(1 for g, w in live if g != w)
            checked["latency_end"] = dict(live=len(live), differ=bad)
            if bad:
                raise AssertionError(f"main path 12: {bad} flows' penalties "
                                     "after the latency phase differ")
            return
        sim = model.drain_fastpath.sim
        if sim is None:
            return
        live = len(model.started_action_set)
        late = max(HELD_LATE_SHARE * flows, 2 * config["drain/min-flows"])
        if not held:
            held.append(held_handover(sim, HELD_FIRST_K))
        elif len(held) == 1 and live < late:
            held.append(held_handover(sim))

    with config.scoped():
        e, row12, events12, actions = engine_run(cuda, plat, flows, posted,
                                                 hook, spans)
        check_events(events12, flows)
        if events12 and events12[-1][0] != row12["clock"]:
            raise AssertionError("main path 12: the final clock is not the "
                                 "last event's")
        del actions, e
    s4u.Engine._reset()
    gc.collect()
    torch.cuda.empty_cache()
    busy_s = sum(a.elapsed_time(b) for a, b in spans) / 1e3
    counts = row12["launches"]
    missing = [k for k in ENGINE_KERNELS if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"main path 12: {missing} never launched")
    if row12["after_latency"]["fastpath_advances"] <= 0:
        raise AssertionError("main path 12: the fast path served no advance "
                             "after the latency phase")
    if len(held) != 2:
        raise AssertionError(f"main path 12: {len(held)} supersteps held, "
                             "not 2")
    windows = [held_from(h) for h in held]
    del held
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"phase": "main_path_engine", "card": smi, **row12,
           "busy_s": busy_s,
           "busy_share": busy_s / (row12["latency_s"] + row12["drain_s"]),
           "system_check": checked.get("system"), "held_windows": windows}
    log({k: v for k, v in rec.items() if k != "launches"})
    report["main_path_engine"] = rec
    if ctx.get("path12_only"):
        return

    # the same draw at the reduced width: the engine on the card and on
    # the CPU, equal events, clock and counters
    red = {}
    for name, dev in (("cuda", cuda), ("cpu", cpu)):
        with config.scoped():
            _, rrow, rev, _ = engine_run(dev, plat, reduced)
        s4u.Engine._reset()
        gc.collect()
        check_events(rev, reduced)
        red[name] = (rrow, rev)
    (grow, gev), (crow, cev) = red["cuda"], red["cpu"]
    equal = (gev == cev and grow["clock"] == crow["clock"]
             and grow["counters"] == crow["counters"]
             and grow["stats"] == crow["stats"])
    rec = {"phase": "reduced_engine", "flows": reduced, "equal": equal,
           "advances": grow["advances"], "clock": grow["clock"],
           "counters": grow["counters"], "stats": grow["stats"],
           "cuda": {k: grow[k] for k in ("parse_s", "post_s", "latency_s",
                                         "drain_s")},
           "cpu": {k: crow[k] for k in ("parse_s", "post_s", "latency_s",
                                        "drain_s")}}
    log(rec)
    report["reduced_engine"] = rec
    if not equal:
        raise AssertionError("the reduced engine run: card and CPU differ "
                             f"({grow['counters']} / {crow['counters']}, "
                             f"{grow['stats']} / {crow['stats']})")
    del red
    torch.cuda.empty_cache()

    # ---- main path 13: bench.py's stage_phase through the engine -------
    ft = er.write_platform(os.path.join(build, "engine_fat_tree.xml"),
                           "fat_tree")
    nas = {name: nas_run(dev, ft) for name, dev in (("cuda", cuda),
                                                    ("cpu", cpu))}
    (g13, gev13), (c13, cev13) = nas["cuda"], nas["cpu"]
    equal13 = (gev13 == cev13 and g13["clock"] == c13["clock"]
               and g13["counters"] == c13["counters"]
               and g13["stats"] == c13["stats"])
    recorded = {k: (g13["events"] if k == "events" else g13["stats"][k])
                for k in NAS_RECORDED}
    counts13 = g13["launches"]
    rec = {"phase": "main_path_nas", "card": smi, "ranks": NAS_RANKS,
           "rounds": NAS_ROUNDS, "seed": NAS_SEED, "equal_cpu": equal13,
           "cuda_wall_s": g13["wall_s"], "cpu_wall_s": c13["wall_s"],
           "clock": g13["clock"], "counters": g13["counters"],
           "stats": g13["stats"], "recorded": NAS_RECORDED,
           "as_recorded": recorded == NAS_RECORDED,
           "launches": {k: v for k, v in counts13.items() if v}}
    log(rec)
    report["main_path_nas"] = rec
    if not equal13:
        raise AssertionError("main path 13: card and CPU differ")
    for k in ("superstep_loop_superstep", "transition_scatter",
              "drain_forced_advance"):
        if counts13.get(k, 0) <= 0:
            raise AssertionError(f"main path 13: {k} never launched")
    report["engine_phase_s"] = time.perf_counter() - t_phase
    log({"phase": "engine_phase", "card": smi,
         "phase_s": report["engine_phase_s"],
         "path12_launches": {k: v for k, v in counts.items() if v},
         "path13_launches": rec["launches"]})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    from simgrid_tpu_torch.kernels import (build, path_counts,
                                           reset_launch_counts)
    from simgrid_tpu_torch.kernels.common import (IT, LIGHT, LIVE_ACC,
                                                  LmmSystem, Work)
    from simgrid_tpu_torch.kernels import ell_chain as k9
    from simgrid_tpu_torch.kernels.common import OVERFLOW, EllWork
    from simgrid_tpu_torch.kernels.ell_round import (
        ell_init, ell_init_plain, ell_prep, ell_prep_plain, ell_round,
        ell_round_plain, round_runs)
    from simgrid_tpu_torch.kernels import superstep_loop as k16
    from simgrid_tpu_torch.kernels.vc_round import (vc_prep, vc_prep_plain,
                                                    vc_round, vc_round_plain)
    from simgrid_tpu_torch.kernels.warm_init import (warm_init_ell,
                                                     warm_init_ell_plain)
    from simgrid_tpu_torch.kernels.drain_advance import (
        drain_advance, drain_advance_plain, drain_forced_advance,
        drain_forced_advance_plain)
    from simgrid_tpu_torch.kernels.livefirst_repack import (
        livefirst_repack, livefirst_repack_plain)
    from simgrid_tpu_torch.kernels.lmm_round import (
        lmm_init, lmm_init_plain, lmm_plan, lmm_plan_plain, lmm_round,
        lmm_round_plain)
    from simgrid_tpu_torch.kernels.superstep_commit import (
        packed_size, superstep_commit,
        superstep_commit_plain, superstep_finish, superstep_reset)
    from simgrid_tpu_torch.kernels.transition_scatter import (
        ELL_POSITIVE, delta_scatter, ell_delta_scatter, transition_scatter,
        transition_scatter_plain)
    from simgrid_tpu_torch.kernels.warm_init import (warm_init,
                                                     warm_init_plain)
    from simgrid_tpu_torch.ops import lmm_drain as lmm_drain_mod
    from simgrid_tpu_torch.ops import lmm_ell, lmm_torch, opstats
    from simgrid_tpu_torch.ops.lmm_arrays import LmmArrays, bucket, to2d
    from simgrid_tpu_torch.ops.lmm_host import LmmFlags
    from simgrid_tpu_torch.ops.lmm_torch import solve_arrays, to_device_system
    from simgrid_tpu_torch.ops.lmm_warm import modified_index
    from simgrid_tpu_torch.workloads import (bench_solve, churn,
                                             collective_run, dragonfly,
                                             drain_run, fault_drain,
                                             lazy_alltoall)
    from simgrid_tpu_torch.kernels.common import (ADV_GO, ADV_OK, DT, FFIRE,
                                                  PENDING, SS_ACTIVE, T_SUM,
                                                  TPOS)
    from simgrid_tpu_torch.kernels.dag_walk import (dag_csr, dag_walk,
                                                    dag_walk_plain)
    from simgrid_tpu_torch.probes.timing import (events_ms, time_call,
                                                 time_rounds)
    from simgrid_tpu_torch.workloads.drain_run import (
        ENGINE_DONE_EPS, EPS, held_step, run_drain, run_engine_plan,
        run_engine_plan_held, run_solve, solve_inputs)

    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    report = {}
    cuda = torch.device("cuda")
    cpu = torch.device("cpu")
    f64 = torch.float64

    # ---- 1. device -------------------------------------------------------
    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _, logs = build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    rec = {"phase": "device", "nvidia_smi": smi,
           "kind": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "build_s": build_s}
    log(rec)
    report["device"] = rec
    with open(os.path.join(out_dir, "ptxas.log"), "w") as f:
        for name, text in logs.items():
            f.write(f"=== {name}\n{text}\n")

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts
                   if t is not None)

    def bound_ms(n_bytes):
        return n_bytes / HBM_BYTES_PER_S * 1e3

    def diff(a, b):
        """Max |a-b| of two float tensors (inf == inf counts as 0);
        exact equality of everything else (two Nones are equal)."""
        if a is None or b is None:
            return 0.0 if a is None and b is None else float("inf")
        a, b = a.detach().cpu(), b.detach().cpu()
        if a.dtype.is_floating_point:
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            if bool(same.all()):
                return 0.0
            return float((a - b).abs()[~same].max())
        return 0.0 if torch.equal(a, b) else float("inf")

    def to_cpu_sys(s: LmmSystem) -> LmmSystem:
        return LmmSystem(*(t.cpu() for t in s[:4]),
                         type(s.csr)(*(t.cpu() for t in s.csr)), s.n_v,
                         None if s.c_fatpipe is None else s.c_fatpipe.cpu())

    # ---- 2. kernels at config-#4 shapes ----------------------------------
    dsys = dragonfly.build_system(FLOWS)
    V, C = FLOWS, dsys.n_cnst
    flat = [to2d(a).reshape(-1) for a in (dsys.e_var, dsys.e_cnst,
                                          dsys.e_w)]
    sg = to_device_system(flat[0], flat[1], flat[2], dsys.c_bound, V, f64,
                          cuda)
    sc = to_cpu_sys(sg)
    pen_g = torch.ones(V, dtype=f64, device=cuda)
    pen_c = pen_g.cpu()
    kernels = []

    # K1: init to the first converged solve, kernel vs plain
    wg, wc = Work(V, C, f64, cuda), Work(V, C, f64, cpu)
    lmm_init(sg, wg, pen_g, EPS)
    rounds_g = 0
    while True:
        for _ in range(16):
            lmm_round(sg, wg, pen_g, EPS)
        it, light = (int(x) for x in wg.ctrl[IT:LIGHT + 1].tolist())
        if light == 0:
            rounds_g = it
            break
        if it > 10_000:
            raise RuntimeError("K1 did not converge")
    lmm_init_plain(sc, wc, pen_c, EPS)
    while lmm_round_plain(sc, wc, pen_c, EPS):
        pass
    rounds_c = int(wc.ctrl[IT])
    if rounds_c != rounds_g:
        raise AssertionError(f"K1 rounds {rounds_g} != plain {rounds_c}")
    err = 0.0
    for name in ("v_value", "v_fixed", "remaining", "usage", "light"):
        err = max(err, diff(getattr(wg, name), getattr(wc, name)))
    if err != 0.0:
        raise AssertionError(f"K1 differs from its plain version: {err}")
    rates_g = wg.v_value.clone()

    def k1_round_ms(init, rnd, n):
        """Mean ms of one round over the first solve: (init + rounds -
        init) / rounds."""
        def solve():
            init(sg, wg, pen_g, EPS)
            for _ in range(rounds_g):
                rnd(sg, wg, pen_g, EPS)
        per_solve = events_ms(solve, n)
        per_init = events_ms(lambda: init(sg, wg, pen_g, EPS), n)
        return (per_solve - per_init) / rounds_g
    # the card's time per round (queued behind a sleep) and the time as
    # the host paces the wrapper calls
    k1_t = time_rounds(lambda: lmm_init(sg, wg, pen_g, EPS),
                       lambda: lmm_round(sg, wg, pen_g, EPS), rounds_g)
    k1_plain = k1_round_ms(lmm_init_plain, lmm_round_plain, 1)
    # each element's flow, link and weight read once, the bounds and
    # penalties read once, the state read and written once; the row
    # indexes are this design's, not the function's, so they are left out
    k1_bytes = (nbytes(sg.e_var, sg.e_cnst, sg.e_w, sg.c_bound, pen_g)
                + 2 * nbytes(wg.v_value, wg.v_fixed, wg.remaining,
                             wg.usage, wg.light))
    kernels.append(dict(
        name="lmm_round", route="cuda",
        source="simgrid_tpu_torch/csrc/lmm_round.cu",
        replaces="simgrid_tpu/ops/lmm_jax.py:556",
        max_abs_err=err, ms=k1_t["ms"], paced_ms=k1_t["paced_ms"],
        queued=k1_t["queued"], plain_ms=k1_plain,
        bound_ms=bound_ms(k1_bytes), bound_by="bytes", library_ms=None,
        first_solve_rounds=rounds_g, row_classes=held_plan(wg)))
    log({"phase": "kernel", **kernels[-1]})

    # K1's row plan at main path 1's shape: card against plain (by bits)
    plan_g = lmm_plan(sg.csr.c_ptr)
    plan_c = lmm_plan_plain(sc.csr.c_ptr)
    err = max(diff(plan_g.order, plan_c.order), diff(plan_g.ncls,
                                                     plan_c.ncls))
    if err != 0.0:
        raise AssertionError(f"K1's row plan differs from its plain "
                             f"version: {err}")
    plan_t = time_call(lambda: lmm_plan(sg.csr.c_ptr))
    # c_ptr read once, the order and the three class sizes written once
    plan_bytes = nbytes(sg.csr.c_ptr, plan_g.order, plan_g.ncls)
    kernels.append(dict(
        name="lmm_plan", route="cuda",
        source="simgrid_tpu_torch/csrc/lmm_round.cu",
        replaces="simgrid_tpu/ops/lmm_jax.py:436",
        note="K1's row plan, part of K1's design with no JAX "
             "counterpart: it serves the fixpoint that starts there",
        max_abs_err=err, ms=plan_t["ms"],
        paced_ms=events_ms(lambda: lmm_plan(sg.csr.c_ptr), 20),
        queued=plan_t["queued"],
        plain_ms=events_ms(lambda: lmm_plan_plain(sg.csr.c_ptr), 3),
        bound_ms=bound_ms(plan_bytes), bound_by="bytes", library_ms=None,
        rows=C, classes=[int(x) for x in plan_c.ncls.tolist()]))
    log({"phase": "kernel", **kernels[-1]})

    # K2: one advance from the converged rates
    rem0 = torch.from_numpy(dsys.sizes.copy()).to(f64)
    thresh0 = 1e-4 * rem0
    state = {}

    def k2_setup():
        state["pen"] = pen_g.clone()
        state["rem"] = rem0.to(cuda, copy=True)
        wg.v_value.copy_(rates_g)
        wg.ctrl[LIGHT] = 0
    thresh_g = thresh0.to(cuda)
    k2_setup()
    drain_advance(state["pen"], state["rem"], thresh_g, wg)
    torch.cuda.synchronize()
    wc.v_value.copy_(rates_g.cpu())
    wc.ctrl[LIGHT] = 0
    pc, rc_ = pen_c.clone(), rem0.clone()
    drain_advance_plain(pc, rc_, thresh0, wc)
    err = max(diff(state["pen"], pc), diff(state["rem"], rc_),
              diff(wg.done, wc.done), diff(wg.fctrl, wc.fctrl),
              diff(wg.ctrl[LIVE_ACC], wc.ctrl[LIVE_ACC]))
    if err != 0.0:
        raise AssertionError(f"K2 differs from its plain version: {err}")
    def k2_fn():
        drain_advance(state["pen"], state["rem"], thresh_g, wg)
    # the card's ms (queued behind a sleep) beside the host-paced ms
    k2_paced = events_ms(k2_fn, 20, k2_setup)
    k2_t = time_call(k2_fn, k2_setup)
    k2_plain = events_ms(lambda: drain_advance_plain(
        state["pen"], state["rem"], thresh_g, wg), 5, k2_setup)
    k2_bytes = nbytes(pen_g, rem0, thresh0, rates_g) + 2 * nbytes(pen_g) \
        + V
    kernels.append(dict(
        name="drain_advance", route="cuda",
        source="simgrid_tpu_torch/csrc/drain_advance.cu",
        replaces="simgrid_tpu/ops/lmm_drain.py:162",
        max_abs_err=err, ms=k2_t["ms"], paced_ms=k2_paced,
        queued=k2_t["queued"], plain_ms=k2_plain,
        bound_ms=bound_ms(k2_bytes), bound_by="bytes", library_ms=None,
        completions=int(wc.done.sum())))
    log({"phase": "kernel", **kernels[-1]})

    # K3: one superstep slot (k=1) on both sides, then the commit alone
    ids_g = torch.arange(V, dtype=torch.int32, device=cuda)
    ids_c = ids_g.cpu()
    pk_g = torch.zeros(packed_size(K, V), dtype=f64, device=cuda)
    pk_c = pk_g.cpu()
    pen_s, rem_s = pen_g.clone(), rem0.to(cuda, copy=True)
    superstep_reset(pen_s, wg, 1, K * 512, 0)
    wg.ctrl[SS_ACTIVE] = 1        # the slot runs (K16's condition)
    lmm_init(sg, wg, pen_s, EPS, gated=True)
    for _ in range(rounds_g):
        lmm_round(sg, wg, pen_s, EPS)
    drain_advance(pen_s, rem_s, thresh_g, wg, gated=True)
    snap = (wg.ctrl.clone(), wg.fctrl.clone(), pk_g.clone())
    superstep_commit(wg, ids_g, pk_g, K, V)
    superstep_finish(sg.e_var, sg.e_w, pen_s, pk_g, wg)
    torch.cuda.synchronize()
    pen_p, rem_p = pen_c.clone(), rem0.clone()
    superstep_reset(pen_p, wc, 1, K * 512, 0)
    wc.ctrl[SS_ACTIVE] = 1
    lmm_init(sc, wc, pen_p, EPS, gated=True)
    while lmm_round(sc, wc, pen_p, EPS):
        pass
    drain_advance(pen_p, rem_p, thresh0, wc, gated=True)
    superstep_commit(wc, ids_c, pk_c, K, V)
    superstep_finish(sc.e_var, sc.e_w, pen_p, pk_c, wc)
    err = max(diff(pk_g, pk_c), diff(wg.ctrl, wc.ctrl),
              diff(wg.fctrl, wc.fctrl))
    if err != 0.0:
        raise AssertionError(f"K3 differs from its plain version: {err}")
    n_done = int(wc.done.sum())

    def k3_setup():
        wg.ctrl.copy_(snap[0])
        wg.fctrl.copy_(snap[1])
        pk_g.copy_(snap[2])
    def k3_fn():
        superstep_commit(wg, ids_g, pk_g, K, V)
    k3_paced = events_ms(k3_fn, 20, k3_setup)
    k3_t = time_call(k3_fn, k3_setup)
    k3_plain = events_ms(lambda: superstep_commit_plain(wg, ids_g, pk_g, K,
                                                        V), 5, k3_setup)
    k3_bytes = V + ids_bytes(wc.done) + n_done * 16
    kernels.append(dict(
        name="superstep_commit", route="cuda",
        source="simgrid_tpu_torch/csrc/superstep_commit.cu",
        replaces="simgrid_tpu/ops/lmm_drain.py:248",
        max_abs_err=err, ms=k3_t["ms"], paced_ms=k3_paced,
        queued=k3_t["queued"], plain_ms=k3_plain,
        bound_ms=bound_ms(k3_bytes), bound_by="bytes", library_ms=None,
        limited_by="latency: two launches of a tile grid per commit"))
    log({"phase": "kernel", **kernels[-1]})

    # K4: repack with about half the flows live
    rng = np.random.default_rng(7)
    live = rng.random(V) < 0.45
    pen_h = torch.from_numpy(live.astype(np.float64))
    rem_h = torch.from_numpy(rng.uniform(1e4, 1e6, V))
    thr_h = 1e-4 * rem_h
    ids_h = torch.arange(V, dtype=torch.int32)
    ev_h = sc.e_var.long()
    live_elems = int(((sc.e_w > 0) & (pen_h[ev_h] > 0)).sum())
    E = sg.n_e
    vh, eh = V // 2, -(-(E // 2) // 8) * 8
    args_g = [t.to(cuda, copy=True) for t in (pen_h, rem_h, thr_h, ids_h)]
    rg = livefirst_repack(sg, *args_g, vh, eh, live_elems)
    torch.cuda.synchronize()
    rp = livefirst_repack_plain(sc, pen_h, rem_h, thr_h, ids_h, vh, eh,
                                live_elems)
    err = max([diff(a, b) for a, b in zip(rg.sys[:4], rp.sys[:4])]
              + [diff(a, b) for a, b in zip(rg.sys.csr, rp.sys.csr)]
              + [diff(a, b) for a, b in zip(rg[1:], rp[1:])])
    if err != 0.0:
        raise AssertionError(f"K4 differs from its plain version: {err}")
    k4_ms = events_ms(lambda: livefirst_repack(sg, *args_g, vh, eh,
                                               live_elems), 10)
    k4_t = time_call(lambda: livefirst_repack(sg, *args_g, vh, eh,
                                              live_elems))
    k4_plain = events_ms(lambda: livefirst_repack_plain(
        sg, *args_g, vh, eh, live_elems), 3)
    # its CUDA launches a call (the kernel nodes of one captured call):
    # at most K4_MAX_LAUNCHES
    k4_launches = launch_gate("K4", k16.kernel_nodes(
        lambda: livefirst_repack(sg, *args_g, vh, eh, live_elems)),
        K4_MAX_LAUNCHES)
    # elements and flow rows read once, the halves written once; the row
    # indexes are this design's (the JAX repack has none), left out as
    # in K1's bound
    k4_bytes = (nbytes(sg.e_var, sg.e_cnst, sg.e_w, *args_g)
                + nbytes(*rg.sys[:3], *rg[1:]))
    kernels.append(dict(
        name="livefirst_repack", route="cuda",
        source="simgrid_tpu_torch/csrc/livefirst_repack.cu",
        replaces="simgrid_tpu/ops/lmm_drain.py:608",
        max_abs_err=err, ms=k4_t["ms"], paced_ms=k4_ms,
        queued=k4_t["queued"], plain_ms=k4_plain,
        bound_ms=bound_ms(k4_bytes), bound_by="bytes", library_ms=None,
        cuda_launches_per_call=k4_launches,
        live_flows=int(live.sum()), live_elems=live_elems))
    log({"phase": "kernel", **kernels[-1]})
    del wg, wc, sg, sc, rg, rp
    torch.cuda.empty_cache()

    # ---- 3. the main path: the config-#4 drain ---------------------------
    spans = []
    with timed_graphs("superstep", spans):
        sim, row = run_drain(dsys, device=cuda, superstep=K)
    counts = row["launches"]
    loop1 = need_loop(row, "main path 1", "superstep", "lmm_round",
                      row["supersteps"])
    for name in ("lmm_plan", "lmm_round", "drain_advance",
                 "superstep_commit", "livefirst_repack"):
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    ss_ms = [a.elapsed_time(b) for a, b in spans]
    rec = {"phase": "main_path", **row, "k16": loop1,
           "superstep_card_ms": ss_ms}
    log(rec)
    report["main_path"] = rec
    for k in kernels:
        k["launches"] = counts[k["name"]]
        k["launches_from"] = "main path 1 (the config-#4 random drain)"
    kernels[0].update(host_calls=loop1["host_round_calls"],
                      device_rounds=loop1["device_rounds"])

    # K16: the first superstep of 4 advances from the drain's start, one
    # graph launch on the card against the plain loops on the host CPU
    # (by bits: the packed result, events, clock, rounds), its card time
    # (CUDA events around the launch) and the plain loops' on the card
    k16_sims, sp_ = {}, []
    for name_, dev in (("cuda", cuda), ("cpu", cpu)):
        s_ = drain_run.make_sim(dsys, device=dev, superstep=K)
        with replayed_graph("superstep", K16_REPS, sp_):
            s_.superstep_batch(k=4)
        k16_sims[name_] = s_
    k16_ms = sorted(a.elapsed_time(b) for a, b in sp_)
    g16, c16 = k16_sims["cuda"], k16_sims["cpu"]
    err16 = diff(g16._packed, c16._packed)
    if err16 != 0.0 or (g16.events, g16.t, g16.rounds, g16.advances) != (
            c16.events, c16.t, c16.rounds, c16.advances):
        raise AssertionError(f"K16's superstep differs from the plain "
                             f"loops ({err16})")
    s_ = drain_run.make_sim(dsys, device=cuda, superstep=K)
    torch.cuda.synchronize()
    with plain_on_card():
        plain16 = events_ms(lambda: s_.superstep_batch(k=4), 1)
    del s_
    by = {k_["name"]: k_["bound_ms"] for k_ in kernels}
    slot_bound = by["drain_advance"] + by["superstep_commit"]
    slots16 = g16.advances      # every slot of this superstep committed
    kernels.append(dict(
        name="superstep_loop", route="cuda",
        source="simgrid_tpu_torch/csrc/superstep_loop.cu",
        replaces="simgrid_tpu/ops/lmm_drain.py:506",
        launches=loop1["graph_launches"], max_abs_err=err16,
        ms=k16_ms[len(k16_ms) // 2], ms_spread=[k16_ms[0], k16_ms[-1]],
        plain_ms=plain16,
        bound_ms=g16.rounds * by["lmm_round"] + slots16 * slot_bound,
        bound_by="bytes", library_ms=None,
        timed_on=f"the first superstep, k=4: {g16.advances} advances, "
                 f"{g16.rounds} rounds; the median of {K16_REPS} "
                 f"launches from the restored start, after one warm-up "
                 f"launch",
        bound_note="the sum of its bodies' bounds over the rounds and "
                   "advances it ran (K1's, K2's and K3's bound rows)",
        path_ms_per_superstep=sum(ss_ms) / max(len(ss_ms), 1),
        path_bound_ms_per_superstep=(
            loop1["device_rounds"] * by["lmm_round"]
            + loop1["device_slots"] * slot_bound) / row["supersteps"],
        graph_launches_per_superstep=loop1["graph_launches_per_superstep"],
        device_rounds=loop1["device_rounds"],
        device_slots=loop1["device_slots"], loop_builds=row["loop_builds"],
        launches_from="main path 1 (the config-#4 random drain): one "
                      "graph launch a superstep"))
    log({"phase": "kernel", **kernels[-1]})
    del g16, c16, k16_sims
    # held against phase 13(a): the same drain under a tape that never
    # fires
    drain3 = (sim.events, sim.t)
    del sim
    torch.cuda.empty_cache()

    # ---- 4. reduced drain: kernels on the card vs plain on the CPU ------
    rsys = dragonfly.build_system(REDUCED_FLOWS)
    res = {name: run_drain(rsys, device=dev, superstep=K)
           for name, dev in (("cuda", cuda), ("cpu", cpu))}
    sg_, sc_ = res["cuda"][0], res["cpu"][0]
    equal = sg_.events == sc_.events and sg_.t == sc_.t
    rec = {"phase": "reduced_drain", "flows": REDUCED_FLOWS,
           "advances": sg_.advances, "t_sim": sg_.t,
           "events_equal": equal, "cuda_wall_s": res["cuda"][1]["wall_s"],
           "cpu_wall_s": res["cpu"][1]["wall_s"]}
    log(rec)
    report["reduced_drain"] = rec
    if not equal:
        raise AssertionError("reduced drain: card and plain CPU differ")
    del res, sg_, sc_
    torch.cuda.empty_cache()

    # ---- 5. K1's new arms at the alltoall's full shapes -----------------
    a2a = dragonfly.build_alltoall(RANKS)
    arr = solve_inputs(a2a)
    V2, C2 = arr.n_var, arr.n_cnst
    flat_a2a = [to2d(x).reshape(-1) for x in (a2a.e_var, a2a.e_cnst,
                                              a2a.e_w)]

    STATE = ("v_value", "v_fixed", "remaining", "usage", "light")

    def card_rounds(sg_, wg_, pen_g_, vb_g, arms, limit=None):
        """Queue rounds in groups of 16 (and at most ``limit``) until the
        fixpoint converges; returns the round count."""
        it = int(wg_.ctrl[IT])
        while limit is None or it < limit:
            for _ in range(16 if limit is None else min(16, limit - it)):
                lmm_round(sg_, wg_, pen_g_, EPS, vb_g, **arms)
            it, light = (int(x) for x in wg_.ctrl[IT:LIGHT + 1].tolist())
            if light == 0:
                break
            if it > 200_000:
                raise RuntimeError("K1 did not converge")
        return it

    def held(wg_, wc_, what):
        err = max(diff(getattr(wg_, n), getattr(wc_, n)) for n in STATE)
        err = max(err, diff(wg_.ctrl[IT:LIGHT + 1], wc_.ctrl[IT:LIGHT + 1]))
        if err != 0.0:
            raise AssertionError(f"K1 {what} differs from its plain "
                                 f"version: {err}")
        return err

    def k1_queued(sg_, wg_, pen_g_, vb_g, arms, rounds):
        """The card's ms per round over the first ``rounds`` rounds,
        queued behind a sleep, and the host-paced ms."""
        fat = arms.get("has_fatpipe", False)
        return time_rounds(
            lambda: lmm_init(sg_, wg_, pen_g_, EPS, has_fatpipe=fat),
            lambda: lmm_round(sg_, wg_, pen_g_, EPS, vb_g, **arms), rounds)

    def k1_ms(sg_, wg_, pen_g_, vb_g, arms, rounds, init, rnd, n):
        """Mean ms of one round over the first ``rounds`` rounds."""
        fat = arms.get("has_fatpipe", False)

        def solve():
            init(sg_, wg_, pen_g_, EPS, has_fatpipe=fat)
            for _ in range(rounds):
                rnd(sg_, wg_, pen_g_, EPS, vb_g, **arms)
        per_solve = events_ms(solve, n)
        per_init = events_ms(lambda: init(sg_, wg_, pen_g_, EPS,
                                          has_fatpipe=fat), n)
        return (per_solve - per_init) / rounds

    def k1_bytes(sys_, w_, bounds, fat):
        """Each element's flow, link and weight read once, the bounds,
        penalties (and rate bounds, FATPIPE flags) read once, the state
        read and written once; the row indexes are the design's."""
        b = nbytes(sys_.e_var, sys_.e_cnst, sys_.e_w, sys_.c_bound,
                   w_.v_value)
        b += nbytes(w_.v_value) if bounds else 0
        b += nbytes(w_.light) if fat else 0
        return b + 2 * nbytes(w_.v_value, w_.v_fixed, w_.remaining,
                              w_.usage, w_.light)

    def k1_case(label, vb_np, fat_np, arms, window=None):
        """Init to the first converged solve on the card.  Without
        ``window`` the plain version on the CPU runs the whole solve
        beside it; with one (a solve of tens of thousands of rounds,
        beyond the CPU's reach) it runs the first ``window`` rounds from
        init and the last ``window`` rounds from the card's state, and
        both must match the card there."""
        sg_ = to_device_system(arr.e_var, arr.e_cnst, arr.e_w, arr.c_bound,
                               V2, f64, cuda, fat_np)
        sc_ = to_cpu_sys(sg_)
        fat = fat_np is not None
        pen_c_ = torch.from_numpy(arr.v_penalty.copy())
        pen_g_ = pen_c_.to(cuda)
        vb_c = torch.from_numpy(np.array(vb_np, np.float64))
        vb_g = vb_c.to(cuda)
        wg_, wc_ = Work(V2, C2, f64, cuda), Work(V2, C2, f64, cpu)
        t0 = time.perf_counter()
        lmm_init(sg_, wg_, pen_g_, EPS, has_fatpipe=fat)
        rounds = card_rounds(sg_, wg_, pen_g_, vb_g, arms)
        rates = wg_.v_value.cpu().numpy().copy()
        lmm_init_plain(sc_, wc_, pen_c_, EPS, has_fatpipe=fat)
        if window is None:
            while lmm_round_plain(sc_, wc_, pen_c_, EPS, vb_c, **arms):
                pass
            err = held(wg_, wc_, label)
        else:
            # windows of `window` rounds: from init, then every B_EVERY
            # rounds and the last `window` from the card's own state
            last = max(rounds - window, 0)
            starts = sorted(set(range(0, last, B_EVERY)) | {last})
            lmm_init(sg_, wg_, pen_g_, EPS, has_fatpipe=fat)
            err = 0.0
            for r0 in starts:
                card_rounds(sg_, wg_, pen_g_, vb_g, arms, r0)
                if r0:
                    for n in STATE + ("ctrl",):
                        getattr(wc_, n).copy_(getattr(wg_, n).cpu())
                if r0 == last:
                    card_rounds(sg_, wg_, pen_g_, vb_g, arms)
                    while lmm_round_plain(sc_, wc_, pen_c_, EPS, vb_c,
                                          **arms):
                        pass
                else:
                    card_rounds(sg_, wg_, pen_g_, vb_g, arms, r0 + window)
                    for _ in range(window):
                        lmm_round_plain(sc_, wc_, pen_c_, EPS, vb_c, **arms)
                err = max(err, held(wg_, wc_, f"{label} (rounds {r0}+)"))
        check_s = time.perf_counter() - t0
        t = k1_queued(sg_, wg_, pen_g_, vb_g, arms, rounds)
        timed = window or rounds
        plain = k1_ms(sg_, wg_, pen_g_, vb_g, arms, timed, lmm_init_plain,
                      lmm_round_plain, 1)
        bound = bound_ms(k1_bytes(sg_, wg_, arms.get("has_bounds"), fat))
        rec = {"phase": "k1_arm", "case": label, "rounds": rounds,
               "checked_rounds": ("all" if window is None else
                                  f"{window} from each of rounds "
                                  f"{starts}"),
               "max_abs_err": err, "ms": t["ms"],
               "paced_ms": t["paced_ms"], "queued": t["queued"],
               "plain_ms": plain, "row_classes": held_plan(wg_),
               "plain_timed_rounds": timed, "bound_ms": bound,
               "flows_at_bound": int(np.count_nonzero(rates == vb_np)),
               "check_s": check_s}
        log(rec)
        return rec, rates

    rec_a, rates_a = k1_case("5a lv08", arr.v_bound, None,
                             dict(has_bounds=True))
    vb_b = rates_a * np.random.default_rng(11).uniform(0.5, 1.5, V2)
    rec_b, _ = k1_case("5b bounds binding", vb_b, None,
                       dict(has_bounds=True), window=B_WINDOW)
    fat_c = np.random.default_rng(12).random(C2) < 0.10
    rec_c, _ = k1_case("5c 10% fatpipe", arr.v_bound, fat_c,
                       dict(has_bounds=True, has_fatpipe=True))
    report["k1_arms"] = [rec_a, rec_b, rec_c]
    # the FATPIPE arm through the solve entry point (its launch count)
    _, fat_row = run_solve(arr._replace(c_fatpipe=fat_c), device=cuda)
    torch.cuda.empty_cache()

    # ---- 6. the global arm at 48 ranks, bounds binding ------------------
    r48 = dragonfly.build_alltoall(REDUCED_RANKS)
    arr48 = solve_inputs(r48)
    # K1's arms: COO pinned (the ELL caps accept 48 ranks, so the card's
    # default layout would take K7's)
    coo = dict(layout="coo")
    rates48 = solve_arrays(arr48, EPS, device=cuda, **coo)[0]
    arr48 = arr48._replace(v_bound=rates48 * np.random.default_rng(
        11).uniform(0.5, 1.5, arr48.n_var))
    _, glob_row = run_solve(arr48, device=cuda, parallel_rounds=False,
                            **coo)
    g48 = solve_arrays(arr48, EPS, device=cuda, parallel_rounds=False, **coo)
    c48 = solve_arrays(arr48, EPS, device="cpu", parallel_rounds=False,
                       **coo)
    if g48[3] != c48[3] or g48[3] != glob_row["rounds"]:
        raise AssertionError(f"global rounds {g48[3]} != plain {c48[3]}")
    err_g = max(diff(torch.from_numpy(x), torch.from_numpy(y))
                for x, y in zip(g48[:3], c48[:3]))
    if err_g != 0.0:
        raise AssertionError(f"global arm differs from its plain version:"
                             f" {err_g}")
    sg48 = to_device_system(arr48.e_var, arr48.e_cnst, arr48.e_w,
                            arr48.c_bound, arr48.n_var, f64, cuda)
    wg48 = Work(arr48.n_var, arr48.n_cnst, f64, cuda)
    pen48 = torch.from_numpy(arr48.v_penalty.copy()).to(cuda)
    vb48 = torch.from_numpy(arr48.v_bound.copy()).to(cuda)
    garms = dict(has_bounds=True, global_rounds=True)
    # ms per round over the first (up to) 200 rounds, kernel and plain
    r_t = min(g48[3], 200)
    glob_t = k1_queued(sg48, wg48, pen48, vb48, garms, r_t)
    glob_plain = k1_ms(sg48, wg48, pen48, vb48, garms, r_t, lmm_init_plain,
                       lmm_round_plain, 1)
    # 5(b)'s local bound arm at 48 ranks, the whole solve on both sides
    l48 = solve_arrays(arr48, EPS, device=cuda, **coo)
    lc48 = solve_arrays(arr48, EPS, device="cpu", **coo)
    err_l = max(diff(torch.from_numpy(x), torch.from_numpy(y))
                for x, y in zip(l48[:3], lc48[:3]))
    if err_l != 0.0 or l48[3] != lc48[3]:
        raise AssertionError(f"local bound arm at {REDUCED_RANKS} ranks "
                             f"differs from its plain version: {err_l}")
    # 5(c)'s FATPIPE arm at 48 ranks, the whole solve on both sides
    fat48 = arr48._replace(c_fatpipe=np.random.default_rng(12).random(
        len(arr48.c_bound)) < 0.10)
    f48 = solve_arrays(fat48, EPS, device=cuda, **coo)
    fc48 = solve_arrays(fat48, EPS, device="cpu", **coo)
    err_f = max(diff(torch.from_numpy(x), torch.from_numpy(y))
                for x, y in zip(f48[:3], fc48[:3]))
    if err_f != 0.0 or f48[3] != fc48[3]:
        raise AssertionError(f"FATPIPE arm at {REDUCED_RANKS} ranks "
                             f"differs from its plain version: {err_f}")
    rec = {"phase": "global_arm", "ranks": REDUCED_RANKS,
           "flows": arr48.n_var, "rounds": g48[3], "timed_rounds": r_t,
           "local_bounds_rounds": l48[3], "local_bounds_err": err_l,
           "fatpipe_rounds": f48[3], "fatpipe_err": err_f,
           "max_abs_err": err_g, "ms": glob_t["ms"],
           "paced_ms": glob_t["paced_ms"], "queued": glob_t["queued"],
           "plain_ms": glob_plain,
           "bound_ms": bound_ms(k1_bytes(sg48, wg48, True, False)),
           "wall_s": glob_row["wall_s"], "launches": glob_row["launches"]}
    log(rec)
    report["global_arm"] = rec
    del sg48, wg48

    # ---- 7. main path 2: the solve of the LV08 alltoall -----------------
    values, solve_row = run_solve(a2a, device=cuda)
    if values.shape != (V2,) or not np.all(np.isfinite(values)) \
            or not np.all(values > 0):
        raise AssertionError("solve: values not finite and positive")
    if not np.array_equal(values, rates_a):
        raise AssertionError("solve: values differ from phase 5(a)")
    if solve_row["launches"].get("lmm_round_bounds", 0) <= 0:
        raise AssertionError("lmm_round_bounds never launched on the "
                             "solve path")
    rec = {"phase": "main_path_solve", **solve_row,
           "recorded_rounds": RECORDED_ROUNDS}
    log(rec)
    report["main_path_solve"] = rec

    # ---- 8. main path 3: the engine-plan drain of the alltoall ----------
    sim, plan_row, plan_events = run_engine_plan(
        a2a, device=cuda, max_advances=PLAN_ADVANCES)
    pcounts = plan_row["launches"]
    for name in ("lmm_round_bounds", "drain_advance",
                 "drain_forced_advance", "superstep_commit",
                 "transition_scatter"):
        if pcounts.get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched on the engine-plan"
                                 f" path")
    if pcounts.get("livefirst_repack_vbound", 0) or sim.repacks:
        raise AssertionError("the cut alltoall plan repacked: update the "
                             "kernels line's launch sources")
    # the state the cut left, held against the plain path: one more
    # advance on the card and, from a handover, on the CPU
    _, cut_win = held_step(sim, k=1)
    rec = {"phase": "main_path_engine_plan", "ranks": RANKS,
           "max_advances": PLAN_ADVANCES, **plan_row,
           "held_window": cut_win}
    log(rec)
    report["main_path_engine_plan"] = rec
    del sim, plan_events
    torch.cuda.empty_cache()

    # the same plan at full width to its end: config #4's 100,000 random
    # flows with the LV08 values the engine gives them (the alltoall
    # would take hours); its live set halves, so K4 carries the bound rows
    l08 = dragonfly.build_system(FLOWS, lv08=True)
    sim, l08_row, _ = run_engine_plan(l08, device=cuda)
    lcounts = l08_row["launches"]
    for name in ("lmm_round_bounds", "drain_advance", "drain_forced_advance",
                 "superstep_commit", "transition_scatter",
                 "livefirst_repack_vbound"):
        if lcounts.get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched on the full-width "
                                 f"engine plan")
    # the same run again with windows held against the plain CPU path:
    # after the partial advance and after each repack
    held_sim, l08_windows = run_engine_plan_held(l08, device=cuda)
    if held_sim.events != sim.events or held_sim.t != sim.t:
        raise AssertionError("the held full-width plan differs from the "
                             "timed one")
    rec = {"phase": "main_path_engine_plan_full_width", "flows": FLOWS,
           **l08_row, "held_windows": l08_windows}
    log(rec)
    report["main_path_engine_plan_full_width"] = rec
    del sim, held_sim
    torch.cuda.empty_cache()

    # repack_min 64 (the CPU tests' value): the reduced drain then
    # repacks, and K4 carries the bound rows on this path
    rplan = dragonfly.build_alltoall(PLAN_RANKS)
    red = {name: run_engine_plan(rplan, device=dev, repack_min=64)
           for name, dev in (("cuda", cuda), ("cpu", cpu))}
    (gs, grow, gev), (cs, crow, cev) = red["cuda"], red["cpu"]
    equal = (gev == cev and gs.t == cs.t
             and diff(gs._pen, cs._pen) == 0.0
             and diff(gs._rem, cs._rem) == 0.0)
    rcounts = grow["launches"]
    if rcounts.get("livefirst_repack_vbound", 0) <= 0:
        raise AssertionError("livefirst_repack_vbound never launched on "
                             "the reduced engine-plan path")
    rec = {"phase": "reduced_engine_plan", "ranks": PLAN_RANKS,
           "flows": len(rplan.sizes), "advances": gs.advances,
           "rounds": gs.rounds, "supersteps": gs.supersteps,
           "repacks": gs.repacks, "t_engine": grow["t_engine"],
           "equal": equal, "cuda_wall_s": grow["wall_s"],
           "cpu_wall_s": crow["wall_s"], "launches": rcounts}
    log(rec)
    report["reduced_engine_plan"] = rec
    if not equal:
        raise AssertionError("reduced engine plan: card and plain CPU "
                             "differ")
    del red, gs, cs

    # K2 forced mode at the alltoall's shapes, from phase 5(a)'s rates
    pen_f = torch.from_numpy(arr.v_penalty.copy())
    rem_f = torch.from_numpy(a2a.sizes.copy())
    thr_f = torch.full((V2,), ENGINE_DONE_EPS, dtype=f64)
    rate_f = torch.from_numpy(rates_a)
    delta = float(torch.min(rem_f / rate_f)) / 2
    wgf, wcf = Work(V2, C2, f64, cuda), Work(V2, C2, f64, cpu)
    wgf.v_value.copy_(rate_f)
    wcf.v_value.copy_(rate_f)
    fst = {}

    def kf_setup():
        fst["pen"] = pen_f.to(cuda, copy=True)
        fst["rem"] = rem_f.to(cuda, copy=True)
    thr_g = thr_f.to(cuda)
    kf_setup()
    drain_forced_advance(fst["pen"], fst["rem"], thr_g, wgf, delta)
    pcf, rcf = pen_f.clone(), rem_f.clone()
    drain_forced_advance_plain(pcf, rcf, thr_f, wcf, delta)
    err = max(diff(fst["pen"], pcf), diff(fst["rem"], rcf),
              diff(wgf.done, wcf.done),
              diff(wgf.ctrl[LIVE_ACC], wcf.ctrl[LIVE_ACC]))
    if err != 0.0:
        raise AssertionError(f"K2 forced differs from its plain version: "
                             f"{err}")
    def kf_fn():
        drain_forced_advance(fst["pen"], fst["rem"], thr_g, wgf, delta)
    kf_ms = events_ms(kf_fn, 20, kf_setup)
    kf_plain = events_ms(lambda: drain_forced_advance_plain(
        fst["pen"], fst["rem"], thr_g, wgf, delta), 5, kf_setup)
    kernels.append(dict(
        name="drain_forced_advance", route="cuda",
        source="simgrid_tpu_torch/csrc/drain_advance.cu",
        replaces="simgrid_tpu/ops/lmm_drain.py:585",
        launches=pcounts["drain_forced_advance"], max_abs_err=err,
        ms=kf_ms, plain_ms=kf_plain,
        bound_ms=bound_ms(4 * nbytes(pen_f) + 2 * nbytes(pen_f) + V2),
        bound_by="bytes", library_ms=None,
        launches_from="main path 3 (the 320-rank alltoall plan)"))
    log({"phase": "kernel", **kernels[-1]})

    # K5: the main path's transition batch shape at full size
    rng5 = np.random.default_rng(5)
    bsl = np.sort(rng5.choice(V2, V2 // 100, replace=False))
    csl = np.sort(rng5.choice(C2, C2 // 100, replace=False))
    lsl = np.sort(rng5.choice(V2, V2 // 100, replace=False))
    runs = [(7, bsl, rates_a[bsl] * rng5.uniform(0.5, 1.5, len(bsl))),
            (3, csl, arr.c_bound[csl] * rng5.uniform(0.5, 1.0, len(csl))),
            (4, lsl, arr.v_penalty[lsl])]
    layout, chunks, off = [], [], 0
    for ti, ix, vals in runs:
        layout.append((ti, off, len(ix)))
        chunks += [ix.astype(np.float64), vals]
        off += 2 * len(ix)
    payload_c = torch.from_numpy(np.concatenate(chunks))
    payload_g = payload_c.to(cuda)
    base5 = [flat_a2a[0], flat_a2a[1], flat_a2a[2], arr.c_bound,
             arr.v_penalty, a2a.sizes, np.full(V2, ENGINE_DONE_EPS),
             arr.v_bound]
    tg5 = [torch.from_numpy(np.array(b)).to(cuda) for b in base5]
    tc5 = [torch.from_numpy(np.array(b)) for b in base5]
    transition_scatter(payload_g, layout, tg5)
    transition_scatter_plain(payload_c, layout, tc5)
    err = max(diff(a, b) for a, b in zip(tg5, tc5))
    if err != 0.0:
        raise AssertionError(f"K5 differs from its plain version: {err}")
    k5_launches = launch_gate("K5", k16.kernel_nodes(
        lambda: transition_scatter(payload_g, layout, tg5)), K5_LAUNCHES,
        exact=True)
    k5_ms = events_ms(lambda: transition_scatter(payload_g, layout, tg5),
                      20)
    k5_plain = events_ms(lambda: transition_scatter_plain(
        payload_g, layout, tg5), 5)

    def library_k5():
        for ti, o, n in layout:
            tg5[ti].index_put_((payload_g[o:o + n].long(),),
                               payload_g[o + n:o + 2 * n])
    k5_lib = events_ms(library_k5, 20)
    k5_t = time_call(lambda: transition_scatter(payload_g, layout, tg5))
    k5_lib_t = time_call(library_k5)
    n_slots = sum(n for _, _, n in layout)
    kernels.append(dict(
        name="transition_scatter", route="cuda",
        source="simgrid_tpu_torch/csrc/transition_scatter.cu",
        replaces="simgrid_tpu/ops/lmm_drain.py:560",
        launches=pcounts["transition_scatter"], max_abs_err=err,
        ms=k5_t["ms"], paced_ms=k5_ms, queued=k5_t["queued"],
        plain_ms=k5_plain,
        bound_ms=bound_ms(16 * n_slots + 8 * n_slots), bound_by="bytes",
        library_ms=k5_lib_t["ms"], library_paced_ms=k5_lib,
        library="index_put_, one call per run",
        cuda_launches_per_call=k5_launches,
        slots=n_slots, launches_from="main path 3 (the 320-rank alltoall plan)"))
    log({"phase": "kernel", **kernels[-1]})
    del tg5, tc5

    # K4 with the bound rows at the alltoall's shapes
    sgr = to_device_system(flat_a2a[0], flat_a2a[1], flat_a2a[2],
                           arr.c_bound, V2, f64, cuda)
    scr = to_cpu_sys(sgr)
    live4 = np.random.default_rng(7).random(V2) < 0.45
    args_c = [torch.from_numpy(live4 * arr.v_penalty),
              torch.from_numpy(a2a.sizes.copy()),
              torch.full((V2,), ENGINE_DONE_EPS, dtype=f64),
              torch.arange(V2, dtype=torch.int32),
              torch.from_numpy(arr.v_bound.copy())]
    args_g4 = [t.to(cuda) for t in args_c]
    le4 = int(((scr.e_w > 0) & (args_c[0][scr.e_var.long()] > 0)).sum())
    vh4, eh4 = V2 // 2, -(-(sgr.n_e // 2) // 8) * 8
    rg4 = livefirst_repack(sgr, *args_g4[:4], vh4, eh4, le4, args_g4[4])
    rc4 = livefirst_repack_plain(scr, *args_c[:4], vh4, eh4, le4,
                                 args_c[4])
    err = max([diff(a, b) for a, b in zip(rg4.sys[:4], rc4.sys[:4])]
              + [diff(a, b) for a, b in zip(rg4.sys.csr, rc4.sys.csr)]
              + [diff(a, b) for a, b in zip(rg4[1:], rc4[1:])])
    if err != 0.0:
        raise AssertionError(f"K4 with bound rows differs from its plain "
                             f"version: {err}")
    k4v_ms = events_ms(lambda: livefirst_repack(
        sgr, *args_g4[:4], vh4, eh4, le4, args_g4[4]), 10)
    k4v_t = time_call(lambda: livefirst_repack(
        sgr, *args_g4[:4], vh4, eh4, le4, args_g4[4]))
    k4v_plain = events_ms(lambda: livefirst_repack_plain(
        sgr, *args_g4[:4], vh4, eh4, le4, args_g4[4]), 3)
    k4v_launches = launch_gate("K4+", k16.kernel_nodes(
        lambda: livefirst_repack(sgr, *args_g4[:4], vh4, eh4, le4,
                                 args_g4[4])), K4_MAX_LAUNCHES)
    kernels.append(dict(
        name="livefirst_repack_vbound", route="cuda",
        source="simgrid_tpu_torch/csrc/livefirst_repack.cu",
        replaces="simgrid_tpu/ops/lmm_drain.py:648",
        launches=lcounts["livefirst_repack_vbound"], max_abs_err=err,
        ms=k4v_t["ms"], paced_ms=k4v_ms, queued=k4v_t["queued"],
        plain_ms=k4v_plain,
        bound_ms=bound_ms(nbytes(sgr.e_var, sgr.e_cnst, sgr.e_w, *args_g4)
                          + nbytes(*rg4.sys[:3], *rg4[1:])),
        bound_by="bytes", library_ms=None,
        cuda_launches_per_call=k4v_launches,
        launches_from=(
            "main path 3 at full width to its end (100,000 random flows, "
            "LV08 values); it does not run on the 320-rank alltoall within "
            f"its {PLAN_ADVANCES}-advance cut (no repack there); "
            f"{rcounts['livefirst_repack_vbound']} on the {PLAN_RANKS}-rank "
            "alltoall plan")))
    log({"phase": "kernel", **kernels[-1]})
    del sgr, scr, rg4, rc4

    # K1's arms as their own records
    kernels.append(dict(
        name="lmm_round_bounds", route="cuda",
        source="simgrid_tpu_torch/csrc/lmm_round.cu",
        replaces="simgrid_tpu/ops/lmm_jax.py:589",
        launches=solve_row["launches"]["lmm_round_bounds"],
        max_abs_err=rec_b["max_abs_err"], ms=rec_b["ms"],
        paced_ms=rec_b["paced_ms"], queued=rec_b["queued"],
        plain_ms=rec_b["plain_ms"], bound_ms=rec_b["bound_ms"],
        bound_by="bytes", library_ms=None,
        launches_from="main path 2 (solve)",
        launches_engine_plan=pcounts["lmm_round_bounds"],
        timed_on="5b bounds binding"))
    kernels.append(dict(
        name="lmm_round_bounds_fatpipe", route="cuda",
        source="simgrid_tpu_torch/csrc/lmm_round.cu",
        replaces="simgrid_tpu/ops/lmm_jax.py:490",
        launches=fat_row["launches"]["lmm_round_bounds_fatpipe"],
        max_abs_err=rec_c["max_abs_err"], ms=rec_c["ms"],
        paced_ms=rec_c["paced_ms"], queued=rec_c["queued"],
        plain_ms=rec_c["plain_ms"], bound_ms=rec_c["bound_ms"],
        bound_by="bytes", library_ms=None,
        launches_from="phase 5c solve_arrays (kernel check)"))
    kernels.append(dict(
        name="lmm_round_global_bounds", route="cuda",
        source="simgrid_tpu_torch/csrc/lmm_round.cu",
        replaces="simgrid_tpu/ops/lmm_jax.py:520",
        launches=glob_row["launches"]["lmm_round_global_bounds"],
        max_abs_err=err_g, ms=glob_t["ms"], paced_ms=glob_t["paced_ms"],
        queued=glob_t["queued"], plain_ms=glob_plain,
        bound_ms=report["global_arm"]["bound_ms"], bound_by="bytes",
        library_ms=None,
        launches_from="phase 6 solve_arrays(parallel_rounds=False)"))
    for k in kernels[-3:]:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched")

    def same_bits(a, b) -> bool:
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype == np.float64:
            a, b = a.view(np.int64), b.view(np.int64)
        return a.shape == b.shape and bool(np.array_equal(a, b))

    def same_states(xs, ys) -> bool:
        return len(xs) == len(ys) and all(
            same_bits(a, c) and same_bits(b, d)
            for (a, b), (c, d) in zip(xs, ys))

    # ---- 9. main path 4: the 100k-variable churn through the System ----
    churn_rows, churn_states = {}, {}
    for mode in churn.MODES:
        sys9, row = churn.run_churn(mode, device=cuda, states=True,
                                    strict=True, layout="coo", **CHURN)
        churn_states[mode] = row.pop("states")
        churn_rows[mode] = row
        log({"phase": "churn", **row})
        if mode == "warm-selective":
            warm9 = sys9
        del sys9
    t0 = time.perf_counter()
    _, cpu9 = churn.run_churn("warm-selective", device=cpu, states=True,
                              strict=True, layout="coo", **CHURN)
    cpu9_s = time.perf_counter() - t0
    held = {"warm-selective vs plain CPU": same_states(
        churn_states["warm-selective"], cpu9["states"])}
    for mode in ("cold-full", "cold-delta"):
        held[f"{mode} vs warm-selective"] = same_states(
            churn_states[mode], churn_states["warm-selective"])
    counts_ok = {mode: all(churn_rows[mode][k] == v
                           for k, v in {**CHURN_COMMON, **want}.items())
                 for mode, want in CHURN_RECORDED.items()}
    wl = churn_rows["warm-selective"]["launches"]
    rec = {"phase": "main_path_churn", "held": held, "counts": counts_ok,
           "cpu_wall_s": cpu9_s,
           "rounds_warm_over_cold": (
               sum(churn_rows["warm-selective"]["rounds"])
               / sum(churn_rows["cold-delta"]["rounds"]))}
    log(rec)
    report["main_path_churn"] = {**rec, "rows": churn_rows}
    if not all(held.values()):
        raise AssertionError(f"churn: states differ: {held}")
    if not all(counts_ok.values()):
        raise AssertionError(f"churn: counts differ from the recorded "
                             f"ones: {counts_ok}")
    if any(r["solver_fallbacks"] for r in churn_rows.values()):
        raise AssertionError("churn: a solve fell back to the host")
    for name in ("lmm_round", "delta_scatter", "warm_init"):
        if wl.get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched on the churn")
    del churn_states, cpu9

    # K5's delta use and K6 at the churn's shapes, from the resident state
    # the warm-selective run left on the card
    st9 = warm9.warm_solver._states[np.dtype(np.float64)]
    masters_g = st9.masters
    E9, C9, V9 = st9.shapes
    rng9 = np.random.default_rng(9)
    runs9 = [(0, E9, 3000), (1, E9, 3000), (2, E9, 3000), (4, C9, 600),
             (5, V9, 2000), (6, V9, 1000)]
    layout9, chunks9, off9 = [], [], 0
    host_m = [m.cpu().numpy() for m in masters_g]
    for ti, hi, n in runs9:
        n = min(n, hi // 2)
        ix = np.sort(rng9.choice(hi, n, replace=False))
        vals = host_m[ti][ix].astype(np.float64)
        if ti == 4:                       # the bool target: flip some
            vals = np.where(rng9.random(n) < 0.5, 1.0 - vals, vals)
        nb = bucket(n, floor=8)
        pi = np.full(nb, float(ix[0]))
        pv = np.full(nb, vals[0])
        pi[:n], pv[:n] = ix, vals
        layout9.append((ti, off9, nb))
        chunks9 += [pi, pv]
        off9 += 2 * nb
    pay_c = torch.from_numpy(np.concatenate(chunks9))
    pay_g = pay_c.to(cuda)
    tg9 = [m.clone() for m in masters_g]
    tc9 = [m.cpu() for m in masters_g]
    delta_scatter(pay_g, layout9, tg9)
    transition_scatter_plain(pay_c, layout9, tc9)
    err = 0.0 if all(same_bits(a.cpu().numpy(), b.numpy())
                     for a, b in zip(tg9, tc9)) else float("inf")
    if err != 0.0:
        raise AssertionError("K5 (delta) differs from its plain version")
    kd_launches = launch_gate("K5 (delta)", k16.kernel_nodes(
        lambda: delta_scatter(pay_g, layout9, tg9)), K5_LAUNCHES, exact=True)
    kd_ms = events_ms(lambda: delta_scatter(pay_g, layout9, tg9), 20)
    kd_plain = events_ms(lambda: transition_scatter_plain(pay_g, layout9,
                                                          tg9), 5)

    def library_kd():
        for ti, o, n in layout9:
            tg9[ti].index_put_((pay_g[o:o + n].long(),),
                               pay_g[o + n:o + 2 * n].to(tg9[ti].dtype))
    kd_lib = events_ms(library_kd, 20)
    kd_t = time_call(lambda: delta_scatter(pay_g, layout9, tg9))
    kd_lib_t = time_call(library_kd)
    slots9 = sum(n for _, _, n in layout9)
    kd_bytes = 16 * slots9 + sum(n * tg9[ti].element_size()
                                 for ti, _, n in layout9)
    kernels.append(dict(
        name="delta_scatter", route="cuda",
        source="simgrid_tpu_torch/csrc/transition_scatter.cu",
        replaces="simgrid_tpu/ops/lmm_warm.py:119",
        launches=wl["delta_scatter"], max_abs_err=err, ms=kd_t["ms"],
        paced_ms=kd_ms, queued=kd_t["queued"],
        plain_ms=kd_plain, bound_ms=bound_ms(kd_bytes), bound_by="bytes",
        library_ms=kd_lib_t["ms"], library_paced_ms=kd_lib,
        library="index_put_, one call per run",
        cuda_launches_per_call=kd_launches, slots=slots9,
        launches_from="main path 4 (the 100k churn, warm-selective)"))
    log({"phase": "kernel", **kernels[-1]})
    del tg9, tc9

    # K6: the restart state of a churn step's modified clusters
    clusters9 = rng9.integers(0, CHURN["clusters"], 999)
    mc9 = np.unique(CHURN["chain"] + clusters9).astype(np.int32)
    # the wrappers take the index on the host (checked, then uploaded)
    mc_h = modified_index(mc9)
    mc_g = torch.from_numpy(mc_h).to(cuda)
    carry = {n: getattr(st9.work, n).clone()
             for n in ("v_value", "remaining", "usage")}
    w6g = Work(V9, C9, f64, cuda)
    w6c = Work(V9, C9, f64, cpu)
    sys6c = to_cpu_sys(st9.sys)
    pen9 = masters_g[5]

    def k6_setup():
        for n, t in carry.items():
            getattr(w6g, n).copy_(t)
    k6_setup()
    warm_init(st9.sys, w6g, pen9, mc_h, EPS)
    for n, t in carry.items():
        getattr(w6c, n).copy_(t.cpu())
    warm_init_plain(sys6c, w6c, pen9.cpu(), mc_g.cpu(), EPS)
    k6_names = ("v_value", "v_fixed", "remaining", "usage", "light",
                "c_mod", "ctrl")
    err = 0.0 if all(same_bits(getattr(w6g, n).cpu().numpy(),
                               getattr(w6c, n).numpy())
                     for n in k6_names) else float("inf")
    if err != 0.0:
        raise AssertionError("K6 differs from its plain version")
    k6_launches = launch_gate("K6", k16.kernel_nodes(
        lambda: warm_init(st9.sys, w6g, pen9, mc_h, EPS)), K6_MAX_LAUNCHES)
    k6_ms = events_ms(lambda: warm_init(st9.sys, w6g, pen9, mc_h, EPS), 20,
                      k6_setup)
    k6_t = time_call(lambda: warm_init(st9.sys, w6g, pen9, mc_h, EPS),
                     k6_setup)
    k6_plain = events_ms(lambda: warm_init_plain(st9.sys, w6g, pen9, mc_g,
                                                 EPS), 5, k6_setup)
    # each input read once (elements, bounds, FATPIPE flags, penalties,
    # the carried value/remaining/usage, mc_idx), each output written
    # once (value, fixed, remaining, usage, light); row indexes left out
    k6_bytes = (nbytes(st9.sys.e_var, st9.sys.e_cnst, st9.sys.e_w,
                       st9.sys.c_bound, st9.sys.c_fatpipe, pen9, mc_g)
                + 2 * nbytes(*carry.values())
                + nbytes(w6g.v_fixed, w6g.light))
    kernels.append(dict(
        name="warm_init", route="cuda",
        source="simgrid_tpu_torch/csrc/warm_init.cu",
        replaces="simgrid_tpu/ops/lmm_warm.py:201",
        launches=wl["warm_init"], max_abs_err=err, ms=k6_t["ms"],
        paced_ms=k6_ms, queued=k6_t["queued"], plain_ms=k6_plain,
        bound_ms=bound_ms(k6_bytes), bound_by="bytes", library_ms=None,
        cuda_launches_per_call=k6_launches, modified_constraints=len(mc9),
        launches_from="main path 4 (the 100k churn, warm-selective)"))
    log({"phase": "kernel", **kernels[-1]})
    del warm9, st9, w6g, w6c, sys6c, masters_g
    torch.cuda.empty_cache()

    # ---- 10. main path 5: the Lazy-mode 320-rank alltoall ---------------
    strict = LmmFlags(backend="torch", strict=True)
    last_latency = {}

    def keep_latency_state(label, s):
        """After each latency-end solve: the view's arrays and the warm
        solver's result over every slot (its converged fixpoint state;
        the last one is held below)."""
        if not label.startswith("latency"):
            return
        v = s.array_view
        w = s.warm_solver._states[np.dtype(np.float64)].work
        last_latency.update(
            label=label,
            arrays=LmmArrays(v.e_var.copy(), v.e_cnst.copy(),
                             v.e_w.copy(), v.c_bound.copy(),
                             v.c_fatpipe.copy(), v.v_penalty.copy(),
                             v.v_bound.copy(), v.n_elem,
                             len(v.slot_cnst), len(v.slot_var)),
            result=[t.cpu().numpy().copy()
                    for t in (w.v_value, w.remaining, w.usage)])
    sys10, row10 = lazy_alltoall.run_lazy(RANKS, device=cuda, flags=strict,
                                          on_solve=keep_latency_state)
    del sys10
    torch.cuda.empty_cache()
    l10 = row10["launches"]
    for name in ("lmm_round_bounds", "delta_scatter", "warm_init"):
        if l10.get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched on the Lazy "
                                 f"alltoall")
    if row10["solver_fallbacks"]:
        raise AssertionError("Lazy alltoall: a solve fell back")
    lv = last_latency
    cold = solve_arrays(lv["arrays"], EPS, device=cuda)
    warm_eq_cold = all(same_bits(a, b)
                       for a, b in zip(lv["result"], cold[:3]))
    # COO pinned at 48 ranks, where the ELL caps would accept the system
    strict48 = LmmFlags(backend="torch", strict=True, layout="coo")
    _, g48 = lazy_alltoall.run_lazy(REDUCED_RANKS, device=cuda,
                                    flags=strict48, states=True)
    _, c48 = lazy_alltoall.run_lazy(REDUCED_RANKS, device=cpu,
                                    flags=strict48, states=True)
    strip = lambda rows: [{k: v for k, v in r.items() if k != "ms"}
                          for r in rows]
    eq48 = (same_states(g48["states"], c48["states"])
            and strip(g48["solves"]) == strip(c48["solves"]))
    rec = {"phase": "main_path_lazy_alltoall", **row10,
           "warm_equals_cold": warm_eq_cold,
           "cold_checked_after": lv["label"], "cold_rounds": cold[3],
           "reduced_ranks": REDUCED_RANKS, "reduced_card_equals_cpu": eq48,
           "reduced_solves": g48["solves"]}
    log(rec)
    report["main_path_lazy_alltoall"] = rec
    if not warm_eq_cold:
        raise AssertionError("Lazy alltoall: the warm result differs from "
                             "a cold solve of the same arrays")
    if not eq48:
        raise AssertionError("Lazy alltoall at 48 ranks: card and plain "
                             "CPU differ")
    for kr, name in ((kernels[-2], "delta_scatter"),
                     (kernels[-1], "warm_init")):
        kr["launches_from"] += (f"; {l10[name]} on main path 5 (the "
                                f"Lazy {RANKS}-rank alltoall)")

    # ---- 11. main path 6: bench.py's headline solve, ELL ---------------
    def same_result(a, b) -> bool:
        return a[3] == b[3] and all(same_bits(x, y)
                                    for x, y in zip(a[:3], b[:3]))

    def stages_of(fn):
        before = opstats.snapshot()
        out = fn()
        return out, int(opstats.diff(before).get("ell_chain_stages", 0))

    hl = bench_solve.build_arrays(
        np.random.default_rng(HEADLINE["seed"]), HEADLINE["n_c"],
        HEADLINE["n_v"], HEADLINE["deg"], np.float64)
    hl_ell = lmm_ell.ell_from_arrays(hl)
    # (a) the card's default: the compaction chain
    (res_a, row_a), st_a = stages_of(lambda: bench_solve.run_bench_solve(
        device=cuda, reps=3, arrays=hl, eps=HL_EPS, **HEADLINE))
    la = row_a["launches"]
    t0 = time.perf_counter()
    cpu_a, st_ca = stages_of(lambda: solve_arrays(
        hl, HL_EPS, device=cpu, layout="ell", chain="on"))
    cpu_a_s = time.perf_counter() - t0
    held_a = same_result(res_a, cpu_a) and st_a == 4 * st_ca
    # (b) the chain off: K7's init, K8's rounds
    res_b, row_b = bench_solve.run_bench_solve(
        device=cuda, reps=3, arrays=hl, chain="off", eps=HL_EPS, **HEADLINE)
    cpu_b = solve_arrays(hl, HL_EPS, device=cpu, layout="ell", chain="off")
    held_b = same_result(res_b, cpu_b)
    # (c) a stage cap of 1: the chain overflows, the dense path re-solves
    cap = lmm_ell._CHAIN_STAGE_CAP
    lmm_ell._CHAIN_STAGE_CAP = 1
    try:
        res_c, row_c = bench_solve.run_bench_solve(
            device=cuda, reps=0, arrays=hl, eps=HL_EPS, **HEADLINE)
    finally:
        lmm_ell._CHAIN_STAGE_CAP = cap
    held_c = (same_result(res_c, res_b) and row_c["path"] == "dense"
              and row_c["chain_fell_back"])
    # (d) bench.py's stage_device padding (exact row widths, V0 102,400:
    # three stages) and (e) a seeded 10% of the constraints FATPIPE, each
    # through the chain on the card against the plain chain on the CPU
    fat_hl = hl.c_fatpipe.copy()
    fat_hl[:hl.n_cnst] = np.random.default_rng(12).random(hl.n_cnst) < 0.10
    variants = {}
    for key, arr_v, pad_v in (
            ("tight", bench_solve.build_arrays(
                np.random.default_rng(HEADLINE["seed"]), HEADLINE["n_c"],
                HEADLINE["n_v"], HEADLINE["deg"], np.float64, "tight"),
             "tight"),
            ("fatpipe", hl._replace(c_fatpipe=fat_hl), "pow2")):
        (res_v, row_v), st_v = stages_of(
            lambda: bench_solve.run_bench_solve(
                device=cuda, reps=3, arrays=arr_v, eps=HL_EPS, pad=pad_v,
                **HEADLINE))
        t0 = time.perf_counter()
        cpu_v, st_cv = stages_of(lambda: solve_arrays(
            arr_v, HL_EPS, device=cpu, layout="ell", chain="on",
            pad=pad_v))
        e_v = lmm_ell.ell_cached(arr_v, pad_v)
        variants[key] = dict(
            v0=int(len(arr_v.v_penalty)),
            widths=[int(e_v.cv_var.shape[1]), int(e_v.vc_cnst.shape[1])],
            **{k: row_v[k] for k in ("rounds", "first_ms", "ms", "reps_ms",
                                     "path", "after_first")},
            stages_per_solve=st_v // 4, cpu_stages=st_cv,
            cpu_wall_s=time.perf_counter() - t0,
            held=same_result(res_v, cpu_v) and st_v == 4 * st_cv)
    # K8's round loops as the chain's graph holds them: the kernel nodes
    # of each body, none of them a loop_cond node
    k8_bodies = [b for b in k16.bodies(since_reset=False)
                 if b["tally"] == "vc_round"]
    k8_nodes = sorted({b["kernel_nodes"] for b in k8_bodies})
    rec = {"phase": "main_path_headline", **{k: row_a[k] for k in (
        "n_c", "n_v", "deg", "seed", "rounds", "first_ms", "ms", "reps_ms",
        "path", "chain_fell_back", "uploaded_bytes_first", "launches")},
           "stages_per_solve": st_a // 4, "cpu_stages": st_ca,
           "cpu_wall_s": cpu_a_s, "held_chain": held_a,
           "dense": {k: row_b[k] for k in ("rounds", "first_ms", "ms",
                                           "path", "launches")},
           "held_dense": held_b,
           "overflow": {k: row_c[k] for k in ("rounds", "first_ms", "path",
                                              "chain_fell_back",
                                              "launches")},
           "held_overflow_equals_dense": held_c,
           "chain_equals_dense_rounds": res_a[3] == res_b[3],
           "after_first": row_a["after_first"],
           "k8_nodes_per_round": k8_nodes,
           "variants": variants}
    log(rec)
    report["main_path_headline"] = rec
    if row_a["path"] != "chain" or row_a["chain_fell_back"]:
        raise AssertionError("headline: the default path is not the chain")
    if not (held_a and held_b and held_c):
        raise AssertionError(f"headline: card differs from plain "
                             f"(chain {held_a}, dense {held_b}, "
                             f"overflow {held_c})")
    for key, v in variants.items():
        if not v["held"] or v["path"] != "chain":
            raise AssertionError(f"headline ({key}): the chain on the card "
                                 f"differs from the plain chain: {v}")
    after = row_a["after_first"]
    if after["graph_builds"] or any(after["host_calls"].values()):
        raise AssertionError(f"headline: a solve after the first built a "
                             f"graph or called K8/K9 from the host: {after}")
    if k8_nodes != [K8_ROUND_LAUNCHES] or any(
            b["cond_nodes"] or not b["ends"] for b in k8_bodies):
        raise AssertionError(f"headline: K8's round bodies are not "
                             f"{K8_ROUND_LAUNCHES} kernel nodes that end "
                             f"their iteration: {k8_bodies}")
    for name in ("vc_round", "vc_prep", "ell_chain_arm", "ell_chain_stage",
                 "ell_chain_fetch", "superstep_loop_chain"):
        if la.get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched on the headline")
    need_loop(row_a, "the headline", "chain", "vc_round")
    for name in ("ell_init", "vc_round"):
        if row_b["launches"].get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched on the dense path")

    # K7's init and K8 at the headline's shapes, from the dense path's
    # device system (the upload cache's entry)
    sys_h, pen_h, vb_h = lmm_ell.dense_system(hl_ell, cuda)
    sys_hc = sys_h._replace(**{f: getattr(sys_h, f).cpu()
                               for f in sys_h._fields})
    wh = EllWork(sys_h.n_v, sys_h.n_c, sys_h.wc, f64, cuda)
    whc = EllWork(sys_h.n_v, sys_h.n_c, sys_h.wc, f64, cpu)
    ell_init(sys_h, wh, pen_h, HL_EPS, vb_h)
    ell_init_plain(sys_hc, whc, pen_h.cpu(), HL_EPS)
    ell_state = ("v_value", "v_fixed", "remaining", "usage", "light",
                 "cv_live")

    def ell_held(wg_, wc_, extra=()):
        return all(same_bits(getattr(wg_, n).cpu().numpy(),
                             getattr(wc_, n).numpy())
                   for n in ell_state + tuple(extra)) \
            and same_bits(wg_.ctrl.cpu().numpy()[:2], wc_.ctrl.numpy()[:2])
    err_k7i = 0.0 if ell_held(wh, whc, ("rou",)) else float("inf")
    # K7's prep from it: rou and each cv entry's w / penalty and enabled
    # flag, card against plain, before K8's prep
    ell_prep(sys_h, wh, pen_h, vb_h)
    ell_prep_plain(sys_hc, whc, pen_h.cpu())
    err_prep7 = 0.0 if all(same_bits(getattr(wh, n).cpu().numpy(),
                                     getattr(whc, n).numpy())
                           for n in ("rou", "cv_upen", "cv_ev")) \
        else float("inf")
    # K8's prep from it: each constraint's rou and each entry's w /
    # penalty, card against plain
    vc_prep(sys_h, wh, pen_h)
    vc_prep_plain(sys_hc, whc, pen_h.cpu())
    n_h = int(sys_h.vcx_ptr[-1])
    err_prep = 0.0 if (same_bits(wh.rou.cpu().numpy(), whc.rou.numpy())
                       and same_bits(sys_h.vcx_upen[:n_h].cpu().numpy(),
                                     sys_hc.vcx_upen[:n_h].numpy())) \
        else float("inf")
    # the first 8 K8 rounds from it, card against plain (rou included)
    for _ in range(8):
        vc_round(sys_h, wh, pen_h, HL_EPS)
        vc_round_plain(sys_hc, whc, pen_h.cpu(), HL_EPS)
    err_k8 = 0.0 if ell_held(wh, whc, ("rou",)) else float("inf")
    if err_k7i or err_k8 or err_prep or err_prep7:
        raise AssertionError(f"headline: K7 init / K8 / K8's prep / K7's "
                             f"prep differ from plain ({err_k7i}, {err_k8}, "
                             f"{err_prep}, {err_prep7})")
    r_h = res_b[3]
    k7i_ms = events_ms(lambda: ell_init(sys_h, wh, pen_h, HL_EPS, vb_h), 10)
    k7i_t = time_call(lambda: ell_init(sys_h, wh, pen_h, HL_EPS, vb_h))
    k7i_plain = events_ms(lambda: ell_init_plain(sys_h, wh, pen_h, HL_EPS),
                          2)
    prep_t = time_call(lambda: vc_prep(sys_h, wh, pen_h))
    prep_ms = events_ms(lambda: vc_prep(sys_h, wh, pen_h), 10)
    prep_plain = events_ms(lambda: vc_prep_plain(sys_h, wh, pen_h), 3)
    prep7_t = time_call(lambda: ell_prep(sys_h, wh, pen_h, vb_h))
    prep7_ms = events_ms(lambda: ell_prep(sys_h, wh, pen_h, vb_h), 10)
    prep7_plain = events_ms(lambda: ell_prep_plain(sys_h, wh, pen_h), 3)
    # per cv entry its variable, weight, validity and penalty read and
    # its w / penalty and flag written; rou from remaining, usage, light
    prep7_bytes = (sys_h.n_c * sys_h.wc * (4 + 8 + 1 + 8 + 8 + 1)
                   + nbytes(wh.remaining, wh.usage, wh.light, wh.rou))
    # rou written, remaining/usage/light read, per entry its row, weight
    # and penalty read and its w / penalty written
    prep_bytes = (nbytes(wh.remaining, wh.usage, wh.light, wh.rou)
                  + n_h * (4 + 8 + 8 + 8))

    def round_ms(init_fn, rnd_fn, rounds, n):
        def solve():
            init_fn()
            for _ in range(rounds):
                rnd_fn()
        return (events_ms(solve, n) - events_ms(init_fn, n)) / rounds

    def k8_init():
        ell_init(sys_h, wh, pen_h, HL_EPS, vb_h)
        vc_prep(sys_h, wh, pen_h)

    def k8_round():
        vc_round(sys_h, wh, pen_h, HL_EPS)
    k8_ms = round_ms(k8_init, k8_round, r_h, 3)
    # the card's own time a round: the rounds queued behind a sleep
    k8_t = time_rounds(k8_init, k8_round, r_h)
    k8_plain = round_ms(lambda: ell_init_plain(sys_h, wh, pen_h, HL_EPS),
                        lambda: vc_round_plain(sys_h, wh, pen_h, HL_EPS),
                        r_h, 1)
    # the CUDA kernels a round launches (its nodes inside K16's loop: the
    # last one ends the loop's iteration, so there is no loop_cond node)
    k8_init()
    k8_launches = launch_gate("K8's round", k16.kernel_nodes(k8_round),
                              K8_ROUND_LAUNCHES, exact=True)
    # bytes: the tables read once, penalties and bounds, the state read
    # and written once (K8: the vc tables and K8's layout are the design's
    # pick; the function reads each element once, here its vc entry)
    cv_b = nbytes(sys_h.cv_var, sys_h.cv_w, sys_h.cv_valid)
    vc_b = nbytes(sys_h.vc_cnst, sys_h.vc_w, sys_h.vc_valid)
    state_b = nbytes(wh.v_value, wh.v_fixed, wh.remaining, wh.usage,
                     wh.light)
    k7i_bytes = (cv_b + nbytes(sys_h.c_bound, sys_h.c_fatpipe, pen_h)
                 + state_b + nbytes(wh.cv_live))
    k8_bytes = (vc_b + nbytes(sys_h.c_bound, pen_h) + 2 * state_b)

    # K8 at every chain stage's shape (131,072, 65,536, 32,768, 16,384
    # and 8,192 rows) and K9's stages, card against plain in lockstep from
    # the headline's init: each stage's rounds under its guard, every
    # state by bits; then the stage, every array it writes by bits
    chain_sys, chain_pen = lmm_ell.device_args(
        "vc_chain", [hl_ell.vc_cnst, hl_ell.vc_w, hl_ell.vc_valid,
                     hl_ell.v_penalty, hl_ell.c_bound, hl_ell.c_fatpipe],
        cuda, make=lmm_ell._chain_tables)
    init_h = lmm_ell.device_args(
        "vc_chain_init", lmm_ell.chain_init(hl_ell, HL_EPS, False), cuda)
    halves_h = lmm_ell.chain_halves(chain_sys.n_v)
    arms_h = [(lmm_ell._CHAIN_STAGE_CAP, h) for h in halves_h] + [(-1, -1)]

    def chain_start(dev):
        sys_ = chain_sys if dev == cuda else chain_sys._replace(
            **{f: (None if getattr(chain_sys, f) is None
                   else getattr(chain_sys, f).cpu())
               for f in chain_sys._fields})
        w_ = Work(chain_sys.n_v, chain_sys.n_c, f64, dev)
        for t, src in zip((w_.v_value, w_.v_fixed, w_.remaining, w_.usage,
                           w_.light), init_h[:5]):
            t.copy_(src)
        cs_ = k9.ChainState(sys_, chain_pen.to(dev), init_h[5].to(dev), w_)
        vc_prep(cs_.sys, w_, cs_.pen)
        k9.chain_arm(cs_, *arms_h[0], True)
        return cs_

    def chain_state(cs_):
        n = cs_.sys.n_v
        return [cs_.w.v_value[:n], cs_.w.v_fixed[:n], cs_.w.remaining,
                cs_.w.usage, cs_.w.light, cs_.w.ctrl, cs_.w.rou]

    def stage_out(cs_):
        n = int(cs_.sys.vcx_ptr[-1])
        return [cs_.sys.vc_cnst, cs_.sys.vc_w, cs_.sys.vc_valid, cs_.pen,
                cs_.orig, cs_.v_final, cs_.sys.vcx_ptr] + chain_state(cs_) \
            + [getattr(cs_.sys, k)[:n] for k in (
                "vcx_idx", "vcx_row", "vcx_w", "vcx_upen")]

    def held_all(xs, ys):
        return all(same_bits(x.cpu().numpy(), y.numpy())
                   for x, y in zip(xs, ys))
    csg, csc = chain_start(cuda), chain_start(cpu)
    stages11, snap9 = [], None
    for k in range(len(halves_h) + 1):
        rows_k, it0 = csg.sys.n_v, int(csg.w.ctrl[IT])
        while round_runs(csg.w.ctrl.cpu()):
            for _ in range(16):
                vc_round(csg.sys, csg.w, csg.pen, HL_EPS)
        while vc_round_plain(csc.sys, csc.w, csc.pen, HL_EPS):
            pass
        st = {"rows": rows_k, "rounds": int(csg.w.ctrl[IT]) - it0,
              "entries": int(csg.sys.vcx_ptr[-1]),
              "k8_held": held_all(chain_state(csg), chain_state(csc))}
        if k < len(halves_h):
            if k == 0:
                snap9 = {n: getattr(csg.w, n).clone() for n in (
                    "v_value", "v_fixed", "remaining", "usage", "light",
                    "ctrl", "rou")}
            k9.chain_stage(csg, halves_h[k], arms_h[k + 1])
            k9.chain_stage_plain(csc, halves_h[k], arms_h[k + 1])
            st["k9_held"] = held_all(stage_out(csg), stage_out(csc))
            st["kept_entries"] = int(csg.sys.vcx_ptr[-1])
        stages11.append(st)
        log({"phase": "chain_stage_held", **st})
    if not all(st["k8_held"] and st.get("k9_held", True)
               for st in stages11):
        raise AssertionError(f"headline chain: K8 or K9 differs from its "
                             f"plain version at a stage: {stages11}")
    err_k9 = 0.0
    v0h, half_h = chain_sys.n_v, halves_h[0]

    def k9_setup():
        csg.reset(chain_sys, chain_pen, init_h[5])
        for n, t in snap9.items():
            getattr(csg.w, n).copy_(t)
    k9_fn = lambda: k9.chain_stage(csg, half_h, arms_h[1])
    k9_t = time_call(k9_fn, k9_setup)
    k9_ms = events_ms(k9_fn, 10, k9_setup)
    k9_setup()
    k9_launches = launch_gate("K9's stage", k16.kernel_nodes(k9_fn),
                              K9_STAGE_LAUNCHES, exact=True)
    k9_plain = events_ms(lambda: k9.chain_stage_plain(csg, half_h,
                                                      arms_h[1]),
                         2, k9_setup)
    # what JAX's stage moves: rows in and out (the tables, penalty,
    # original slot, value, fixed) and v_final written; of the entries,
    # only the index the in-order folds need (the pointers and a 4-byte
    # position an entry, in and out): the entries' rows, weights and w /
    # penalty are K8's layout, the design's pick, as in K8's bound
    row_b9 = chain_sys.vc_cnst.shape[1] * (4 + 8 + 1) + 8 + 4 + 8 + 1
    ent_in, ent_out = stages11[0]["entries"], stages11[0]["kept_entries"]
    k9_bytes = (v0h * row_b9 + half_h * row_b9 + 8 * v0h
                + 4 * (ent_in + ent_out) + 8 * (chain_sys.n_c + 1))
    del csg, csc, snap9

    # K7's round arms, held whole at the same widths, timed at full width
    rates_h = res_b[0]
    rng11 = np.random.default_rng(11)

    def bounded(a, rates, share):
        vb_ = a.v_bound.copy()
        sel = np.zeros(len(vb_), bool)
        sel[:a.n_var] = rng11.random(a.n_var) < share
        vb_[sel] = rates[sel] * rng11.uniform(0.5, 1.5, int(sel.sum()))
        return a._replace(v_bound=vb_)

    def fatpiped(a):
        fat = a.c_fatpipe.copy()
        fat[:a.n_cnst] = np.random.default_rng(12).random(a.n_cnst) < 0.10
        return a._replace(c_fatpipe=fat)

    def ell_arm(label, small, full, local, kernel):
        """Whole solve of ``small`` on the card and plain on the CPU
        (bits, rounds); ms per round over up to 64 rounds of ``full``."""
        reset_launch_counts()
        g = solve_arrays(small, HL_EPS, device=cuda, parallel_rounds=local,
                         layout="ell", chain="off")
        launches = path_counts()
        t0_ = time.perf_counter()
        c = solve_arrays(small, HL_EPS, device=cpu, parallel_rounds=local,
                         layout="ell", chain="off")
        cpu_s = time.perf_counter() - t0_
        err = 0.0 if same_result(g, c) else float("inf")
        if err or launches.get(kernel, 0) <= 0:
            raise AssertionError(f"K7 {label}: card differs from plain or "
                                 f"{kernel} did not launch")
        # the round loop's body as the solve's graph holds it
        tally = "vc_round" if kernel == "vc_round" else "ell_round"
        bodies = [b for b in k16.bodies() if b["tally"] == tally]
        if not bodies or any(b["cond_nodes"] or not b["ends"]
                             for b in bodies):
            raise AssertionError(f"K7 {label}: a round body holds a "
                                 f"loop_cond node or does not end itself: "
                                 f"{bodies}")
        if kernel != "vc_round" and launches.get("ell_prep", 0) <= 0:
            raise AssertionError(f"K7 {label}: ell_prep did not launch")
        e = lmm_ell.ell_from_arrays(full)
        s_, p_, vb_ = lmm_ell.dense_system(e, cuda)
        w_ = EllWork(s_.n_v, s_.n_c, s_.wc, f64, cuda)
        fat = bool(full.c_fatpipe.any())
        if kernel == "vc_round":
            rnd = lambda f: (lambda: f(s_, w_, p_, HL_EPS, fat))
            k, pl = vc_round, vc_round_plain
        else:
            rnd = lambda f: (lambda: f(s_, w_, p_, HL_EPS, vb_, fat,
                                       not local))
            k, pl = ell_round, ell_round_plain
        full_r = solve_arrays(full, HL_EPS, device=cuda,
                              parallel_rounds=local, layout="ell",
                              chain="off")[3]
        r_t = min(full_r, 64)
        def init_():
            ell_init(s_, w_, p_, HL_EPS, vb_)
            if kernel == "vc_round":
                vc_prep(s_, w_, p_)
            else:
                ell_prep(s_, w_, p_, vb_)
        ms = round_ms(init_, rnd(k), r_t, 2)
        card = time_rounds(init_, rnd(k), r_t)
        # the same rounds inside K16's loop: the solve's chunk loop capped
        # at them, one graph launch after the init (median of 3)
        loop = lmm_torch.chunk_loop(s_, w_, p_, HL_EPS, vb_,
                                    kernel != "vc_round", fat, not local,
                                    r_t)
        loop_ms = []
        for rep_ in range(4):
            ell_init(s_, w_, p_, HL_EPS, vb_)
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            e0.record()
            loop.run()
            e1.record()
            torch.cuda.synchronize()
            if rep_:
                loop_ms.append(e0.elapsed_time(e1) / r_t)
        if int(w_.ctrl[IT]) != r_t:
            raise AssertionError(f"K7 {label}: the loop ran "
                                 f"{int(w_.ctrl[IT])} rounds, not {r_t}")
        plain = round_ms(lambda: ell_init_plain(s_, w_, p_, HL_EPS),
                         rnd(pl), min(r_t, 8), 1)
        b = (nbytes(s_.cv_var, s_.cv_w, s_.cv_valid, s_.vc_cnst, s_.vc_valid,
                    s_.c_bound, s_.c_fatpipe, p_, vb_)
             + 2 * nbytes(w_.v_value, w_.v_fixed, w_.remaining, w_.usage,
                          w_.light, w_.cv_live))
        rec_ = {"phase": "ell_arm", "case": label, "rounds": g[3],
                "n_c": small.n_cnst, "n_v": small.n_var,
                "widths": [int(lmm_ell.ell_from_arrays(small).cv_var
                               .shape[1]), int(e.vc_cnst.shape[1])],
                "full_rounds": full_r, "timed_rounds": r_t,
                "max_abs_err": err, "ms": card["ms"], "paced_ms": ms,
                "queued": card["queued"], "loop_ms": sorted(loop_ms)[1],
                "loop_ms_spread": [min(loop_ms), max(loop_ms)],
                "plain_ms": plain, "bound_ms": bound_ms(b),
                "cpu_s": cpu_s, "launches": launches,
                "nodes_per_round": bodies[0]["kernel_nodes"],
                "bodies": bodies}
        log(rec_)
        return rec_

    small = bench_solve.build_arrays(np.random.default_rng(42),
                                     ARMS_CLASS["n_c"], ARMS_CLASS["n_v"],
                                     ARMS_CLASS["deg"], np.float64)
    small_rates = solve_arrays(small, HL_EPS, device=cuda, layout="ell",
                               chain="off")[0]
    small_b = bounded(small, small_rates, 0.3)
    full_b = bounded(hl, rates_h, 0.3)
    arms11 = {
        "bounds": ell_arm("bound-first rule, 30% of flows bounded",
                          small_b, full_b, True, "ell_round"),
        "fatpipe_bounds": ell_arm("FATPIPE (10% of constraints) with bounds",
                                  fatpiped(small_b), fatpiped(full_b), True,
                                  "ell_round"),
        "fatpipe_vc": ell_arm("FATPIPE (10% of constraints), bound-free",
                              fatpiped(small), fatpiped(hl), True,
                              "vc_round"),
    }
    big = bench_solve.build_arrays(np.random.default_rng(42), 2000, 2000, 3,
                                   np.float64)
    arms11["global"] = ell_arm("global order, bench.py's big class "
                               "(2,000 x 2,000, degree 3)", big, big,
                               False, "ell_round_global")
    report["ell_arms"] = arms11

    kernels.append(dict(
        name="ell_init", route="cuda",
        source="simgrid_tpu_torch/csrc/ell_round.cu",
        replaces="simgrid_tpu/ops/lmm_jax.py:219",
        launches=row_b["launches"]["ell_init"], max_abs_err=err_k7i,
        ms=k7i_t["ms"], paced_ms=k7i_ms, queued=k7i_t["queued"],
        plain_ms=k7i_plain, bound_ms=bound_ms(k7i_bytes),
        bound_by="bytes", library_ms=None,
        launches_from="phase 11(b), the headline with the chain off "
                      "(1 + 3 solves)"))
    kernels.append(dict(
        name="vc_round", route="cuda",
        source="simgrid_tpu_torch/csrc/vc_round.cu",
        replaces="simgrid_tpu/ops/lmm_jax.py:629",
        launches=la["vc_round"], max_abs_err=err_k8, ms=k8_t["ms"],
        paced_ms=k8_ms, queued=k8_t["queued"],
        plain_ms=k8_plain, bound_ms=bound_ms(k8_bytes), bound_by="bytes",
        library_ms=None, timed_on=f"headline dense, {r_h} rounds",
        cuda_launches_per_round=k8_launches,
        held_at_stages=[(st["rows"], st["rounds"]) for st in stages11],
        host_calls=row_a["loop"]["host_round_calls"].get("vc_round", 0),
        device_rounds=row_a["loop"]["device_tally"].get("vc_round", 0),
        launches_from="main path 6, the headline chain (1 + 3 solves; "
                      "every round inside the chain's K16 graph)"))
    kernels.append(dict(
        name="vc_prep", route="cuda",
        source="simgrid_tpu_torch/csrc/vc_round.cu",
        replaces="simgrid_tpu/ops/lmm_jax.py:649",
        note="K8's rou and w / penalty (JAX's vc_upen_v, :649-651), "
             "written once a chain or chunk",
        launches=la["vc_prep"], max_abs_err=err_prep, ms=prep_t["ms"],
        paced_ms=prep_ms, queued=prep_t["queued"], plain_ms=prep_plain,
        bound_ms=bound_ms(prep_bytes), bound_by="bytes", library_ms=None,
        launches_from="main path 6, the headline chain (once a solve, "
                      "inside its graph)"))
    kernels.append(dict(
        name="ell_prep", route="cuda",
        source="simgrid_tpu_torch/csrc/ell_round.cu",
        replaces="simgrid_tpu/ops/lmm_jax.py:219",
        note="K7's rou and w / penalty (JAX's cv_upen, :219-222), "
             "written once a chunk",
        launches=sum(arms11[k_]["launches"].get("ell_prep", 0)
                     for k_ in ("bounds", "fatpipe_bounds", "global")),
        max_abs_err=err_prep7, ms=prep7_t["ms"], paced_ms=prep7_ms,
        queued=prep7_t["queued"], plain_ms=prep7_plain,
        bound_ms=bound_ms(prep7_bytes), bound_by="bytes", library_ms=None,
        launches_from="phase 11(d), K7's arms (once a chunk, inside the "
                      "chunk's graph; not on a main path)"))
    kernels.append(dict(
        name="ell_chain_stage", route="cuda",
        source="simgrid_tpu_torch/csrc/ell_chain.cu",
        replaces="simgrid_tpu/ops/lmm_jax.py:736",
        launches=la["ell_chain_stage"], max_abs_err=err_k9, ms=k9_t["ms"],
        paced_ms=k9_ms, queued=k9_t["queued"], plain_ms=k9_plain,
        bound_ms=bound_ms(k9_bytes), bound_by="bytes",
        library_ms=None, launches_arm=la["ell_chain_arm"],
        launches_fetch=la["ell_chain_fetch"], cuda_launches=k9_launches,
        timed_on=f"first stage, {v0h} -> {half_h} rows",
        launches_from="main path 6, the headline chain (1 + 3 solves, "
                      "inside its graph; one arm and one fetch a solve)"))
    for key, name, ln in (("bounds", "ell_round", ":325"),
                          ("fatpipe_bounds", "ell_round_fatpipe", ":287"),
                          ("global", "ell_round_global", ":301")):
        r_ = arms11[key]
        kernels.append(dict(
            name=name, route="cuda",
            source="simgrid_tpu_torch/csrc/ell_round.cu",
            replaces=f"simgrid_tpu/ops/lmm_jax.py{ln}",
            launches=r_["launches"].get(
                "ell_round_global" if key == "global" else "ell_round", 0),
            max_abs_err=r_["max_abs_err"], ms=r_["ms"],
            paced_ms=r_["paced_ms"], queued=r_["queued"],
            loop_ms=r_["loop_ms"], nodes_per_round=r_["nodes_per_round"],
            plain_ms=r_["plain_ms"], bound_ms=r_["bound_ms"],
            bound_by="bytes", library_ms=None,
            launches_from=f"phase 11(d) {r_['case']} (not on a main path: "
                          f"the headline and the churn are bound-free and "
                          f"local)"))
    torch.cuda.empty_cache()

    # ---- 12. main path 7: the 100k churn under the default layout -------
    rows12, states12 = {}, {}
    for mode in churn.MODES:
        sys12, row = churn.run_churn(mode, device=cuda, states=True,
                                     strict=True, **CHURN)
        states12[mode] = row.pop("states")
        rows12[mode] = row
        log({"phase": "churn_ell", **row})
        if mode == "warm-selective":
            warm12 = sys12
        del sys12
    cpu12 = {}
    t0 = time.perf_counter()
    for mode in ("warm-selective", "legacy-subset"):
        cpu12[mode] = churn.run_churn(mode, device=cpu, states=True,
                                      strict=True, layout="ell",
                                      chain_mode="on", **CHURN)[1]
    cpu12_s = time.perf_counter() - t0
    held12 = {f"{m} vs plain CPU": same_states(states12[m],
                                                cpu12[m]["states"])
              for m in cpu12}
    for mode in ("cold-full", "cold-delta"):
        held12[f"{mode} vs warm-selective"] = same_states(
            states12[mode], states12["warm-selective"])
    wl12 = rows12["warm-selective"]["launches"]
    rec = {"phase": "main_path_churn_ell", "held": held12,
           "cpu_wall_s": cpu12_s,
           "layouts": {m: r["last_layout"] for m, r in rows12.items()},
           "warm_ell_fallbacks": {m: r["warm_ell_fallbacks"]
                                  for m, r in rows12.items()},
           "rounds_warm_over_cold": (
               sum(rows12["warm-selective"]["rounds"])
               / sum(rows12["cold-delta"]["rounds"]))}
    log(rec)
    report["main_path_churn_ell"] = {**rec, "rows": rows12}
    if not all(held12.values()):
        raise AssertionError(f"churn (ELL): states differ: {held12}")
    if any(r["solver_fallbacks"] for r in rows12.values()):
        raise AssertionError("churn (ELL): a solve fell back to the host")
    for mode in ("cold-full", "cold-delta", "warm-selective"):
        if rows12[mode]["last_layout"] != "ell" \
                or rows12[mode]["warm_ell_fallbacks"]:
            raise AssertionError(f"churn (ELL): {mode} left the ELL layout")
    for name in ("ell_init", "vc_round", "warm_init_ell", "delta_scatter",
                 "delta_scatter_ell"):
        if wl12.get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched on the ELL churn")
    del states12, cpu12

    # K6's ELL arm and K5's ELL deltas at the churn's shapes, from the
    # resident ELL state the warm-selective run left on the card
    st12 = warm12.warm_solver._states[np.dtype(np.float64)]
    e12, pen12 = st12.ell, st12.masters[5]
    e12c = e12._replace(**{f: getattr(e12, f).cpu() for f in e12._fields})
    n_c12, wc12, n_v12, wv12 = st12.ell_shape
    carry12 = {n: getattr(st12.ell_work, n).clone()
               for n in ("v_value", "remaining", "usage", "cv_live")}
    rng12 = np.random.default_rng(9)
    mc12 = np.unique(CHURN["chain"] + rng12.integers(
        0, CHURN["clusters"], 999)).astype(np.int32)
    mc12_h = modified_index(mc12)
    mc12_g = torch.from_numpy(mc12_h).to(cuda)
    w12g = EllWork(n_v12, n_c12, wc12, f64, cuda)
    w12c = EllWork(n_v12, n_c12, wc12, f64, cpu)

    def k6e_setup():
        for n, t in carry12.items():
            getattr(w12g, n).copy_(t)
    k6e_setup()
    warm_init_ell(e12, w12g, pen12, mc12_h, EPS)
    for n, t in carry12.items():
        getattr(w12c, n).copy_(t.cpu())
    warm_init_ell_plain(e12c, w12c, pen12.cpu(), mc12_g.cpu(), EPS)
    # every output the plain version writes, the whole control row too
    err = 0.0 if ell_held(w12g, w12c, ("c_mod", "v_mod", "v_has", "ctrl")) \
        else float("inf")
    if err != 0.0:
        raise AssertionError("K6 (ELL) differs from its plain version")
    k6e_launches = launch_gate("K6 (ELL)", k16.kernel_nodes(
        lambda: warm_init_ell(e12, w12g, pen12, mc12_h, EPS)),
        K6_MAX_LAUNCHES)
    k6e_ms = events_ms(lambda: warm_init_ell(e12, w12g, pen12, mc12_h, EPS),
                       20, k6e_setup)
    k6e_t = time_call(lambda: warm_init_ell(e12, w12g, pen12, mc12_h, EPS),
                      k6e_setup)
    k6e_plain = events_ms(lambda: warm_init_ell_plain(e12, w12g, pen12,
                                                      mc12_g, EPS), 5,
                          k6e_setup)
    k6e_bytes = (nbytes(e12.cv_var, e12.cv_w, e12.cv_valid, e12.c_bound,
                        e12.c_fatpipe, pen12, mc12_g)
                 + 2 * nbytes(*carry12.values())
                 + nbytes(w12g.v_fixed, w12g.light))
    kernels.append(dict(
        name="warm_init_ell", route="cuda",
        source="simgrid_tpu_torch/csrc/warm_init.cu",
        replaces="simgrid_tpu/ops/lmm_warm.py:158",
        launches=wl12["warm_init_ell"], max_abs_err=err, ms=k6e_t["ms"],
        paced_ms=k6e_ms, queued=k6e_t["queued"], plain_ms=k6e_plain,
        bound_ms=bound_ms(k6e_bytes), bound_by="bytes", library_ms=None,
        cuda_launches_per_call=k6e_launches, modified_constraints=len(mc12),
        launches_from="main path 7 (the 100k churn in ELL, "
                      "warm-selective)"))
    log({"phase": "kernel", **kernels[-1]})
    del w12g, w12c

    # K5's ELL use: a churn step's element delta (about 1,000 new
    # elements) as six flat runs, values from the resident tables
    host12 = [t.cpu().numpy() for t in (e12.cv_var, e12.cv_w, e12.cv_valid,
                                         e12.vc_cnst, e12.vc_valid,
                                         e12.vc_w)]
    k12 = 999
    cv_ix = np.sort(rng12.choice(n_c12 * wc12, k12, replace=False))
    vc_ix = np.sort(rng12.choice(n_v12 * wv12, k12, replace=False))
    n12 = bucket(k12, floor=8)
    runs12 = []
    for ti, ix in ((0, cv_ix), (1, cv_ix), (2, cv_ix), (3, vc_ix),
                   (4, vc_ix), (5, vc_ix)):
        # a validity run carries its entries' weights (written as w > 0)
        src = host12[{2: 1, 4: 5}.get(ti, ti)].reshape(-1)[ix] \
            .astype(np.float64)
        idx = np.full(n12, float(ix[0]))
        vals = np.full(n12, src[0])
        idx[:k12], vals[:k12] = ix, src
        runs12 += [idx, vals]
    pay12 = torch.from_numpy(np.concatenate(runs12))
    pay12_g = pay12.to(cuda)
    lay12 = [(ti, 2 * n12 * ti, n12) for ti in range(6)]
    tg12 = [t.clone() for t in (e12.cv_var, e12.cv_w, e12.cv_valid,
                                e12.vc_cnst, e12.vc_valid, e12.vc_w)]
    tc12 = [t.cpu() for t in tg12]
    ell_delta_scatter(pay12_g, lay12, tg12)
    transition_scatter_plain(pay12, lay12, tc12, ELL_POSITIVE)
    err = 0.0 if all(same_bits(a.cpu().numpy(), b.numpy())
                     for a, b in zip(tg12, tc12)) else float("inf")
    if err != 0.0:
        raise AssertionError("K5 (ELL) differs from its plain version")
    k5e_launches = launch_gate("K5 (ELL)", k16.kernel_nodes(
        lambda: ell_delta_scatter(pay12_g, lay12, tg12)), K5_LAUNCHES,
        exact=True)
    k5e_ms = events_ms(lambda: ell_delta_scatter(pay12_g, lay12, tg12), 20)
    k5e_plain = events_ms(lambda: transition_scatter_plain(
        pay12_g, lay12, tg12, ELL_POSITIVE), 5)

    def library_k5e():
        for ti, o, n in lay12:
            v = pay12_g[o + n:o + 2 * n]
            tg12[ti].view(-1).index_put_(
                (pay12_g[o:o + n].long(),),
                v > 0 if ti in ELL_POSITIVE else v.to(tg12[ti].dtype))
    k5e_lib = events_ms(library_k5e, 20)
    k5e_t = time_call(lambda: ell_delta_scatter(pay12_g, lay12, tg12))
    k5e_lib_t = time_call(library_k5e)
    k5e_bytes = 16 * 6 * n12 + sum(n12 * t.element_size() for t in tg12)
    kernels.append(dict(
        name="delta_scatter_ell", route="cuda",
        source="simgrid_tpu_torch/csrc/transition_scatter.cu",
        replaces="simgrid_tpu/ops/lmm_warm.py:141",
        launches=wl12["delta_scatter_ell"], max_abs_err=err,
        ms=k5e_t["ms"], paced_ms=k5e_ms, queued=k5e_t["queued"],
        plain_ms=k5e_plain, bound_ms=bound_ms(k5e_bytes), bound_by="bytes",
        library_ms=k5e_lib_t["ms"], library_paced_ms=k5e_lib,
        library="index_put_, one call per run",
        cuda_launches_per_call=k5e_launches, slots=6 * n12,
        launches_from="main path 7 (the 100k churn in ELL, "
                      "warm-selective)"))
    log({"phase": "kernel", **kernels[-1]})
    del warm12, st12, e12, tg12, tc12
    torch.cuda.empty_cache()

    # ---- 13. main path 8: the config-#4 drain under a fault tape --------
    names13 = dragonfly.link_names(dsys)
    t0 = time.perf_counter()
    tape13 = fault_drain.tape_for(dsys.e_cnst, dsys.e_w, dsys.c_bound,
                                  link_names=names13, **FAULT)
    tape13_s = time.perf_counter() - t0
    # K4's time per repack inside this run (CUDA events around each
    # call; the drain is idle between supersteps when it repacks)
    k4_calls = []
    k4_real = lmm_drain_mod.livefirst_repack

    def k4_timed(*args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = k4_real(*args, **kw)
        e1.record()
        e1.synchronize()
        k4_calls.append(e0.elapsed_time(e1))
        return out
    lmm_drain_mod.livefirst_repack = k4_timed
    try:
        sim13, row13 = fault_drain.run_fault_drain(dsys, tape13,
                                                   device=cuda, superstep=K)
    finally:
        lmm_drain_mod.livefirst_repack = k4_real
    c13 = row13["launches"]
    for name in ("lmm_init", "lmm_round", "drain_advance_event",
                 "superstep_commit_tape", "livefirst_repack"):
        if c13.get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched on main path 8")
    row13["k16"] = need_loop(row13, "main path 8", "superstep", "lmm_round",
                             row13["supersteps"])
    if row13["fires"] <= MIN_FIRES:
        raise AssertionError(f"faulted drain: {row13['fires']} fires, "
                             f"expected more than {MIN_FIRES}")
    # (a) the same drain under a tape whose dates all lie past its end:
    # the arm peeks on every advance and never fires
    late13 = (tape13[0] + 10.0 * drain3[1] + 1.0, tape13[1], tape13[2])
    sim13a, row13a = fault_drain.run_fault_drain(dsys, late13, device=cuda,
                                                 superstep=K)
    held13a = (sim13a.events == drain3[0] and sim13a.t == drain3[1]
               and not sim13a.fault_events)
    # (b) 10,000 flows with their own campaign at the same rates, card
    # against the plain path on the host CPU
    tape13b = fault_drain.tape_for(rsys.e_cnst, rsys.e_w, rsys.c_bound,
                                   link_names=dragonfly.link_names(rsys),
                                   **FAULT)
    res13b = {name: fault_drain.run_fault_drain(rsys, tape13b, device=dev,
                                                superstep=K)
              for name, dev in (("cuda", cuda), ("cpu", cpu))}
    g13b, c13b = res13b["cuda"][0], res13b["cpu"][0]
    held13b = (g13b.events == c13b.events and g13b.t == c13b.t
               and g13b.fault_events == c13b.fault_events)
    rec = {"phase": "main_path_fault_drain", **row13,
           "tape_build_s": tape13_s, "k4_ms_per_repack": k4_calls,
           "fault_events_first": sim13.fault_events[:3],
           "a_unfired_tape_equals_phase_3": held13a,
           "a_wall_s": row13a["wall_s"],
           "b_flows": REDUCED_FLOWS, "b_tape_slots": len(tape13b[0]),
           "b_fires": len(g13b.fault_events), "b_advances": g13b.advances,
           "b_t_sim": g13b.t, "b_card_equals_cpu": held13b,
           "b_cuda_wall_s": res13b["cuda"][1]["wall_s"],
           "b_cpu_wall_s": res13b["cpu"][1]["wall_s"]}
    log(rec)
    report["main_path_fault_drain"] = rec
    if not held13a:
        raise AssertionError("faulted drain (a): an unfired tape moved "
                             "the config-#4 drain")
    if not held13b or not g13b.fault_events:
        raise AssertionError("faulted drain (b): card and plain CPU "
                             "differ, or no fault fired")
    del sim13a, res13b, g13b, c13b
    torch.cuda.empty_cache()

    # ---- 14. main path 9: bench.py's collective tapes --------------------
    rows14, legs14, tape14 = [], {}, {}
    c14 = {}
    for cs in collective_run.CASES:
        row, legs, _ = collective_run.run_case(cs, device=cuda)
        label = f"{cs.algo}-r{cs.ranks}"
        legs14[label] = (cs, legs)
        tape14[cs.ranks] = dict(
            t=legs["tape"]["events"][-1][0],
            wall_s=legs["tape"]["wall_ms"] / 1e3,
            **{k: legs["tape"][k] for k in ("events", "collective_events",
                                            "clock")})
        for leg, rec_ in legs.items():
            for name, n in rec_["launches"].items():
                c14[(leg, name)] = c14.get((leg, name), 0) + n
        rec = {"phase": "collective", "case": label,
               **{k: v for k, v in row.items() if k != "bench"},
               "k16": need_loop(legs["tape"], f"main path 9 ({label})",
                                "superstep", "lmm_round",
                                legs["tape"]["supersteps"]),
               "tape_launches": {n: v for n, v in
                                 legs["tape"]["launches"].items() if v},
               "maestro_launches": {n: v for n, v in
                                    legs["maestro"]["launches"].items()
                                    if v}}
        if cs.ranks <= 256:
            _, cpu_leg = collective_run.run_leg(cs.build(), "tape", cpu)
            rec["tape_equals_plain_cpu"] = collective_run.same_legs(
                legs["tape"], cpu_leg)
            rec["cpu_tape_wall_ms"] = cpu_leg["wall_ms"]
        log(rec)
        rows14.append(rec)
        bad = collective_run.recorded_mismatch(row)
        if bad or not row["events_bit_identical"] \
                or not rec.get("tape_equals_plain_cpu", True):
            raise AssertionError(f"collective {label}: {bad or rec}")
    for leg, names in (("tape", ("lmm_init", "lmm_round",
                                 "drain_advance_event",
                                 "superstep_commit_coll", "dag_walk")),
                       ("maestro", ("lmm_init", "lmm_round",
                                    "drain_forced_advance",
                                    "transition_scatter"))):
        for name in names:
            if c14.get((leg, name), 0) <= 0:
                raise AssertionError(f"{name} never launched on the "
                                     f"collective {leg} leg")
    report["main_path_collective"] = rows14

    # ---- 15. both arms at once: a link flip mid-collective ---------------
    cs15, legs15 = legs14[f"rdb-r{collective_run.CASES[2].ranks}"]
    dc15 = cs15.build()
    base15 = legs15["tape"]["events"]
    mid15 = base15[len(base15) // 2][0]
    ft15 = (np.asarray([mid15 * 0.7, mid15 * 1.3]),
            np.asarray([0, 0], np.int32),
            np.asarray([cs15.bw * 0.02, cs15.bw]))
    _, tape15 = collective_run.run_leg(dc15, "tape", cuda, tape=ft15)
    _, maes15 = collective_run.run_leg(dc15, "maestro", cuda, tape=ft15)
    held15 = collective_run.same_legs(tape15, maes15)
    rec = {"phase": "composed_arms", "case": f"rdb-r{cs15.ranks}",
           "tape": [list(map(float, ft15[0])), ft15[2].tolist()],
           "fault_events": tape15["fault_events"],
           "activations": len(tape15["collective_events"]),
           "tape_equals_maestro": held15,
           "events_moved": tape15["events"] != base15,
           "clock": tape15["clock"], "tape_wall_ms": tape15["wall_ms"],
           "maestro_wall_ms": maes15["wall_ms"],
           "tape_launches": {n: v for n, v in tape15["launches"].items()
                             if v}}
    log(rec)
    report["composed_arms"] = rec
    if not held15 or not tape15["fault_events"] \
            or tape15["events"] == base15:
        raise AssertionError(f"composed arms: {rec}")
    # a commit with both arms on counts once, as the collective arm; the
    # tape arm's runs show in the fault events checked above
    for name in ("superstep_commit_coll", "dag_walk"):
        if tape15["launches"].get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched on phase 15")
    del legs14, legs15, tape15, maes15

    # K2's event arm and K3's tape arm at phase 13's shapes: the first
    # advance of the config-#4 drain from its converged rates, which the
    # tape's first entry cuts short
    V13 = FLOWS
    tt13, ts13, tv13 = (torch.from_numpy(a) for a in tape13)
    tt13_g = tt13.to(cuda)
    tap13_g = (ts13.to(cuda), tv13.to(cuda))
    tap13_c = (ts13, tv13.clone())
    cb13 = torch.from_numpy(dsys.c_bound.copy())
    w13g = Work(V13, C, f64, cuda)
    w13c = Work(V13, C, f64, cpu)
    st13 = {}

    def k2e_setup(w, dev):
        st13[dev] = dict(pen=pen_g.to(dev, copy=True),
                         rem=rem0.to(dev, copy=True))
        w.v_value.copy_(rates_g)
        w.ctrl.zero_()
        w.fctrl.zero_()
        w.evf.zero_()
    k2e_setup(w13g, "cuda")
    drain_advance(st13["cuda"]["pen"], st13["cuda"]["rem"], thresh_g, w13g,
                  tape_t=tt13_g)
    k2e_setup(w13c, "cpu")
    drain_advance_plain(st13["cpu"]["pen"], st13["cpu"]["rem"], thresh0,
                        w13c, tape_t=tt13)
    torch.cuda.synchronize()
    err = max(diff(st13["cuda"]["pen"], st13["cpu"]["pen"]),
              diff(st13["cuda"]["rem"], st13["cpu"]["rem"]),
              diff(w13g.done, w13c.done), diff(w13g.fctrl, w13c.fctrl),
              diff(w13g.ctrl, w13c.ctrl), diff(w13g.evf, w13c.evf))
    if err != 0.0 or not int(w13c.ctrl[FFIRE]):
        raise AssertionError(f"K2's event arm differs from its plain "
                             f"version ({err}) or did not fire")
    def k2e_fn():
        drain_advance(st13["cuda"]["pen"], st13["cuda"]["rem"], thresh_g,
                      w13g, tape_t=tt13_g)
    k2e_ms = events_ms(k2e_fn, 20, lambda: k2e_setup(w13g, "cuda"))
    k2e_plain = events_ms(lambda: drain_advance_plain(
        st13["cuda"]["pen"], st13["cuda"]["rem"], thresh_g, w13g,
        tape_t=tt13_g), 5, lambda: k2e_setup(w13g, "cuda"))
    kernels.append(dict(
        name="drain_advance_event", route="cuda",
        source="simgrid_tpu_torch/csrc/drain_advance.cu",
        replaces="simgrid_tpu/ops/lmm_drain.py:363",
        launches=c13["drain_advance_event"], max_abs_err=err, ms=k2e_ms,
        plain_ms=k2e_plain,
        # K2's bytes plus the one tape date it reads
        bound_ms=bound_ms(k2_bytes + 8), bound_by="bytes",
        library_ms=None, dt=float(w13c.fctrl[DT]),
        launches_from="main path 8 (the faulted config-#4 drain); "
                      f"{c14[('tape', 'drain_advance_event')]} on main "
                      "path 9 (the collective tapes)"))
    log({"phase": "kernel", **kernels[-1]})

    # K3's tape arm: commit that advance in a superstep slot
    pk13g = torch.zeros(packed_size(K, V13 + K), dtype=f64, device=cuda)
    pk13c = pk13g.cpu()

    def k3t_prime(w, pk, cb_):
        w.ctrl[SS_ACTIVE] = 1
        w.ctrl[ADV_GO] = 1
        w.ctrl[TPOS] = 0
        pk.zero_()
        cb_.copy_(cb13)
    cb13g = cb13.to(cuda)
    cb13c = cb13.clone()
    k3t_prime(w13g, pk13g, cb13g)
    k3t_prime(w13c, pk13c, cb13c)
    snap13 = (w13g.ctrl.clone(), w13g.fctrl.clone())
    superstep_commit(w13g, ids_g, pk13g, K, V13 + K, tape=tap13_g,
                     c_bound=cb13g)
    superstep_commit_plain(w13c, ids_c, pk13c, K, V13 + K, tape=tap13_c,
                           c_bound=cb13c)
    torch.cuda.synchronize()
    err = max(diff(pk13g, pk13c), diff(w13g.ctrl, w13c.ctrl),
              diff(w13g.fctrl, w13c.fctrl), diff(cb13g, cb13c))
    if err != 0.0 or int(w13c.ctrl[TPOS]) != 1:
        raise AssertionError(f"K3's tape arm differs from its plain "
                             f"version ({err})")

    def k3t_setup():
        w13g.ctrl.copy_(snap13[0])
        w13g.fctrl.copy_(snap13[1])
        k3t_prime(w13g, pk13g, cb13g)

    def k3t_fn():
        superstep_commit(w13g, ids_g, pk13g, K, V13 + K, tape=tap13_g,
                         c_bound=cb13g)
    k3t_paced = events_ms(k3t_fn, 20, k3t_setup)
    k3t_t = time_call(k3t_fn, k3t_setup)
    k3t_plain = events_ms(lambda: superstep_commit_plain(
        w13g, ids_g, pk13g, K, V13 + K, tape=tap13_g, c_bound=cb13g), 5,
        k3t_setup)
    slot13, val13 = int(ts13[0]), tv13[0:1].to(cuda)
    slot13_g = torch.tensor([slot13], device=cuda)

    def k3t_lib_fn():
        cb13g.index_put_((slot13_g,), val13)
    k3t_lib_paced = events_ms(k3t_lib_fn, 20)
    k3t_lib = time_call(k3t_lib_fn)["ms"]
    n13 = int(w13c.done.sum())
    # the mask and the completed flows' ids read, the ring written
    # (completions and the fault entry), one tape entry read and one
    # bound written
    k3t_bytes = V13 + ids_bytes(w13c.done) + (n13 + 1) * 16 + 4 + 8 + 8
    kernels.append(dict(
        name="superstep_commit_tape", route="cuda",
        source="simgrid_tpu_torch/csrc/superstep_commit.cu",
        replaces="simgrid_tpu/ops/lmm_drain.py:423",
        launches=c13["superstep_commit_tape"], max_abs_err=err,
        ms=k3t_t["ms"], paced_ms=k3t_paced, queued=k3t_t["queued"],
        plain_ms=k3t_plain, bound_ms=bound_ms(k3t_bytes), bound_by="bytes",
        library_ms=k3t_lib, library_paced_ms=k3t_lib_paced,
        library="a partial yardstick: index_put_ of the fired bound, one "
                "of the commit's writes (one call)",
        launches_from="main path 8 (the faulted config-#4 drain)"))
    log({"phase": "kernel", **kernels[-1]})
    del w13g, w13c, st13, pk13g, pk13c

    # K3's collective arm and K10 at phase 14's largest shape (the
    # 1,024-rank rdb allreduce): from the converged rates of its roots,
    # a quarter of the dormant flows with a pending date inside the first
    # advance; then K10 over the edge list with the roots completed
    dc14 = cs15.build()
    V14, C14 = dc14.n_v, dc14.n_c
    flat14 = [to2d(a).reshape(-1) for a in (dc14.e_var, dc14.e_cnst,
                                            dc14.e_w)]
    s14 = to_device_system(flat14[0], flat14[1], flat14[2], dc14.c_bound,
                           V14, f64, cuda)
    pen14 = torch.from_numpy(dc14.penalty0.copy())
    w14g = Work(V14, C14, f64, cuda)
    lmm_init(s14, w14g, pen14.to(cuda), EPS)
    while True:
        for _ in range(16):
            lmm_round(s14, w14g, pen14.to(cuda), EPS)
        if int(w14g.ctrl[LIGHT]) == 0:
            break
    rates14 = w14g.v_value.clone()
    rem14 = torch.from_numpy(dc14.sizes.copy())
    thr14 = 1e-4 * rem14
    dormant = np.flatnonzero(dc14.penalty0 == 0)
    ready14 = np.full(V14, np.inf)
    ready14[dormant[::4]] = 1e-6
    ready14 = torch.from_numpy(ready14)
    ids14_g = torch.arange(V14, dtype=torch.int32, device=cuda)
    w14c = Work(V14, C14, f64, cpu)
    st14 = {}

    def k3c_setup(w, dev):
        st14[dev] = dict(pen=pen14.to(dev, copy=True),
                         rem=rem14.to(dev, copy=True),
                         ready=ready14.to(dev, copy=True),
                         pk=torch.zeros(packed_size(K, 2 * V14), dtype=f64,
                                        device=dev))
        w.v_value.copy_(rates14)
        w.ctrl.zero_()
        w.fctrl.zero_()
        w.evf.zero_()
        w.ctrl[SS_ACTIVE] = 1
        w.ctrl[PENDING] = len(dormant[::4])
        x = st14[dev]
        drain_advance(x["pen"], x["rem"], thr14.to(dev), w, gated=True,
                      ready=x["ready"])
    k3c_setup(w14g, "cuda")
    k3c_setup(w14c, "cpu")
    x_g, x_c = st14["cuda"], st14["cpu"]
    err2 = max(diff(w14g.ctrl, w14c.ctrl), diff(w14g.fctrl, w14c.fctrl),
               diff(w14g.evf, w14c.evf), diff(x_g["rem"], x_c["rem"]))
    # the timed commits below start from this state
    snap14 = (w14g.ctrl.clone(), w14g.fctrl.clone(), w14g.evf.clone())
    superstep_commit(w14g, ids14_g, x_g["pk"], K, 2 * V14, n_c=C14,
                     ready=x_g["ready"], pen=x_g["pen"])
    superstep_commit(w14c, ids14_g.cpu(), x_c["pk"], K, 2 * V14, n_c=C14,
                     ready=x_c["ready"], pen=x_c["pen"])
    torch.cuda.synchronize()
    err = max(err2, diff(x_g["pk"], x_c["pk"]), diff(w14g.ctrl, w14c.ctrl),
              diff(x_g["pen"], x_c["pen"]),
              diff(x_g["ready"], x_c["ready"]))
    n_act14 = len(dormant[::4])
    if err != 0.0 or int(w14c.ctrl[PENDING]) != 0 \
            or int((x_c["pen"] > 0).sum()) != V14 - len(dormant) + n_act14:
        raise AssertionError(f"K3's collective arm differs from its plain "
                             f"version ({err}) or fired the wrong flows")

    def k3c_restore():
        w14g.ctrl.copy_(snap14[0])
        w14g.fctrl.copy_(snap14[1])
        w14g.evf.copy_(snap14[2])
        x_g["pen"].copy_(pen14)
        x_g["ready"].copy_(ready14)
    def k3c_fn():
        superstep_commit(w14g, ids14_g, x_g["pk"], K, 2 * V14, n_c=C14,
                         ready=x_g["ready"], pen=x_g["pen"])
    k3c_ms = events_ms(k3c_fn, 20, k3c_restore)
    k3c_plain = events_ms(lambda: superstep_commit_plain(
        w14g, ids14_g, x_g["pk"], K, 2 * V14, n_c=C14, ready=x_g["ready"],
        pen=x_g["pen"]), 5, k3c_restore)
    # mask and dates read, the ids of the flows that complete or
    # activate; per completion a ring entry, per activation a ring
    # entry, a penalty and a date written
    n_done14 = int(w14c.done.sum())
    k3c_bytes = (V14 + nbytes(ready14)
                 + ids_bytes(w14c.done, torch.isfinite(ready14))
                 + n_done14 * 16 + n_act14 * 32)
    kernels.append(dict(
        name="superstep_commit_coll", route="cuda",
        source="simgrid_tpu_torch/csrc/superstep_commit.cu",
        replaces="simgrid_tpu/ops/lmm_drain.py:439",
        launches=c14[("tape", "superstep_commit_coll")], max_abs_err=err,
        ms=k3c_ms, plain_ms=k3c_plain, bound_ms=bound_ms(k3c_bytes),
        bound_by="bytes", library_ms=None, activations=n_act14,
        launches_from="main path 9 (the three collective tapes)"))
    log({"phase": "kernel", **kernels[-1]})

    # K10: the roots complete in one advance
    pred0_14 = torch.from_numpy(dc14.pred0.copy())
    es14, ed14, ex14 = (torch.from_numpy(a.copy()) for a in (
        dc14.edge_src, dc14.edge_dst, dc14.exec_cost))
    args14_g = [t.to(cuda) for t in (es14, ed14)]
    ex14_g = ex14.to(cuda)
    # the out-edge CSR, built once per schedule as the drains build it
    csr14_g = dag_csr(*args14_g, V14)
    csr14 = dag_csr(es14, ed14, V14)
    done14 = torch.from_numpy(dc14.penalty0 > 0)
    st10 = {}

    def k10_setup(w, dev):
        w.ctrl[ADV_OK] = 1
        w.ctrl[PENDING] = 0
        w.fctrl[T_SUM] = 1e-3
        w.done.copy_(done14)
        st10[dev] = dict(pred=pred0_14.to(dev, copy=True),
                         ready=torch.full((V14,), float("inf"), dtype=f64,
                                          device=dev))
    k10_setup(w14g, "cuda")
    k10_setup(w14c, "cpu")
    dag_walk(w14g, *args14_g, st10["cuda"]["pred"], st10["cuda"]["ready"],
             ex14_g, csr14_g)
    dag_walk_plain(w14c, csr14, st10["cpu"]["pred"], st10["cpu"]["ready"],
                   ex14)
    torch.cuda.synchronize()
    err = max(diff(st10["cuda"]["pred"], st10["cpu"]["pred"]),
              diff(st10["cuda"]["ready"], st10["cpu"]["ready"]),
              diff(w14g.ctrl[PENDING], w14c.ctrl[PENDING]))
    freed14 = int(w14c.ctrl[PENDING])
    if err != 0.0 or freed14 <= 0:
        raise AssertionError(f"K10 differs from its plain version ({err}) "
                             "or freed nothing")
    k10_ms = events_ms(lambda: dag_walk(
        w14g, *args14_g, st10["cuda"]["pred"], st10["cuda"]["ready"],
        ex14_g, csr14_g), 20, lambda: k10_setup(w14g, "cuda"))
    k10_plain = events_ms(lambda: dag_walk_plain(
        w14g, csr14_g, st10["cuda"]["pred"], st10["cuda"]["ready"],
        ex14_g), 5, lambda: k10_setup(w14g, "cuda"))
    keep14 = args14_g[1] < V14
    src14, dst14 = args14_g[0][keep14].long(), args14_g[1][keep14].long()
    done14_g = w14g.done

    def library_k10():
        st10["cuda"]["pred"].index_add_(
            0, dst14, -done14_g[src14].to(torch.int32))
    k10_lib = events_ms(library_k10, 20, lambda: k10_setup(w14g, "cuda"))
    k10_t = time_call(lambda: dag_walk(
        w14g, *args14_g, st10["cuda"]["pred"], st10["cuda"]["ready"],
        ex14_g, csr14_g), lambda: k10_setup(w14g, "cuda"))
    k10_lib_t = time_call(library_k10, lambda: k10_setup(w14g, "cuda"))
    n_dec = int(done14[es14[ed14 < V14].long()].sum())
    # the edge list and the done flag of every edge source read once; per
    # decrement a count read and written; per freed flow a cost read and a
    # date written
    k10_bytes = (nbytes(es14, ed14) + int(torch.unique(es14).numel())
                 + n_dec * 8 + freed14 * 16)
    kernels.append(dict(
        name="dag_walk", route="cuda",
        source="simgrid_tpu_torch/csrc/dag_walk.cu",
        replaces="simgrid_tpu/ops/lmm_drain.py:457",
        launches=c14[("tape", "dag_walk")], max_abs_err=err,
        ms=k10_t["ms"], paced_ms=k10_ms, queued=k10_t["queued"],
        plain_ms=k10_plain, bound_ms=bound_ms(k10_bytes), bound_by="bytes",
        library_ms=k10_lib_t["ms"], library_paced_ms=k10_lib,
        library="index_add_ of the decrements on int32 (one call)",
        edges=dc14.n_edges, decrements=n_dec, freed=freed14,
        launches_from="main path 9 (the three collective tapes); "
                      f"{report['composed_arms']['tape_launches']['dag_walk']}"
                      " on phase 15"))
    log({"phase": "kernel", **kernels[-1]})
    del w14g, w14c, s14, st10, st14
    torch.cuda.empty_cache()

    helpers = dict(events_ms=events_ms, nbytes=nbytes, bound_ms=bound_ms,
                   diff=diff, kernels=kernels, report=report, out_dir=out_dir)
    camp16 = fleet_phases(dict(dsys=dsys, rsys=rsys, wall13=row13["wall_s"],
                               EPS=EPS, **helpers))
    camp18 = collective_fleet_phase(dict(tape14=tape14, **helpers))
    probe_phase(helpers)
    pipeline_phase(dict(dsys=dsys, tape13=tape13, camp16=camp16,
                        camp18=camp18, smi=smi, **helpers))
    engine_phase(dict(smi=smi, **helpers))

    # K1's round bodies over every path of the run, on K16's row
    next(k for k in kernels if k["name"] == "superstep_loop").update(
        k1_round_bodies())
    report["kernels"] = kernels
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(smi, flush=True)
    log({"kernels": [{**{k: kr[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "launches_from")}, **{k: kr[k] for k in (
            "arms", "host_calls", "device_rounds",
            "graph_launches_per_superstep", "k1_nodes_per_round",
            "round_body_loop_conds") if k in kr}}
        for kr in kernels]})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


def engine_only(argv) -> int:
    """``python3 chip_smoke.py --engine-only[=12] [--profile]``: the
    kernels' build, then phase 21 alone (``=12``: main path 12 alone;
    ``--profile``: its drain under cProfile, the top functions written
    to ``chiprun_out/engine_profile.txt``).  Its lines are the phase's,
    and its last line the card's; it prints no ``ok`` line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from simgrid_tpu_torch.kernels import build
    from simgrid_tpu_torch.workloads import engine_run as er
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.build_all()
    log({"phase": "device", "nvidia_smi": smi,
         "build_s": time.perf_counter() - t0})
    if "--profile" in argv:
        import cProfile
        import io
        import pstats
        orig, seen = er.drain, []

        def drain(e, *a, **k):
            if seen:
                return orig(e, *a, **k)
            seen.append(True)
            prof = cProfile.Profile()
            prof.enable()
            try:
                return orig(e, *a, **k)
            finally:
                prof.disable()
                text = io.StringIO()
                st = pstats.Stats(prof, stream=text)
                st.sort_stats("tottime").print_stats(40)
                st.sort_stats("cumulative").print_stats(40)
                with open(os.path.join(out_dir, "engine_profile.txt"),
                          "w") as f:
                    f.write(text.getvalue())
        er.drain = drain
    report = {}
    engine_phase(dict(report=report, smi=smi,
                      path12_only="--engine-only=12" in argv))
    with open(os.path.join(out_dir, "engine_phase.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    if any(a.startswith("--engine-only") for a in sys.argv[1:]):
        sys.exit(engine_only(sys.argv[1:]))
    sys.exit(main())
