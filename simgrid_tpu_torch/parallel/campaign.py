"""Scenario campaigns: fleets of what-if drains over one shared system.

The port's copy of ``simgrid_tpu/parallel/campaign.py``, staged as the
reference stages it:

* :class:`ScenarioSpec`: one replica's scenario (seed, sweep overrides,
  fault model), content-addressed (:meth:`ScenarioSpec.key`, the same
  sha256 as the JAX package's) with a JSON round trip;
* :class:`ScenarioPlan`: one shared drain system and the solver
  configuration; it derives each spec's overrides and fault tape,
  builds fleets (:meth:`ScenarioPlan.executor`, an
  :class:`~simgrid_tpu_torch.ops.lmm_batch.BatchDrainSim`) and runs the
  solo oracle (:meth:`ScenarioPlan.solo`, the port's ``DrainSim``).  A
  plan built by :meth:`ScenarioPlan.for_collective` is one collective's
  compiled comm DAG: its fleets and solo drains walk the schedule (the
  ``collective=`` arm), and its key names the collective;
* :class:`Campaign`: the front end over (plan, specs), ``run_batched``
  in fleets of ``batch`` replicas, ``run_solo``, ``run_scoped``.

A spec's fault dimension is a seeded :class:`~simgrid_tpu_torch.faults.
FaultCampaign` over the used links, realised per ``fault_mode``: ``on``
(a device event tape: links fail and recover at the schedule's dates
mid-drain), ``static`` (the time-averaged availability folded into the
link factors) or ``off``.  The port has no config module, so
``fault_mode`` is an argument with the reference's default, ``on``.

``pipeline=D`` (the fleets' speculative supersteps, ``ops/lmm_batch.py``)
passes through to the executor.  Not ported yet: ``from_engine``
(ROADMAP queue A item 3, the engine capture), ``mesh`` (A9) and
``plan_cache`` (A8); each raises ``NotImplementedError``.
"""

from __future__ import annotations

import copy
import hashlib
import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..collectives.spec import CollectiveSpec
from ..faults import FaultCampaign
from ..ops import opstats
from ..ops.lmm_batch import (BatchDrainSim, ReplicaOverrides,
                             derive_replica_arrays, derive_replica_ew)

#: a fully failed link would zero its capacity and stall every flow
#: routed over it; campaigns clamp failures to this factor
MIN_LINK_FACTOR = 0.05

Tape = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _canon_pairs(d: Dict[int, float]) -> List[List[float]]:
    """Sorted [slot, factor] pairs: dict order never reaches a hash."""
    return [[int(k), float(d[k])] for k in sorted(d)]


def _pairs_to_map(pairs) -> Dict[int, float]:
    if isinstance(pairs, dict):
        return {int(k): float(pairs[k]) for k in sorted(pairs, key=int)}
    return {int(k): float(v) for k, v in (pairs or [])}


class ScenarioSpec:
    """One replica's scenario: seed, sweep overrides and fault model.

    ``fault_mtbf``/``fault_mttr`` (simulated seconds) switch the fault
    dimension on: every used link gets a seeded failure and repair
    schedule over ``fault_horizon``.  Identical seeds give identical
    scenarios, bit for bit.  :meth:`key` is a sha256 of the canonical
    JSON form without the ``label``; :meth:`to_json` / :meth:`from_json`
    round-trip the whole record."""

    __slots__ = ("seed", "bw_scale", "size_scale", "link_scale",
                 "flow_scale", "dead_flows", "elem_w", "fault_mtbf",
                 "fault_mttr", "fault_dist", "fault_shape",
                 "fault_horizon", "collective", "label")

    def __init__(self, seed: int = 0, bw_scale: float = 1.0,
                 size_scale: float = 1.0,
                 link_scale: Optional[Dict[int, float]] = None,
                 flow_scale: Optional[Dict[int, float]] = None,
                 dead_flows: Iterable[int] = (),
                 elem_w: Optional[Dict[int, float]] = None,
                 fault_mtbf: Optional[float] = None,
                 fault_mttr: float = 60.0,
                 fault_dist: str = "exponential",
                 fault_shape: float = 1.0,
                 fault_horizon: float = 1000.0,
                 collective: Optional[CollectiveSpec] = None,
                 label: Optional[str] = None):
        self.seed = int(seed)
        self.bw_scale = float(bw_scale)
        self.size_scale = float(size_scale)
        self.link_scale = dict(link_scale or {})
        self.flow_scale = dict(flow_scale or {})
        self.dead_flows = tuple(dead_flows)
        self.elem_w = dict(elem_w or {})
        self.fault_mtbf = fault_mtbf
        self.fault_mttr = float(fault_mttr)
        self.fault_dist = fault_dist
        self.fault_shape = float(fault_shape)
        self.fault_horizon = float(fault_horizon)
        if isinstance(collective, dict):
            collective = CollectiveSpec.from_dict(collective)
        #: the collective workload the spec is meant for: it runs only on
        #: a plan compiled for the same one
        self.collective = collective
        self.label = label if label is not None else f"seed{seed}"

    def to_dict(self, with_label: bool = True) -> Dict:
        """Canonical dict form: sparse maps as sorted [slot, factor]
        pairs, dead flows sorted."""
        d = {"seed": self.seed,
             "bw_scale": self.bw_scale,
             "size_scale": self.size_scale,
             "link_scale": _canon_pairs(self.link_scale),
             "flow_scale": _canon_pairs(self.flow_scale),
             "dead_flows": sorted(int(s) for s in self.dead_flows),
             "elem_w": _canon_pairs(self.elem_w),
             "fault_mtbf": (None if self.fault_mtbf is None
                            else float(self.fault_mtbf)),
             "fault_mttr": self.fault_mttr,
             "fault_dist": str(self.fault_dist),
             "fault_shape": self.fault_shape,
             "fault_horizon": self.fault_horizon}
        if self.collective is not None:
            d["collective"] = self.collective.to_dict()
        if with_label:
            d["label"] = self.label
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_dict(cls, d: Dict) -> "ScenarioSpec":
        return cls(seed=d.get("seed", 0),
                   bw_scale=d.get("bw_scale", 1.0),
                   size_scale=d.get("size_scale", 1.0),
                   link_scale=_pairs_to_map(d.get("link_scale")),
                   flow_scale=_pairs_to_map(d.get("flow_scale")),
                   dead_flows=tuple(int(s) for s in d.get("dead_flows", ())),
                   elem_w=_pairs_to_map(d.get("elem_w")),
                   fault_mtbf=d.get("fault_mtbf"),
                   fault_mttr=d.get("fault_mttr", 60.0),
                   fault_dist=d.get("fault_dist", "exponential"),
                   fault_shape=d.get("fault_shape", 1.0),
                   fault_horizon=d.get("fault_horizon", 1000.0),
                   collective=d.get("collective"),
                   label=d.get("label"))

    @classmethod
    def from_json(cls, text: str) -> "ScenarioSpec":
        return cls.from_dict(json.loads(text))

    def key(self) -> str:
        """Stable content hash (sha256 hex) of the scenario, label
        excluded."""
        canon = json.dumps(self.to_dict(with_label=False), sort_keys=True,
                           separators=(",", ":"))
        return hashlib.sha256(canon.encode("utf-8")).hexdigest()


class ReplicaResult:
    """One replica's outcome: events ``[(time, flow slot)]``, clock,
    advances, error, fired fault entries ``[(time, slot)]`` and, on a
    collective plan, fired activations ``[(time, flow slot)]``."""

    __slots__ = ("spec", "events", "t", "advances", "error",
                 "fault_events", "collective_events")

    def __init__(self, spec: ScenarioSpec, events, t: float,
                 advances: int, error: Optional[str],
                 fault_events=None, collective_events=None):
        self.spec = spec
        self.events = events
        self.t = t
        self.advances = advances
        self.error = error
        self.fault_events = list(fault_events or [])
        self.collective_events = list(collective_events or [])


class ScenarioPlan:
    """The spec-independent stage of a campaign: one shared drain
    system and the solver configuration; derives per-spec overrides and
    tapes, builds fleets and runs the solo oracle."""

    def __init__(self, e_var, e_cnst, e_w, c_bound, sizes,
                 remains=None, penalty=None, v_bound=None,
                 link_names: Optional[List[Optional[str]]] = None,
                 eps: float = 1e-9, done_eps: float = 1e-4,
                 dtype=np.float64, done_mode: str = "rel",
                 superstep: int = 8, pipeline: int = 0, mesh=None,
                 fault_mode: str = "on",
                 collective: Optional[CollectiveSpec] = None,
                 device=None, _device_collective=None):
        if fault_mode not in ("on", "static", "off"):
            raise ValueError(f"Unknown fault_mode {fault_mode!r} "
                             "(expected on, static or off)")
        self.e_var = np.asarray(e_var, np.int32)
        self.e_cnst = np.asarray(e_cnst, np.int32)
        self.e_w = np.asarray(e_w, np.float64)
        self.c_bound = np.asarray(c_bound, np.float64)
        self.sizes = np.asarray(sizes, np.float64)
        self.remains = (np.asarray(remains, np.float64)
                        if remains is not None else None)
        self.penalty = (np.asarray(penalty, np.float64)
                        if penalty is not None else None)
        self.v_bound = (np.asarray(v_bound, np.float64)
                        if v_bound is not None else None)
        self.link_names = link_names
        self.eps = float(eps)
        self.done_eps = float(done_eps)
        self.dtype = np.dtype(dtype)
        self.done_mode = done_mode
        self.superstep = int(superstep)
        self.pipeline = int(pipeline)
        self.mesh = mesh
        #: "on" = device event tapes, "static" = folded mean-availability
        #: factors, "off" = the fault dimension ignored
        self.fault_mode = fault_mode
        if isinstance(collective, dict):
            collective = CollectiveSpec.from_dict(collective)
        #: a CollectiveSpec: the plan's system is its compiled comm DAG,
        #: and every executor walks its schedule
        self.collective = collective
        self._dc = None
        if collective is not None:
            if self.dtype != np.float64:
                raise ValueError(
                    "collective schedule tapes require dtype float64 "
                    "(the superstep clock is carried on device)")
            dc = (_device_collective if _device_collective is not None
                  else collective.build())
            if len(self.sizes) != dc.n_v or len(self.c_bound) != dc.n_c:
                raise ValueError(
                    f"plan arrays ({len(self.sizes)} flows, "
                    f"{len(self.c_bound)} links) do not match the "
                    f"collective's compiled tape ({dc.n_v} flows, "
                    f"{dc.n_c} links); build the plan with "
                    f"ScenarioPlan.for_collective")
            if self.penalty is None:
                self.penalty = np.asarray(dc.penalty0, np.float64)
            elif not np.array_equal(self.penalty, dc.penalty0):
                raise ValueError(
                    "plan penalty does not match the collective's "
                    "root-activation mask (dc.penalty0)")
            self._dc = dc
        #: the device fleets and solo drains run on (None: the card)
        self.device = device
        #: constraint slots that carry an element of positive weight:
        #: fault schedules are drawn for these only
        used = np.zeros(len(self.c_bound), bool)
        used[self.e_cnst[self.e_w > 0]] = True
        self._used_links = np.flatnonzero(used)
        self._topology_hash: Optional[str] = None
        #: compiled tapes by spec key: a tape is a pure function of the
        #: plan and the spec, and over a large system (one seeded
        #: schedule per used link) the fleet, the solo oracle and an
        #: admission ask for the same one
        self._tapes: Dict[str, Optional[Tape]] = {}

    def with_device(self, device) -> "ScenarioPlan":
        """The same plan with its fleets and solo drains on ``device``
        (the compiled tapes shared)."""
        plan = copy.copy(self)
        plan.device = device
        return plan

    # -- content addressing ------------------------------------------------

    def topology_hash(self) -> str:
        """sha256 over the shared system and the solver configuration
        (the JAX plan's, byte for byte)."""
        if self._topology_hash is None:
            h = hashlib.sha256()
            for name, arr in (("e_var", self.e_var),
                              ("e_cnst", self.e_cnst), ("e_w", self.e_w),
                              ("c_bound", self.c_bound),
                              ("sizes", self.sizes),
                              ("remains", self.remains),
                              ("penalty", self.penalty),
                              ("v_bound", self.v_bound)):
                h.update(name.encode())
                if arr is None:
                    h.update(b"<none>")
                else:
                    h.update(str(arr.shape).encode())
                    h.update(arr.tobytes())
            names = (list(self.link_names)
                     if self.link_names is not None else None)
            h.update(json.dumps(names).encode())
            h.update(json.dumps([self.eps, self.done_eps,
                                 self.done_mode]).encode())
            if self.collective is not None:
                # only when present, so plans without one keep their hash
                h.update(b"collective")
                h.update(self.collective.key().encode())
            self._topology_hash = h.hexdigest()
        return self._topology_hash

    def plan_key(self, batch: int, pipeline: Optional[int] = None,
                 mesh=None, layout: str = "auto") -> str:
        """The content-addressed key of a fleet's execution shape:
        ``(topology hash, layout, dtype, B, superstep, pipeline, mesh,
        fault_mode)``, as the JAX plan hashes it (``layout`` stands for
        JAX's ``lmm/layout`` flag)."""
        depth = self.pipeline if pipeline is None else int(pipeline)
        use_mesh = self.mesh if mesh is None else mesh
        canon = json.dumps([self.topology_hash(), str(layout),
                            self.dtype.name, int(batch), self.superstep,
                            depth, int(use_mesh or 0), self.fault_mode],
                           separators=(",", ":"))
        return hashlib.sha256(canon.encode("utf-8")).hexdigest()

    @classmethod
    def for_collective(cls, cspec: CollectiveSpec, exec_cost=None,
                       **kw) -> "ScenarioPlan":
        """A plan whose system is one collective's compiled comm DAG
        (``cspec.build(exec_cost)``), carrying the spec so that
        ``plan_key`` names the (algorithm, ranks, topology) point; the
        other arguments pass through."""
        dc = cspec.build(exec_cost=exec_cost)
        return cls(dc.e_var, dc.e_cnst, dc.e_w, dc.c_bound, dc.sizes,
                   penalty=dc.penalty0, collective=cspec,
                   _device_collective=dc, **kw)

    def _check_collective(self, spec: ScenarioSpec) -> None:
        """A spec carrying a collective runs only on a plan compiled for
        the same one, and no spec kills a flow of a schedule."""
        if self.collective is not None and spec.dead_flows:
            raise ValueError(
                f"spec {spec.label!r} kills flows "
                f"{spec.dead_flows} but the plan walks a schedule "
                f"tape — a dead record would deadlock its successors")
        if spec.collective is None:
            return
        if self.collective is None:
            raise ValueError(
                f"spec {spec.label!r} carries collective "
                f"{spec.collective.label()} but the plan has none")
        if spec.collective.key() != self.collective.key():
            raise ValueError(
                f"spec {spec.label!r} carries collective "
                f"{spec.collective.label()} but the plan was compiled "
                f"for {self.collective.label()}")

    def _collective_args(self):
        """The ``collective=`` 5-tuple of the plan's DAG, or None."""
        return None if self._dc is None else self._dc.drain_args()

    # -- per-spec derivation -----------------------------------------------

    def _link_name(self, slot: int) -> str:
        if self.link_names is not None and slot < len(self.link_names) \
                and self.link_names[slot]:
            return str(self.link_names[slot])
        return f"link{slot}"

    def _fault_campaign(self, spec: ScenarioSpec
                        ) -> Tuple[FaultCampaign, Dict[str, int]]:
        """The seeded campaign over the used links, registered in slot
        order (so the draws are a pure function of the spec), and the
        name -> slot map."""
        fc = FaultCampaign(seed=spec.seed, horizon=spec.fault_horizon)
        names: Dict[str, int] = {}
        for slot in self._used_links:
            name = self._link_name(int(slot))
            names[name] = int(slot)
            fc.add_link(name, mtbf=spec.fault_mtbf, mttr=spec.fault_mttr,
                        dist=spec.fault_dist, shape=spec.fault_shape)
        return fc, names

    def tape_len(self, spec: ScenarioSpec) -> int:
        """Entries of the spec's fault tape (0 when the fault dimension
        is off for this plan or spec)."""
        if self.fault_mode != "on" or spec.fault_mtbf is None:
            return 0
        fc, _ = self._fault_campaign(spec)
        return fc.tape_len(floor=MIN_LINK_FACTOR)

    def overrides_for(self, spec: ScenarioSpec) -> ReplicaOverrides:
        """The spec's sweep overrides, and in ``static`` mode its
        time-averaged fault schedule folded into the link factors."""
        link_scale = dict(spec.link_scale)
        if spec.fault_mtbf is not None and self.fault_mode == "static":
            fc, names = self._fault_campaign(spec)
            for (kind, name), avail in sorted(
                    fc.mean_availability().items()):
                if avail >= 1.0:
                    continue
                slot = names[name]
                factor = max(avail, MIN_LINK_FACTOR)
                link_scale[slot] = link_scale.get(slot, 1.0) * factor
        return ReplicaOverrides(bw_scale=spec.bw_scale,
                                size_scale=spec.size_scale,
                                link_scale=link_scale,
                                flow_scale=spec.flow_scale,
                                dead_flows=spec.dead_flows,
                                elem_w=spec.elem_w)

    def _base_rem_pen(self):
        return (self.remains if self.remains is not None else self.sizes,
                self.penalty if self.penalty is not None
                else np.ones(len(self.sizes)))

    def tape_for(self, spec: ScenarioSpec) -> Optional[Tape]:
        """The spec's fault tape ``(dates f64, constraint slots int32,
        new bounds f64)``, or None (fault mode not ``on``, no fault
        dimension, or an empty schedule).  The bounds are absolute,
        from the replica's own swept ``c_bound``, so a repair restores
        the replica's bound exactly."""
        if self.fault_mode != "on" or spec.fault_mtbf is None:
            return None
        key = spec.key()
        if key not in self._tapes:
            self._tapes[key] = self._compile_tape(spec)
        hit = self._tapes[key]
        return None if hit is None else tuple(a.copy() for a in hit)

    def _compile_tape(self, spec: ScenarioSpec) -> Optional[Tape]:
        fc, names = self._fault_campaign(spec)
        entries = fc.compile_tape(floor=MIN_LINK_FACTOR)
        if not entries:
            return None
        cb, _, _, _ = derive_replica_arrays(
            self.c_bound, self.sizes, *self._base_rem_pen(),
            self.overrides_for(spec))
        t = np.empty(len(entries), np.float64)
        s = np.empty(len(entries), np.int32)
        v = np.empty(len(entries), np.float64)
        for i, (date, _kind, name, factor) in enumerate(entries):
            slot = names[name]
            t[i] = date
            s[i] = slot
            v[i] = cb[slot] * factor
        return t, s, v

    # -- executors ---------------------------------------------------------

    def executor(self, specs: Sequence[ScenarioSpec],
                 width: Optional[int] = None, superstep_rounds: int = 0,
                 pipeline: Optional[int] = None, mesh=None,
                 plan_cache=None, tape_slots: int = 0,
                 batch_w: Optional[bool] = None,
                 watchdog=None) -> BatchDrainSim:
        """One ready fleet for ``specs``; ``width`` adds rows dead from
        birth, waiting for admissions."""
        if plan_cache is not None:
            raise _not_ported("ScenarioPlan.executor(plan_cache=)",
                              "queue A item 8 (the AOT plan cache)")
        specs = list(specs)
        width = len(specs) if width is None else int(width)
        if width < len(specs):
            raise ValueError("executor width smaller than spec count")
        for s in specs:
            self._check_collective(s)
        overrides = [self.overrides_for(s) for s in specs]
        overrides += [ReplicaOverrides() for _ in range(width - len(specs))]
        tapes = [self.tape_for(s) for s in specs]
        tapes += [None] * (width - len(specs))
        if not any(t is not None for t in tapes) and not tape_slots:
            tapes = None
        depth = self.pipeline if pipeline is None else int(pipeline)
        use_mesh = self.mesh if mesh is None else mesh
        return BatchDrainSim(
            self.e_var, self.e_cnst, self.e_w, self.c_bound, self.sizes,
            overrides, eps=self.eps, done_eps=self.done_eps,
            dtype=self.dtype, done_mode=self.done_mode,
            superstep=self.superstep, superstep_rounds=superstep_rounds,
            device=self.device, v_bound=self.v_bound, penalty=self.penalty,
            remains=self.remains, pipeline=depth, mesh=use_mesh,
            tapes=tapes, tape_slots=tape_slots,
            start_dead=tuple(range(len(specs), width)), batch_w=batch_w,
            watchdog=watchdog, collective=self._collective_args())

    def solo(self, spec: ScenarioSpec, superstep_rounds: int = 0,
             device=None) -> ReplicaResult:
        """Drain ONE spec with the port's solo ``DrainSim`` over
        host-derived arrays: the oracle every fleet replica equals by
        bits.  Repacks are off, as in the fleet."""
        from ..ops.lmm_drain import DrainSim
        self._check_collective(spec)
        ov = self.overrides_for(spec)
        cb, sz, rem, pen = derive_replica_arrays(
            self.c_bound, self.sizes, *self._base_rem_pen(), ov)
        ew = derive_replica_ew(self.e_w, ov, self.dtype)
        sim = DrainSim(self.e_var, self.e_cnst, ew, cb.astype(self.dtype),
                       sz, eps=self.eps, done_eps=self.done_eps,
                       dtype=self.dtype, done_mode=self.done_mode,
                       superstep=self.superstep,
                       superstep_rounds=superstep_rounds,
                       device=self.device if device is None else device,
                       v_bound=(self.v_bound.astype(self.dtype)
                                if self.v_bound is not None else None),
                       penalty=pen, remains=rem, repack_min=1 << 62,
                       tape=self.tape_for(spec),
                       collective=self._collective_args())
        error = None
        try:
            sim.run()
        except RuntimeError as exc:
            error = str(exc)
        return ReplicaResult(spec, sim.events, sim.t, sim.advances, error,
                             fault_events=sim.fault_events,
                             collective_events=sim.collective_events)


class Campaign:
    """A scenario fleet over one shared drain system: the front end over
    ``(ScenarioPlan, specs)``; base attributes delegate to the plan."""

    def __init__(self, e_var, e_cnst, e_w, c_bound, sizes,
                 specs: Sequence[ScenarioSpec], remains=None, penalty=None,
                 v_bound=None,
                 link_names: Optional[List[Optional[str]]] = None,
                 eps: float = 1e-9, done_eps: float = 1e-4,
                 dtype=np.float64, done_mode: str = "rel",
                 superstep: int = 8, pipeline: int = 0, mesh=None,
                 fault_mode: str = "on", plan_cache=None, collective=None,
                 device=None):
        if plan_cache is not None:
            raise _not_ported("Campaign(plan_cache=)",
                              "queue A item 8 (the AOT plan cache)")
        self.plan = ScenarioPlan(
            e_var, e_cnst, e_w, c_bound, sizes, remains=remains,
            penalty=penalty, v_bound=v_bound, link_names=link_names,
            eps=eps, done_eps=done_eps, dtype=dtype, done_mode=done_mode,
            superstep=superstep, pipeline=pipeline, mesh=mesh,
            fault_mode=fault_mode, collective=collective, device=device)
        self.specs = list(specs)

    def __getattr__(self, name: str):
        plan = self.__dict__.get("plan")
        if plan is None or name.startswith("__"):
            raise AttributeError(name)
        return getattr(plan, name)

    @classmethod
    def from_engine(cls, model, specs, **kw):
        raise _not_ported("Campaign.from_engine",
                          "queue A item 3 (the engine capture)")

    @classmethod
    def for_collective(cls, cspec: CollectiveSpec,
                       specs: Sequence[ScenarioSpec], **kw) -> "Campaign":
        """A campaign over one collective's compiled comm DAG (see
        :meth:`ScenarioPlan.for_collective`)."""
        dc = cspec.build()
        return cls(dc.e_var, dc.e_cnst, dc.e_w, dc.c_bound, dc.sizes,
                   specs, penalty=dc.penalty0, collective=cspec, **kw)

    def run_batched(self, batch: int = 64, superstep_rounds: int = 0,
                    pipeline: Optional[int] = None, mesh=None
                    ) -> List[ReplicaResult]:
        """Drain the specs in fleets of ``batch`` replicas; results in
        spec order (chunking changes no result: replicas are
        independent)."""
        results: List[ReplicaResult] = []
        step = max(1, int(batch))
        for start in range(0, len(self.specs), step):
            chunk_specs = self.specs[start:start + step]
            sim = self.plan.executor(chunk_specs,
                                     superstep_rounds=superstep_rounds,
                                     pipeline=pipeline, mesh=mesh)
            sim.run()
            for b, spec in enumerate(chunk_specs):
                rep = sim.replicas[b]
                results.append(ReplicaResult(
                    spec, rep.events, rep.t, rep.advances, rep.error,
                    fault_events=rep.fault_events,
                    collective_events=rep.collective_events))
        return results

    def run_solo(self, index: int,
                 superstep_rounds: int = 0) -> ReplicaResult:
        """The solo oracle of spec ``index`` (:meth:`ScenarioPlan.
        solo`)."""
        return self.plan.solo(self.specs[index],
                              superstep_rounds=superstep_rounds)

    def run_scoped(self, batch: int, stage: str,
                   pipeline: Optional[int] = None, mesh=None
                   ) -> Tuple[List[ReplicaResult], Dict[str, float]]:
        """``run_batched`` under an opstats stage scope: (results, this
        run's counter deltas)."""
        with opstats.scoped(stage) as stats:
            results = self.run_batched(batch=batch, pipeline=pipeline,
                                       mesh=mesh)
        return results, stats
