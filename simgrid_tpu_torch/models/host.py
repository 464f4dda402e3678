"""Hosts and the composed host model.

The port's copy of ``simgrid_tpu/models/host.py``: Host = CPU + network
endpoint + actor list (reference src/surf/HostImpl.cpp and
s4u_Host.cpp); HostCLM03Model composes the CPU/network/storage models'
next-event minima (reference src/surf/host_clm03.cpp).  The port has no
actors yet (ROADMAP queue A, item A3b): a host's actor list stays empty,
rebooting recorded actors raises, and ``set_pstate`` applies at once
(the JAX package's simcall outside any actor context).
"""

from __future__ import annotations

from typing import Dict, List

from ..kernel.resource import Model, UpdateAlgo
from ..utils.signal import Signal


class Host:
    """A simulated machine."""

    on_creation = Signal()
    on_destruction = Signal()
    on_state_change = Signal()
    on_speed_change_sig = Signal()
    on_restart = Signal()        # (host, n_actors_rebooted)

    def __init__(self, engine, name: str):
        self.engine = engine
        self.name = name
        self.cpu = None                   # set by the CPU model factory
        self.netpoint = None              # routing endpoint
        self.actor_list: List = []
        self.properties: Dict[str, str] = {}
        self.mounts: Dict[str, str] = {}   # mount point -> storage id
        #: boot specs: every deployment actor + every actor that called
        #: set_auto_restart (HostImpl::actors_at_boot_)
        self.actors_at_boot: list = []
        self.storages: Dict[str, object] = {}
        self.data = None
        engine.hosts[name] = self

    def __repr__(self):
        return f"<Host {self.name}>"

    # -- state ------------------------------------------------------------
    def is_on(self) -> bool:
        return self.cpu.is_on() if self.cpu is not None else True

    def turn_on(self) -> None:
        if not self.is_on():
            self.cpu.turn_on()
            self.engine.watched_hosts.discard(self.name)
            Host.on_state_change(self)
            # autorestart actors are relaunched by the engine hook
            self.engine_on_host_restart()

    def turn_off(self) -> None:
        # reference s4u::Host::turn_off: kill every actor of the host
        if self.is_on():
            self.cpu.turn_off()
            # SIMIX watched-host semantics: a failed host whose actors
            # were killed while actions were pending joins the watched
            # set, so its recovery profile event forces a zero-length
            # re-solve even though no action uses the CPU any more
            # (surf_solve's is_used() test alone would let the engine
            # sleep past the reboot).  Sampled BEFORE the kills: they
            # cancel the very synchros that make the host "pending".
            pending = self.cpu.is_used() or any(
                actor.waiting_synchro is not None
                for actor in self.actor_list)
            for actor in list(self.actor_list):
                self.engine.maestro.kill(actor)
            if pending:
                self.engine.watched_hosts.add(self.name)
            # keep only the specs that should reboot with the host
            # (HostImpl::turn_off's remove_if)
            self.actors_at_boot = [spec for spec in self.actors_at_boot
                                   if spec.get("auto_restart")]
            Host.on_state_change(self)

    def engine_on_host_restart(self) -> None:
        # boot every recorded spec (HostImpl::turn_on); the port records
        # none until it has actors
        specs, self.actors_at_boot = self.actors_at_boot, []
        if specs:
            raise NotImplementedError(
                "rebooting actors needs the actor stack (ROADMAP queue A, "
                "item A3b)")
        Host.on_restart(self, 0)
        restart = getattr(self.engine, "on_host_restart", None)
        if restart is not None:
            restart(self)

    def on_speed_change(self) -> None:
        Host.on_speed_change_sig(self)

    # -- perf -------------------------------------------------------------
    def get_speed(self) -> float:
        # nominal speed of the current pstate (s4u::Host::get_speed);
        # the availability-profile factor is get_available_speed() —
        # the reference keeps them separate (s4u_Host.cpp), and the
        # platform-profile oracle pins the product decomposition
        return self.cpu.speed_per_pstate[self.cpu.pstate]

    def get_available_speed(self) -> float:
        return self.cpu.speed_scale

    def get_core_count(self) -> int:
        return self.cpu.core_count

    def get_load(self) -> float:
        return self.cpu.get_load()

    # -- pstates (s4u::Host::set_pstate & friends) ------------------------
    def set_pstate(self, index: int) -> None:
        # the reference's simcall, executed inline as the JAX package
        # does outside any actor context
        self.cpu.set_pstate(index)

    def get_pstate(self) -> int:
        return self.cpu.pstate

    def get_pstate_count(self) -> int:
        return self.cpu.get_pstate_count()

    def get_pstate_speed(self, index: int) -> float:
        assert 0 <= index < len(self.cpu.speed_per_pstate), \
            (f"Invalid pstate {index} (must be in "
             f"[0, {len(self.cpu.speed_per_pstate)})")
        return self.cpu.speed_per_pstate[index]

    # -- routing ----------------------------------------------------------
    def route_to(self, dst: "Host", links: List) -> float:
        """Fill `links` with the route to dst; returns the summed latency
        (reference s4u::Host::route_to → NetZoneImpl::get_global_route)."""
        from ..routing.zone import get_global_route
        return get_global_route(self.netpoint, dst.netpoint, links)


class HostCLM03Model(Model):
    """Composes CPU + network + storage minima (host_clm03.cpp)."""

    def __init__(self, engine):
        super().__init__(engine, UpdateAlgo.FULL)
        engine.host_model = self

    def next_occurring_event(self, now: float) -> float:
        e = self.engine
        min_by_cpu = e.cpu_model.next_occurring_event(now)
        if e.network_model.next_occurring_event_is_idempotent():
            min_by_net = e.network_model.next_occurring_event(now)
        else:
            min_by_net = -1.0
        min_by_sto = (e.storage_model.next_occurring_event(now)
                      if e.storage_model is not None else -1.0)
        res = min_by_cpu
        if res < 0 or (0.0 <= min_by_net < res):
            res = min_by_net
        if res < 0 or (0.0 <= min_by_sto < res):
            res = min_by_sto
        return res

    def update_actions_state(self, now: float, delta: float) -> None:
        pass  # host model has no action of its own

    def execute_parallel(self, hosts, flops_amounts, bytes_amounts, rate):
        raise NotImplementedError(
            "parallel tasks need the ptask_L07 model "
            "(--cfg=host/model:ptask_L07)")
