"""Network models: base interface, CM02/LV08 flow-level TCP model, constant.

The port's copy of ``simgrid_tpu/models/network.py``.  Semantics from the reference's src/surf/network_interface.cpp (factor
hooks, latency accounting in next-event) and src/surf/network_cm02.cpp:
one LMM constraint per link, one variable per flow expanded on every link
of the route; LV08 corrections (latency x13.01, bandwidth x0.97, RTT
weight S=20537 added to the penalty per link); latency modeled as a
0-penalty phase ended by a 'latency hat' heap event (lazy) or per-delta
decrement (full); optional cross-traffic expands the reverse route at
weight 0.05; TCP-gamma window bound rate <= gamma/(2*RTT).
"""

from __future__ import annotations

import math
from typing import List, Optional

from ..kernel.resource import (Action, ActionState, HeapType, Model, Resource,
                               NO_MAX_DURATION, UpdateAlgo)
from ..kernel import profile as profile_mod
from ..ops import opstats
from ..ops.lmm_host import SharingPolicy, System, double_update
from ..utils.config import config
from ..utils.signal import Signal


class NetworkAction(Action):
    """A flow (reference network_interface.hpp NetworkAction)."""

    on_state_change = Signal()

    def __init__(self, model, size: float, failed: bool):
        super().__init__(model, size, failed)
        self.latency = 0.0
        self.lat_current = 0.0
        self.rate = -1.0
        # True while this running action is counted in the model's
        # latency_phase_count census (FULL-mode fast path)
        self._lat_counted = False
        # Links on the route whose bandwidth is currently 0: the flow is
        # parked (infinite penalty) while any exist.  sharing_penalty keeps
        # only the *finite* part so a later bandwidth restore can undo the
        # park without inf-inf arithmetic (C++ would NaN here).
        self.parked_links = 0
        # link name -> how many weight-S terms of this flow that link
        # carries (occurrences on the FORWARD route).  set_bandwidth
        # must adjust exactly these: the constraint also holds
        # cross-traffic flows (reverse route, weight 0.05) that carry
        # no weight-S term for this link at all, and a flow whose
        # forward and reverse routes share a link sits on the
        # constraint twice but pays the term only once.
        self.ws_links: dict = {}

    @property
    def effective_penalty(self) -> float:
        return math.inf if self.parked_links else self.sharing_penalty

    def set_state(self, state: ActionState) -> None:
        if self._lat_counted and state != ActionState.STARTED:
            # leaving the started set while still in the latency phase
            # (failure, cancel, early finish): drop it from the model's
            # latency census
            self._lat_counted = False
            self.model.latency_phase_count -= 1
        super().set_state(state)
        NetworkAction.on_state_change(self)

    def is_running(self) -> bool:
        return self.state_set is self.model.started_action_set

    def update_remains_lazy(self, now: float) -> None:
        # reference NetworkCm02Action::update_remains_lazy
        if not self.is_running():
            return
        delta = now - self.last_update
        if self.remains > 0:
            self.update_remains(self.last_value * delta)
        self.update_max_duration(delta)
        if ((self.remains <= 0 and self.variable.sharing_penalty > 0)
                or (self.max_duration != NO_MAX_DURATION
                    and self.max_duration <= 0)):
            self.finish(ActionState.FINISHED)
            self.model.action_heap.remove(self)
        self.last_update = now
        self.last_value = self.variable.value


class LinkImpl(Resource):
    """A network link (reference network_interface.cpp LinkImpl)."""

    on_creation = Signal()
    on_destruction = Signal()
    on_state_change = Signal()
    on_bandwidth_change = Signal()
    on_communicate = Signal()   # (action, src, dst)

    def __init__(self, model, name: str, constraint):
        super().__init__(model, name, constraint)
        constraint.id = self
        self.bandwidth_peak = 0.0
        self.bandwidth_scale = 1.0
        self.latency_peak = 0.0
        self.latency_scale = 1.0
        self.properties = {}
        self.bandwidth_event: Optional[profile_mod.Event] = None
        self.latency_event: Optional[profile_mod.Event] = None
        self.state_event: Optional[profile_mod.Event] = None
        model.engine.links[name] = self

    def get_bandwidth(self) -> float:
        return self.bandwidth_peak * self.bandwidth_scale

    def get_latency(self) -> float:
        return self.latency_peak * self.latency_scale

    def get_sharing_policy(self) -> SharingPolicy:
        return self.constraint.sharing_policy

    def is_used(self) -> bool:
        return self.constraint._acs_hook is not None

    def turn_on(self) -> None:
        if not self.is_on_flag:
            self.is_on_flag = True
            LinkImpl.on_state_change(self)

    def turn_off(self) -> None:
        # reference LinkImpl::turn_off + network_cm02 state event: fail all
        # actions crossing this link
        if self.is_on_flag:
            self.is_on_flag = False
            LinkImpl.on_state_change(self)
            now = self.model.engine.now
            for var in list(self.constraint.iter_variables()):
                action = var.id
                if action is not None and action.get_state() in (
                        ActionState.INITED, ActionState.STARTED,
                        ActionState.IGNORED):
                    action.finish_time = now
                    # the comm post path maps link-killed flows to
                    # LINK_FAILURE and endpoint-host kills to
                    # SRC/DST_HOST_FAILURE; the cause is recorded here
                    # because the FAILED state alone cannot tell them apart
                    action.failure_cause = "link"
                    action.set_state(ActionState.FAILED)

    def set_bandwidth_profile(self, profile: profile_mod.Profile) -> None:
        self.bandwidth_event = profile.schedule(
            self.model.engine.future_evt_set, self)

    def set_latency_profile(self, profile: profile_mod.Profile) -> None:
        self.latency_event = profile.schedule(
            self.model.engine.future_evt_set, self)

    def set_state_profile(self, profile: profile_mod.Profile) -> None:
        self.state_event = profile.schedule(
            self.model.engine.future_evt_set, self)


class NetworkModel(Model):
    """Base network model (network_interface.cpp)."""

    def __init__(self, engine, algo: UpdateAlgo):
        super().__init__(engine, algo)
        engine.network_model = self
        self.loopback: Optional[LinkImpl] = None
        #: running actions still in their latency phase (FULL mode).
        #: Maintained so next_occurring_event_full can skip its O(V)
        #: latency walk in the common all-latencies-paid drain phase.
        self.latency_phase_count = 0

    def get_latency_factor(self, size: float) -> float:
        return config["network/latency-factor"]

    def get_bandwidth_factor(self, size: float) -> float:
        return config["network/bandwidth-factor"]

    def get_bandwidth_constraint(self, rate: float, bound: float,
                                 size: float) -> float:
        return rate

    def next_occurring_event_full(self, now: float) -> float:
        # reference NetworkModel::next_occuring_event_full: account for the
        # latency phase of not-yet-flowing actions.  The walk is O(V)
        # per advance and a pure-drain phase (all latencies paid) never
        # needs it: the census counter skips it outright.
        min_res = super().next_occurring_event_full(now)
        if self.latency_phase_count:
            for action in self.started_action_set:
                if action.latency > 0:
                    min_res = action.latency if min_res < 0 \
                        else min(min_res, action.latency)
        return min_res

    def communicate(self, src, dst, size: float, rate: float) -> NetworkAction:
        raise NotImplementedError

    def create_link(self, name: str, bandwidth: float, latency: float,
                    policy: SharingPolicy = SharingPolicy.SHARED) -> LinkImpl:
        raise NotImplementedError


class NetworkCm02Model(NetworkModel):
    """The LV08/CM02 fluid model (network_cm02.cpp)."""

    def __init__(self, engine):
        algo = (UpdateAlgo.FULL if config["network/optim"] == "Full"
                else UpdateAlgo.LAZY)
        super().__init__(engine, algo)
        select = config["network/maxmin-selective-update"]
        if config["network/optim"] == "Lazy":
            assert select or config.is_default("network/maxmin-selective-update"), \
                "You cannot disable network selective update with lazy updates"
            select = True
        self.set_maxmin_system(System(select))
        if select and config["network/optim"] == "Full":
            # FULL-mode sharing recomputation never drains the
            # modified-actions list; keeping it would pin every retired
            # action forever.  Selective bookkeeping here tracks
            # constraints only — the input of the warm-started device
            # solve (ops.lmm_warm), which is what Full+selective buys:
            # mutating phases re-solve only the modified component.
            self.system.modified_actions = None
        # device-resident drain fast path (ops.drain_path): FULL-mode
        # pure-drain phases delegate batches of advances to the
        # superstep executor; a no-op until its preconditions hold
        from ..ops.drain_path import DrainFastPath
        self.drain_fastpath = DrainFastPath(self)
        self.loopback = self.create_link(
            "__loopback__", config["network/loopback-bw"],
            config["network/loopback-lat"], SharingPolicy.FATPIPE)

    def create_link(self, name: str, bandwidth: float, latency: float,
                    policy: SharingPolicy = SharingPolicy.SHARED) -> "NetworkCm02Link":
        if policy == SharingPolicy.WIFI:
            # single-rate WIFI declaration: one modulation level
            if latency:
                raise ValueError(
                    f"WIFI link {name!r}: latency is not modeled on "
                    "access points (the reference hardcodes 0, "
                    "network_cm02.cpp:385) — refusing to drop it "
                    "silently")
            return NetworkWifiLink(self, name, [bandwidth])
        return NetworkCm02Link(self, name, bandwidth, latency, policy)

    def create_wifi_link(self, name: str,
                         bandwidths: List[float]) -> "NetworkWifiLink":
        """An access-point link with one bandwidth per modulation level
        (reference NetworkCm02Model::create_link, network_cm02.cpp:93-97)."""
        return NetworkWifiLink(self, name, bandwidths)

    def update_actions_state_lazy(self, now: float, delta: float) -> None:
        eps = config["surf/precision"]
        while (not self.action_heap.empty()
               and abs(self.action_heap.top_date() - now) < eps):
            action = self.action_heap.pop()
            if action.heap_type == HeapType.LATENCY:
                # latency paid: open the flow
                self.system.update_variable_penalty(action.variable,
                                                    action.effective_penalty)
                self.action_heap.remove(action)
                action.set_last_update()
            else:
                action.finish(ActionState.FINISHED)
                self.action_heap.remove(action)

    def capture_drain_scenario(self):
        """Snapshot the CURRENT pure-drain phase for the batched
        campaign executor (parallel.campaign.Campaign.from_engine):
        flattened arrays + slot/link maps, or None when the phase is
        not a pure drain.  Gated exactly like the drain fast path —
        FULL mode with every started flow past its latency and
        unconstrained by deadlines — so a campaign can only fork from
        a state the fast path itself could serve."""
        from ..ops import drain_path
        if self.is_lazy() or self.latency_phase_count:
            return None
        return drain_path.capture_scenario(self)

    def next_occurring_event_full(self, now: float) -> float:
        dt = self.drain_fastpath.serve(now)
        if dt is not None:
            return dt
        return super().next_occurring_event_full(now)

    def update_actions_state_full(self, now: float, delta: float) -> None:
        if self.drain_fastpath.apply(now, delta):
            return
        if len(self.started_action_set):
            opstats.bump("native_advances")
        eps = config["surf/precision"]
        # direct IntrusiveList traversal (removal-safe for the current
        # node): no O(V) list(...) allocation per advance
        for action in self.started_action_set:
            deltap = delta
            if action.latency > 0:
                if action.latency > deltap:
                    action.latency = double_update(action.latency, deltap, eps)
                    deltap = 0.0
                else:
                    deltap = double_update(deltap, action.latency, eps)
                    action.latency = 0.0
                if action.latency <= 0.0:
                    if action._lat_counted:
                        action._lat_counted = False
                        self.latency_phase_count -= 1
                    if not action.is_suspended():
                        self.system.update_variable_penalty(
                            action.variable, action.effective_penalty)
            if not action.variable.get_number_of_constraint():
                # no link on the route (e.g. vivaldi): complete immediately
                action.update_remains(action.get_remains_no_update())
            action.update_remains(action.variable.value * delta)
            if action.max_duration != NO_MAX_DURATION:
                action.update_max_duration(delta)
            if ((action.get_remains_no_update() <= 0
                 and action.variable.sharing_penalty > 0)
                    or (action.max_duration != NO_MAX_DURATION
                        and action.max_duration <= 0)):
                action.finish(ActionState.FINISHED)

    def communicate(self, src, dst, size: float, rate: float) -> NetworkAction:
        # reference NetworkCm02Model::communicate (network_cm02.cpp:165-279)
        route: List[LinkImpl] = []
        if src is dst:
            # Hosts without an explicit self-route ride the default
            # loopback (the reference's cluster/smpirun fabrics declare
            # per-host loopbacks; flat platforms get the model's). The
            # lookup failure is tolerated only for the self case, and
            # an empty result (asserts stripped under -O) falls back
            # the same way.
            try:
                latency = src.route_to(dst, route)
            except AssertionError:
                route, latency = [], 0.0
            if not route and latency <= 0:
                route = [self.loopback]
                latency = self.loopback.get_latency()
        else:
            latency = src.route_to(dst, route)
        assert route or latency > 0, \
            (f"No route between '{src.name}' and '{dst.name}'")

        failed = any(not link.is_on() for link in route)
        back_route: List[LinkImpl] = []
        crosstraffic = config["network/crosstraffic"]
        if crosstraffic:
            if src is dst:
                back_route = list(route)   # self-comm: same loopback
            else:
                dst.route_to(src, back_route)
            if not failed:
                failed = any(not link.is_on() for link in back_route)

        action = NetworkAction(self, size, failed)
        action.sharing_penalty = latency
        action.latency = latency
        action.rate = rate
        if self.is_lazy():
            action.set_last_update()

        weight_s = config["network/weight-S"]
        if weight_s > 0:
            for link in route:
                bw = link.get_bandwidth()
                if bw > 0:
                    action.sharing_penalty += weight_s / bw
                else:
                    action.parked_links += 1
                action.ws_links[link.name] = \
                    action.ws_links.get(link.name, 0) + 1

        bw_factor = self.get_bandwidth_factor(size)
        bandwidth_bound = -1.0 if not route else bw_factor * route[0].get_bandwidth()
        for link in route:
            bandwidth_bound = min(bandwidth_bound,
                                  bw_factor * link.get_bandwidth())

        action.lat_current = action.latency
        action.latency *= self.get_latency_factor(size)
        action.rate = self.get_bandwidth_constraint(action.rate,
                                                    bandwidth_bound, size)
        constraints_per_variable = len(route) + len(back_route)

        if action.latency > 0:
            action.variable = self.system.variable_new(
                action, 0.0, -1.0, constraints_per_variable)
            if self.is_lazy():
                date = action.latency + action.last_update
                type_ = HeapType.NORMAL if not route else HeapType.LATENCY
                self.action_heap.insert(action, date, type_)
            elif action.state_set is self.started_action_set:
                # FULL mode latency census (skips the O(V) walk in
                # next_occurring_event_full once all latencies are paid)
                action._lat_counted = True
                self.latency_phase_count += 1
        else:
            action.variable = self.system.variable_new(
                action, 1.0, -1.0, constraints_per_variable)
            if (action.sharing_penalty <= 0 and weight_s <= 0
                    and not action.parked_links):
                # pure CM02 (weight-S 0) on a zero-latency route: the
                # variable runs at penalty 1 immediately, and the lazy
                # drain's bogus-priority skip must not ignore the
                # action or its completion never gets scheduled
                # (energy-link tesh: 25kB over the latency-0 bus).
                # Parked weight-S flows keep 0: un-parking re-adds
                # their S/bw terms from that base.
                action.sharing_penalty = 1.0

        gamma = config["network/TCP-gamma"]
        if action.rate < 0:
            self.system.update_variable_bound(
                action.variable,
                gamma / (2.0 * action.lat_current) if action.lat_current > 0
                else -1.0)
        else:
            self.system.update_variable_bound(
                action.variable,
                min(action.rate, gamma / (2.0 * action.lat_current))
                if action.lat_current > 0 else action.rate)

        for link in route:
            if link.get_sharing_policy() == SharingPolicy.WIFI:
                # WIFI constraint capacity is normalized AIRTIME (1.0);
                # a station's flow consumes airtime at 1/host_rate per
                # byte/s, so faster modulations leave more airtime for
                # the others (reference network_cm02.cpp:240-260).
                # Explicit raises (not bare asserts): user-input
                # validation must survive python -O.
                if crosstraffic:
                    raise AssertionError(
                        "Cross-traffic is not yet supported when using "
                        "WIFI. Please use --cfg=network/crosstraffic:0")
                src_rate = link.get_host_rate(src)
                dst_rate = link.get_host_rate(dst)
                if src_rate < 0 and dst_rate < 0:
                    raise AssertionError(
                        "Some stations are not associated to any access "
                        "point. Make sure to call set_host_rate on all "
                        "stations.")
                # when BOTH endpoints are stations of this AP the src
                # modulation wins — the reference's own open TODO
                # (network_cm02.cpp:249 "for the moment we use src rate")
                rate = src_rate if src_rate >= 0 else dst_rate
                self.system.expand(link.constraint, action.variable,
                                   1.0 / rate)
            else:
                self.system.expand(link.constraint, action.variable, 1.0)
        if crosstraffic:
            for link in back_route:
                self.system.expand(link.constraint, action.variable, 0.05)

        LinkImpl.on_communicate(action, src, dst)
        return action


class NetworkWifiLink(LinkImpl):
    """An 802.11 access point: the LMM constraint shares normalized
    AIRTIME (capacity 1.0 after the bandwidth factor), per-station
    modulation levels translate byte rates into airtime weights at
    expand time (reference NetworkWifiLink, network_cm02.hpp:56-80,
    network_cm02.cpp:383-420).  Stations associate with
    set_host_rate(host, level); level indexes the bandwidths list."""

    def __init__(self, model: NetworkCm02Model, name: str,
                 bandwidths: List[float]):
        bw_factor = config["network/bandwidth-factor"]
        # bound = bw_factor * (1/bw_factor) = exactly 1.0 of airtime
        super().__init__(model, name,
                         model.system.constraint_new(None, 1.0))
        self.constraint.id = self
        self.constraint.sharing_policy = SharingPolicy.WIFI
        self.bandwidth_peak = 1.0 / bw_factor
        self.latency_peak = 0.0
        self.bandwidths = list(bandwidths)
        self.host_rates: dict = {}
        LinkImpl.on_creation(self)

    def get_sharing_policy(self) -> SharingPolicy:
        return SharingPolicy.WIFI

    def set_host_rate(self, host, rate_level: int) -> None:
        self.host_rates[host.name] = rate_level

    def get_host_rate(self, host) -> float:
        level = self.host_rates.get(host.name)
        if level is None:
            return -1.0
        assert 0 <= level < len(self.bandwidths), \
            f"Host {host.name!r} has an invalid rate {level}"
        return self.bandwidths[level] * self.bandwidth_scale

    def apply_event(self, event: profile_mod.Event, value: float) -> None:
        if event is self.state_event:
            if value > 0:
                self.turn_on()
            else:
                self.turn_off()
        else:
            raise AssertionError("Unknown event on a WIFI link!")


class NetworkCm02Link(LinkImpl):
    def __init__(self, model: NetworkCm02Model, name: str, bandwidth: float,
                 latency: float, policy: SharingPolicy):
        bw_factor = config["network/bandwidth-factor"]
        super().__init__(model, name,
                         model.system.constraint_new(None, bw_factor * bandwidth))
        self.constraint.id = self
        self.bandwidth_peak = bandwidth
        self.latency_peak = latency
        if policy == SharingPolicy.FATPIPE:
            self.constraint.sharing_policy = SharingPolicy.FATPIPE
        LinkImpl.on_creation(self)

    def apply_event(self, event: profile_mod.Event, value: float) -> None:
        if event is self.bandwidth_event:
            self.set_bandwidth(value)
        elif event is self.latency_event:
            self.set_latency(value)
        elif event is self.state_event:
            if value > 0:
                self.turn_on()
            else:
                self.turn_off()
        else:
            raise AssertionError("Unknown event!")

    def set_bandwidth(self, value: float) -> None:
        # reference NetworkCm02Link::set_bandwidth (network_cm02.cpp:326-349)
        old = self.bandwidth_peak * self.bandwidth_scale
        self.bandwidth_peak = value
        bw_factor = config["network/bandwidth-factor"]
        self.model.system.update_constraint_bound(
            self.constraint,
            bw_factor * self.bandwidth_peak * self.bandwidth_scale)
        LinkImpl.on_bandwidth_change(self)
        weight_s = config["network/weight-S"]
        if weight_s > 0:
            # A zero-bandwidth trace event parks the flows (infinite
            # penalty) instead of aborting; the park is tracked as a count
            # so a later restore works (delta arithmetic with inf would NaN).
            # Each flow is adjusted by its recorded number of weight-S
            # terms for THIS link (ws_links): iter_variables yields one
            # entry per element, and with cross-traffic a constraint also
            # holds reverse flows that carry no term for this link.
            seen: set = set()
            for var in list(self.constraint.iter_variables()):
                action = var.id
                if isinstance(action, NetworkAction) and id(var) not in seen:
                    seen.add(id(var))
                    n = action.ws_links.get(self.name, 0)
                    if not n:
                        continue
                    if old > 0:
                        action.sharing_penalty -= n * (weight_s / old)
                    else:
                        action.parked_links -= n
                    if value > 0:
                        action.sharing_penalty += n * (weight_s / value)
                    else:
                        action.parked_links += n
                    if not action.is_suspended():
                        self.model.system.update_variable_penalty(
                            action.variable, action.effective_penalty)

    def set_latency(self, value: float) -> None:
        # reference NetworkCm02Link::set_latency (network_cm02.cpp:351-381)
        delta = value - self.latency_peak
        self.latency_peak = value
        gamma = config["network/TCP-gamma"]
        for var in list(self.constraint.iter_variables()):
            action = var.id
            if not isinstance(action, NetworkAction):
                continue
            action.lat_current += delta
            action.sharing_penalty += delta
            lat_bound = (gamma / (2.0 * action.lat_current)
                         if action.lat_current else math.inf)
            if action.rate < 0:
                self.model.system.update_variable_bound(
                    action.variable, lat_bound)
            else:
                self.model.system.update_variable_bound(
                    action.variable, min(action.rate, lat_bound))
            if not action.is_suspended():
                self.model.system.update_variable_penalty(
                    action.variable, action.effective_penalty)


class NetworkConstantModel(NetworkModel):
    """Every communication takes a constant time (network_constant.cpp):
    the scalability baseline stripping network physics.  No links, no LMM;
    latency = network/latency-factor."""

    def __init__(self, engine):
        super().__init__(engine, UpdateAlgo.FULL)
        self.set_maxmin_system(System(False))

    def create_link(self, name, bandwidth, latency, policy=SharingPolicy.SHARED):
        raise AssertionError(
            f"Refusing to create the link {name}: there is no link in the "
            "Constant network model (use routing='None')")

    def next_occurring_event(self, now: float) -> float:
        min_res = -1.0
        for action in self.started_action_set:
            if action.latency > 0 and (min_res < 0 or action.latency < min_res):
                min_res = action.latency
        return min_res

    def update_actions_state(self, now: float, delta: float) -> None:
        eps = config["surf/precision"]
        for action in self.started_action_set:
            if action.latency > 0:
                if action.latency > delta:
                    action.latency = double_update(action.latency, delta, eps)
                else:
                    action.latency = 0.0
            action.update_remains(action.cost * delta / action.initial_latency)
            action.update_max_duration(delta)
            if (action.get_remains_no_update() <= 0
                    or (action.max_duration != NO_MAX_DURATION
                        and action.max_duration <= 0)):
                action.finish(ActionState.FINISHED)

    def communicate(self, src, dst, size: float, rate: float) -> NetworkAction:
        action = NetworkConstantAction(self, size,
                                       config["network/latency-factor"])
        LinkImpl.on_communicate(action, src, dst)
        return action


class NetworkConstantAction(NetworkAction):
    def __init__(self, model, size: float, latency: float):
        super().__init__(model, size, False)
        self.latency = latency
        self.initial_latency = latency
        if latency <= 0.0:
            self.set_state(ActionState.FINISHED)
