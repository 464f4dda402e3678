"""Cluster zones: flat crossbar/backbone clusters + the <cluster> tag.

The port's copy of ``simgrid_tpu/routing/cluster.py``.

Semantics from the reference's src/kernel/routing/ClusterZone.cpp (route =
src private up-link, optional limiter, optional backbone, dst private
down-link; loopback for self-routes) and sg_platf_new_cluster
(src/surf/sg_platf.cpp): one host + private link per radical entry, an
optional backbone, a cluster router for inter-zone traffic.  The fat-tree
/ torus / dragonfly variants subclass this and add their own interconnect
(their dedicated modules register themselves in the topology table).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..exceptions import ParseError
from ..ops.lmm_host import SharingPolicy
from .zone import NetPoint, NetPointType, NetZoneImpl


def make_duplex_link(engine, link_id: str, bw: float, lat: float,
                     sharing: str):
    """Create one cluster link; SPLITDUPLEX makes an _UP/_DOWN pair
    (sg_platf.cpp:132-134 naming).  Returns (link_up, link_down)."""
    model = engine.network_model
    if sharing == "SPLITDUPLEX":
        up = model.create_link(f"{link_id}_UP", bw, lat, SharingPolicy.SHARED)
        down = model.create_link(f"{link_id}_DOWN", bw, lat,
                                 SharingPolicy.SHARED)
        return up, down
    policy = (SharingPolicy.FATPIPE if sharing == "FATPIPE"
              else SharingPolicy.SHARED)
    link = model.create_link(link_id, bw, lat, policy)
    return link, link


def parse_radical(radical: str) -> List[int]:
    """Expand "0-9,12,15-20" to the explicit id list (sg_platf.cpp)."""
    ids: List[int] = []
    for group in radical.split(","):
        group = group.strip()
        if not group:
            continue
        if "-" in group:
            start, end = group.split("-")
            ids.extend(range(int(start), int(end) + 1))
        else:
            ids.append(int(group))
    return ids


class ClusterZone(NetZoneImpl):
    """Flat cluster: private links + optional backbone."""

    def __init__(self, engine, father, name):
        super().__init__(engine, father, name)
        self.private_links: Dict[int, Tuple[Optional[object], Optional[object]]] = {}
        self.backbone = None
        self.router: Optional[NetPoint] = None
        self.has_loopback = False
        self.has_limiter = False
        self.limiter_bw = 0.0
        self.num_links_per_node = 1
        # netpoint.id -> 0-based rank.  The reference indexes private links
        # by raw netpoint id, which only works when the cluster is alone in
        # the platform; the explicit map keeps multi-zone platforms correct.
        self.node_rank: Dict[int, int] = {}

    # position helpers (reference ClusterZone.hpp node_pos* )
    def node_pos(self, node_id: int) -> int:
        return node_id * self.num_links_per_node

    def node_pos_with_loopback(self, node_id: int) -> int:
        return self.node_pos(node_id) + (1 if self.has_loopback else 0)

    def node_pos_with_loopback_limiter(self, node_id: int) -> int:
        return self.node_pos_with_loopback(node_id) + (1 if self.has_limiter else 0)

    def add_private_link(self, position: int, link_up, link_down) -> None:
        self.private_links[position] = (link_up, link_down)

    def create_links_for_node(self, cluster_name: str, node_id, rank: int,
                              position: int, sharing: str, bw: float,
                              lat: float) -> None:
        """Default flat-cluster node links: one private (possibly
        split-duplex) link per node (ClusterZone::create_links_for_node +
        sg_platf_new_link's _UP/_DOWN split, sg_platf.cpp:132-134)."""
        link_up, link_down = make_duplex_link(
            self.engine, f"{cluster_name}_link_{node_id}", bw, lat, sharing)
        self.add_private_link(position, link_up, link_down)

    def get_local_route(self, src: NetPoint, dst: NetPoint, route,
                        latency) -> None:
        assert self.private_links, \
            "Cluster routing: no links attached to the source node"
        if src.id == dst.id and self.has_loopback:
            if not src.is_router():
                up, _ = self.private_links[
                    self.node_pos(self.node_rank[src.id])]
                self._add_link_latency(route.links, up, latency)
            return

        if not src.is_router():
            rank = self.node_rank[src.id]
            if self.has_limiter:
                up, _ = self.private_links[self.node_pos_with_loopback(rank)]
                route.links.append(up)
            up, _ = self.private_links[
                self.node_pos_with_loopback_limiter(rank)]
            if up is not None:
                self._add_link_latency(route.links, up, latency)

        if self.backbone is not None:
            self._add_link_latency(route.links, self.backbone, latency)

        if not dst.is_router():
            rank = self.node_rank[dst.id]
            _, down = self.private_links[
                self.node_pos_with_loopback_limiter(rank)]
            if down is not None:
                self._add_link_latency(route.links, down, latency)
            if self.has_limiter:
                up, _ = self.private_links[self.node_pos_with_loopback(rank)]
                route.links.append(up)


#: topology-string parsers registered by fat_tree/torus/dragonfly modules
_TOPO_ZONES = {}


def register_topo_zone(kind: str, cls) -> None:
    _TOPO_ZONES[kind] = cls


def parse_cluster_tag(loader, elem, father) -> None:
    """Create a cluster per the <cluster> tag (sg_platf_new_cluster)."""
    from ..models.host import Host

    engine = loader.engine
    name = elem.get("id")
    prefix = elem.get("prefix", "")
    suffix = elem.get("suffix", "")
    radical = elem.get("radical")
    speeds = elem.get("speed")
    bw = elem.get("bw")
    lat = elem.get("lat")
    core = int(elem.get("core", "1"))
    topology = elem.get("topology", "FLAT").upper()
    # DTD default is SPLITDUPLEX (simgrid.dtd:173): two directed links per
    # node.  FULLDUPLEX is the deprecated alias.
    sharing_policy = elem.get("sharing_policy", "SPLITDUPLEX").upper()
    if sharing_policy == "FULLDUPLEX":
        sharing_policy = "SPLITDUPLEX"
    bb_sharing = elem.get("bb_sharing_policy", "SHARED")

    if topology == "FLAT":
        zone = ClusterZone(engine, father, name)
    elif topology in _TOPO_ZONES:
        zone = _TOPO_ZONES[topology](engine, father, name,
                                     elem.get("topo_parameters", ""))
    else:
        raise ParseError(f"Unknown cluster topology {topology}")

    from ..platform.units import (parse_bandwidth, parse_speeds, parse_time)
    speed_list = parse_speeds(speeds)
    bw_value = parse_bandwidth(bw)
    lat_value = parse_time(lat)

    loopback_bw = elem.get("loopback_bw")
    loopback_lat = elem.get("loopback_lat")
    limiter_link = elem.get("limiter_link")
    if loopback_bw or loopback_lat:
        zone.has_loopback = True
    if limiter_link:
        zone.has_limiter = True
        zone.limiter_bw = parse_bandwidth(limiter_link)
    # Topology zones preset their own per-node link count (e.g. torus:
    # one per dimension); loopback/limiter slots add to it (sg_platf.cpp:
    # 174-182 ordering).
    zone.num_links_per_node += (1 if zone.has_loopback else 0) + \
        (1 if zone.has_limiter else 0)

    # cluster-level <prop> entries are copied onto every created host
    # (sg_platf.cpp:70-78; energy_cluster.xml sets watt_per_state here)
    # AND kept on the cluster's own NetZone (the reference attaches
    # them to the zone too — platform-properties oracle reads them via
    # get_englobing_zone()->get_properties())
    cluster_props = {child.get("id"): child.get("value")
                     for child in elem if child.tag == "prop"}
    if cluster_props:
        zone.properties.update(cluster_props)

    ids = parse_radical(radical)
    for rank, node_id in enumerate(ids):
        host_name = f"{prefix}{node_id}{suffix}"
        host = Host(engine, host_name)
        host.netpoint = NetPoint(engine, host_name, NetPointType.HOST, zone)
        engine.cpu_model.create_cpu(host, speed_list, core)
        if cluster_props:
            host.properties.update(cluster_props)
        zone.node_rank[host.netpoint.id] = rank

        if zone.has_loopback:
            lb = engine.network_model.create_link(
                f"{name}_link_{node_id}_loopback",
                parse_bandwidth(loopback_bw), parse_time(loopback_lat),
                SharingPolicy.FATPIPE)
            zone.add_private_link(zone.node_pos(rank), lb, lb)

        if zone.has_limiter:
            lim = engine.network_model.create_link(
                f"{name}_link_{node_id}_limiter",
                zone.limiter_bw, 0.0, SharingPolicy.SHARED)
            zone.add_private_link(zone.node_pos_with_loopback(rank),
                                  lim, lim)

        if hasattr(zone, "add_processing_node"):
            zone.add_processing_node(host.netpoint, rank)
        zone.create_links_for_node(
            name, node_id, rank, zone.node_pos_with_loopback_limiter(rank),
            sharing_policy, bw_value, lat_value)
        # Completion signal fires last, after links/rank wiring, matching
        # the <host> tag path (platform/xml.py) so listeners observe a
        # fully-built node (sg_platf.cpp fires s4u::Host::on_creation for
        # cluster nodes too — IB model and energy plugin key off it).
        Host.on_creation(host)

    # cluster router (for inter-zone routing)
    router_name = elem.get("router_id") or f"{prefix}{name}_router{suffix}"
    zone.router = NetPoint(engine, router_name, NetPointType.ROUTER, zone)

    bb_bw = elem.get("bb_bw")
    bb_lat = elem.get("bb_lat")
    if bb_bw or bb_lat:
        zone.backbone = engine.network_model.create_link(
            f"{name}_backbone", parse_bandwidth(bb_bw), parse_time(bb_lat),
            SharingPolicy.FATPIPE if bb_sharing == "FATPIPE"
            else SharingPolicy.SHARED)

    if hasattr(zone, "build_interconnect"):
        zone.build_interconnect(bw_value, lat_value, sharing_policy)

    for child in elem:
        if child.tag == "prop":
            zone.properties[child.get("id")] = child.get("value")


def parse_cabinet_tag(loader, elem, father) -> None:
    """<cabinet>: per-host SPLITDUPLEX private links inside a Cluster
    zone (reference sg_platf_new_cabinet, sg_platf.cpp:307-332: one
    host + one link_<host>_UP/_DOWN pair per radical entry)."""
    from ..models.host import Host
    from ..platform.units import parse_bandwidth, parse_speeds, parse_time
    from .zone import NetPoint, NetPointType
    prefix = elem.get("prefix", "")
    suffix = elem.get("suffix", "")
    speeds = parse_speeds(elem.get("speed"))
    bw = parse_bandwidth(elem.get("bw"))
    lat = parse_time(elem.get("lat"))
    engine = loader.engine
    for radical in parse_radical(elem.get("radical")):
        hostname = f"{prefix}{radical}{suffix}"
        host = Host(engine, hostname)
        host.netpoint = NetPoint(engine, hostname, NetPointType.HOST,
                                 father)
        engine.cpu_model.create_cpu(host, speeds, 1)
        Host.on_creation(host)     # plugins key off this signal
        up, down = make_duplex_link(engine, f"link_{hostname}", bw, lat,
                                    "SPLITDUPLEX")
        rank = len(father.node_rank)
        father.node_rank[host.netpoint.id] = rank
        father.add_private_link(father.node_pos(rank), up, down)


def parse_peer_tag(loader, elem, father) -> None:
    """<peer>: a host with up/down private links in a Vivaldi zone
    (sg_platf_new_peer)."""
    from ..models.host import Host
    from ..platform.units import parse_bandwidth, parse_speed, parse_time

    engine = loader.engine
    name = elem.get("id")
    host = Host(engine, name)
    host.netpoint = NetPoint(engine, name, NetPointType.HOST, father)
    engine.cpu_model.create_cpu(host, [parse_speed(elem.get("speed"))], 1)
    coords = elem.get("coordinates")
    if coords:
        host.netpoint.coords = [float(x) for x in coords.split()]
    assert hasattr(father, "set_peer_link"), \
        "<peer> tag can only be used in Vivaldi netzones"
    father.set_peer_link(host.netpoint,
                         parse_bandwidth(elem.get("bw_in")),
                         parse_bandwidth(elem.get("bw_out")))
    # Fires last so listeners observe coords + peer links (see cluster path).
    Host.on_creation(host)
