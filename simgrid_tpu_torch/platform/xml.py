"""Platform file loader: accepts the reference's simgrid.dtd XML files.

The port's copy of ``simgrid_tpu/platform/xml.py`` (storage tags raise:
the storage model is not ported).  Parses the same tags/attributes as the reference SAX callbacks
(src/surf/xml/surfxml_sax_cb.cpp + sg_platf.cpp): zones
(Full/Floyd/Dijkstra/DijkstraCache/None/Vivaldi/Cluster variants), hosts
(speed pstates, core, availability/state profiles, coordinates), routers,
links (bandwidth, latency, sharing policy, profiles), routes & zoneRoutes
with link_ctn, bypass routes, clusters/cabinets, peers, traces and
trace_connect, and properties — built on xml.etree instead of generated
FleXML C.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

from ..exceptions import ParseError
from ..kernel import profile as profile_mod
from ..ops.lmm_host import SharingPolicy
from ..routing.routed import (DijkstraZone, EmptyZone, FloydZone, FullZone,
                              VivaldiZone)
from ..routing.zone import NetPoint, NetPointType, NetZoneImpl
from .units import parse_bandwidth, parse_speeds, parse_time

_ZONE_FACTORY = {}


def register_zone_factory(routing: str, factory) -> None:
    _ZONE_FACTORY[routing] = factory


def _make_zone(engine, father, name: str, routing: str) -> NetZoneImpl:
    routing = routing or "None"
    if routing in _ZONE_FACTORY:
        return _ZONE_FACTORY[routing](engine, father, name)
    if routing == "Full":
        return FullZone(engine, father, name)
    if routing == "Floyd":
        return FloydZone(engine, father, name)
    if routing == "Dijkstra":
        return DijkstraZone(engine, father, name, cached=False)
    if routing == "DijkstraCache":
        return DijkstraZone(engine, father, name, cached=True)
    if routing == "None":
        return EmptyZone(engine, father, name)
    if routing == "Vivaldi":
        return VivaldiZone(engine, father, name)
    if routing == "Cluster":
        from ..routing.cluster import ClusterZone
        return ClusterZone(engine, father, name)
    raise ParseError(f"Unknown zone routing '{routing}'")


class PlatformLoader:
    """Builds the platform into an EngineImpl from an XML file or tree."""

    def __init__(self, engine):
        self.engine = engine
        self.base_dir = "."
        self.trace_connect_list: List[Dict[str, str]] = []

    # -- public ------------------------------------------------------------
    def load(self, path: str) -> None:
        self.base_dir = os.path.dirname(os.path.abspath(path))
        try:
            tree = ET.parse(path)
        except ET.ParseError as e:
            raise ParseError(f"{path}: {e}") from None
        root = tree.getroot()
        from .dtd import validate
        validate(root, path)
        # remember where the platform file lives: storage content files
        # resolve against it (and against the 'path' config entries)
        self.engine.platform_dir = self.base_dir
        for child in root:
            self._dispatch_toplevel(child, None)
        if self.engine.netzone_root is not None:
            self.engine.netzone_root.seal()
        self._apply_trace_connects()
        from ..kernel.engine import EngineImpl
        EngineImpl.on_platform_created()

    # -- dispatch ----------------------------------------------------------
    def _dispatch_toplevel(self, elem, zone) -> None:
        tag = elem.tag
        if tag in ("zone", "AS"):
            self._parse_zone(elem, zone)
        elif tag == "trace":
            self._parse_trace(elem)
        elif tag == "trace_connect":
            self.trace_connect_list.append(dict(elem.attrib))
        elif tag == "config":
            self._parse_config(elem)
        elif tag == "cluster":
            # a top-level <cluster> IS the platform (the DTD allows it;
            # energy_cluster.xml) — it becomes its own root zone
            self._parse_cluster(elem, zone)
        elif tag == "prop":
            pass
        else:
            raise ParseError(f"Unexpected top-level tag <{tag}>")

    def _parse_zone(self, elem, father) -> NetZoneImpl:
        name = elem.get("id")
        routing = elem.get("routing")
        zone = _make_zone(self.engine, father, name, routing)
        for child in elem:
            tag = child.tag
            if tag in ("zone", "AS"):
                self._parse_zone(child, zone)
            elif tag == "host":
                self._parse_host(child, zone)
            elif tag == "router":
                self._parse_router(child, zone)
            elif tag == "link":
                self._parse_link(child, zone)
            elif tag == "route":
                self._parse_route(child, zone, zone_route=False)
            elif tag in ("zoneRoute", "ASroute"):
                self._parse_route(child, zone, zone_route=True)
            elif tag in ("bypassRoute", "bypassZoneRoute", "bypassASroute"):
                self._parse_route(child, zone, zone_route="bypass" )
            elif tag == "cluster":
                self._parse_cluster(child, zone)
            elif tag == "cabinet":
                self._parse_cabinet(child, zone)
            elif tag == "peer":
                self._parse_peer(child, zone)
            elif tag == "prop":
                zone.properties[child.get("id")] = child.get("value")
            elif tag == "trace":
                self._parse_trace(child)
            elif tag == "trace_connect":
                self.trace_connect_list.append(dict(child.attrib))
            elif tag == "backbone":
                self._parse_backbone(child, zone)
            elif tag == "host_link":
                self._parse_host_link(child, zone)
            elif tag in ("storage_type", "storage", "mount", "disk"):
                self._parse_storage(child, zone)
            else:
                raise ParseError(f"Unexpected tag <{tag}> in zone {name}")
        return zone

    # -- entities ----------------------------------------------------------
    def _parse_host(self, elem, zone) -> None:
        from ..models.host import Host
        name = elem.get("id")
        speeds = parse_speeds(elem.get("speed"))
        core = int(elem.get("core", "1"))
        host = Host(self.engine, name)
        host.netpoint = NetPoint(self.engine, name, NetPointType.HOST, zone)
        cpu = self.engine.cpu_model.create_cpu(host, speeds, core)
        pstate = elem.get("pstate")
        if pstate:
            cpu.set_pstate(int(pstate))
        coords = elem.get("coordinates")
        if coords:
            host.netpoint.coords = [float(x) for x in coords.split()]
        # "speed_file" is the v4.1 name, "availability_file" the legacy one
        avail_file = elem.get("speed_file") or elem.get("availability_file")
        if avail_file:
            cpu.set_speed_profile(self._profile_from_file(avail_file))
        state_file = elem.get("state_file")
        if state_file:
            cpu.set_state_profile(self._profile_from_file(state_file))
        for child in elem:
            if child.tag == "prop":
                host.properties[child.get("id")] = child.get("value")
            elif child.tag == "mount":
                # <mount storageId=... name=...>: per-HOST mount table
                # (a storage can be attached to one host and mounted
                # on another — storage.xml mounts alice's Disk2 on
                # denise as 'c:')
                host.mounts[child.get("name")] = child.get("storageId")
        from ..models.host import Host as H
        H.on_creation(host)

    def _parse_router(self, elem, zone) -> None:
        name = elem.get("id")
        netpoint = NetPoint(self.engine, name, NetPointType.ROUTER, zone)
        coords = elem.get("coordinates")
        if coords:
            netpoint.coords = [float(x) for x in coords.split()]

    def _parse_link(self, elem, zone) -> None:
        name = elem.get("id")
        latency = parse_time(elem.get("latency", "0"))
        policy_str = elem.get("sharing_policy", "SHARED")
        policies = {"SHARED": SharingPolicy.SHARED,
                    "FATPIPE": SharingPolicy.FATPIPE,
                    "SPLITDUPLEX": SharingPolicy.SHARED,
                    "WIFI": SharingPolicy.WIFI}
        if policy_str not in policies:
            raise ValueError(
                f"Link {name!r}: unknown sharing_policy {policy_str!r} "
                f"(expected one of {sorted(policies)})")
        policy = policies[policy_str]
        if policy_str == "WIFI":
            # one bandwidth per modulation level, comma-separated
            # (reference sg_platf link parsing for WIFI links)
            if latency:
                raise ValueError(
                    f"Link {name!r}: latency is not modeled on WIFI "
                    "access points — refusing to drop it silently")
            bandwidths = [parse_bandwidth(b) for b in
                          elem.get("bandwidth").split(",")]
            model = self.engine.network_model
            if not hasattr(model, "create_wifi_link"):
                raise ValueError(
                    f"Link {name!r}: sharing_policy WIFI is not "
                    f"supported by the {type(model).__name__} network "
                    "model — refusing to simulate it as a wired link")
            link = model.create_wifi_link(name, bandwidths)
            self._attach_link_extras(elem, link)
            return
        bandwidth = parse_bandwidth(elem.get("bandwidth"))
        if policy_str == "SPLITDUPLEX":
            # two directed links, suffixed _UP and _DOWN (sg_platf.cpp)
            for suffix in ("_UP", "_DOWN"):
                link = self.engine.network_model.create_link(
                    name + suffix, bandwidth, latency, SharingPolicy.SHARED)
                self._attach_link_extras(elem, link)
        else:
            link = self.engine.network_model.create_link(
                name, bandwidth, latency, policy)
            self._attach_link_extras(elem, link)

    def _attach_link_extras(self, elem, link) -> None:
        bw_file = elem.get("bandwidth_file")
        if bw_file:
            link.set_bandwidth_profile(self._profile_from_file(bw_file))
        lat_file = elem.get("latency_file")
        if lat_file:
            link.set_latency_profile(self._profile_from_file(lat_file))
        state_file = elem.get("state_file")
        if state_file:
            link.set_state_profile(self._profile_from_file(state_file))
        for child in elem:
            if child.tag == "prop":
                link.properties[child.get("id")] = child.get("value")

    def _get_link(self, name: str, direction: Optional[str] = None):
        if direction in ("UP", "DOWN"):
            name = f"{name}_{direction}"
        link = self.engine.links.get(name)
        if link is None:
            raise ParseError(f"Unknown link '{name}'")
        return link

    def _parse_route(self, elem, zone, zone_route) -> None:
        src = self.engine.netpoints.get(elem.get("src"))
        dst = self.engine.netpoints.get(elem.get("dst"))
        if src is None or dst is None:
            raise ParseError(f"Route with unknown endpoint "
                             f"{elem.get('src')} -> {elem.get('dst')}")
        gw_src = gw_dst = None
        if zone_route and zone_route != "bypass" or (
                zone_route == "bypass" and elem.get("gw_src")):
            if elem.get("gw_src"):
                gw_src = self.engine.netpoints.get(elem.get("gw_src"))
                gw_dst = self.engine.netpoints.get(elem.get("gw_dst"))
        links = []
        for child in elem:
            if child.tag == "link_ctn":
                links.append(self._get_link(child.get("id"),
                                            child.get("direction")))
        symmetrical = elem.get("symmetrical", "YES").upper() in ("YES", "TRUE")
        if zone_route == "bypass":
            zone.add_bypass_route(src, dst, gw_src, gw_dst, links, False)
        else:
            zone.add_route(src, dst, gw_src, gw_dst, links, symmetrical)

    # -- aggregates --------------------------------------------------------
    def _parse_cluster(self, elem, zone) -> None:
        from ..routing.cluster import parse_cluster_tag
        parse_cluster_tag(self, elem, zone)

    def _parse_cabinet(self, elem, zone) -> None:
        from ..routing.cluster import parse_cabinet_tag
        parse_cabinet_tag(self, elem, zone)

    def _parse_peer(self, elem, zone) -> None:
        from ..routing.cluster import parse_peer_tag
        parse_peer_tag(self, elem, zone)

    def _parse_host_link(self, elem, zone) -> None:
        """<host_link id=... up=... down=...> inside a manual
        routing="Cluster" zone: attach the host's private link pair
        (sg_platf_new_hostlink, sg_platf.cpp)."""
        host_name = elem.get("id")
        host = self.engine.hosts.get(host_name)
        if host is None:
            raise ParseError(f"<host_link> references unknown host "
                             f"'{host_name}'")
        if host.netpoint.englobing_zone is not zone:
            raise ParseError(f"<host_link> host '{host_name}' does not "
                             f"belong to cluster zone '{zone.name}'")

        def link_of(attr):
            name = elem.get(attr)
            link = self.engine.links.get(name)
            if link is None:
                raise ParseError(f"<host_link> references unknown link "
                                 f"'{name}'")
            return getattr(link, "pimpl", link)

        netpoint = host.netpoint
        if netpoint.id in zone.node_rank:
            raise ParseError(f"Duplicate <host_link> for '{host_name}'")
        rank = len(zone.node_rank)
        zone.node_rank[netpoint.id] = rank
        zone.add_private_link(zone.node_pos(rank), link_of("up"),
                              link_of("down"))

    def _parse_backbone(self, elem, zone) -> None:
        name = elem.get("id")
        bandwidth = parse_bandwidth(elem.get("bandwidth"))
        latency = parse_time(elem.get("latency", "0"))
        link = self.engine.network_model.create_link(name, bandwidth, latency,
                                                     SharingPolicy.SHARED)
        zone.backbone = link

    def _parse_storage(self, elem, zone) -> None:
        raise NotImplementedError(
            f"<{elem.tag}>: the storage model is not ported to "
            "simgrid_tpu_torch (ROADMAP queue A, item A21)")

    # -- traces ------------------------------------------------------------
    def _parse_trace(self, elem) -> None:
        name = elem.get("id")
        file_attr = elem.get("file")
        periodicity = float(elem.get("periodicity", "-1"))
        if file_attr:
            profile_mod.Profile.from_file(self._resolve(file_attr))
        else:
            profile_mod.Profile.from_string(name, elem.text or "", periodicity)

    def _profile_from_file(self, path: str) -> profile_mod.Profile:
        resolved = self._resolve(path)
        if resolved in profile_mod.trace_list:
            return profile_mod.trace_list[resolved]
        return profile_mod.Profile.from_file(resolved)

    def _resolve(self, path: str) -> str:
        if os.path.isabs(path):
            return path
        return os.path.join(self.base_dir, path)

    def _apply_trace_connects(self) -> None:
        for tc in self.trace_connect_list:
            trace = profile_mod.trace_list.get(tc.get("trace"))
            if trace is None:
                raise ParseError(f"Unknown trace '{tc.get('trace')}' "
                                 f"in trace_connect")
            kind = tc.get("kind", "HOST_AVAIL")
            element = tc.get("element")
            if kind in ("SPEED", "POWER"):
                self.engine.hosts[element].cpu.set_speed_profile(trace)
            elif kind == "HOST_AVAIL":
                self.engine.hosts[element].cpu.set_state_profile(trace)
            elif kind == "BANDWIDTH":
                self.engine.links[element].set_bandwidth_profile(trace)
            elif kind == "LATENCY":
                self.engine.links[element].set_latency_profile(trace)
            elif kind == "LINK_AVAIL":
                self.engine.links[element].set_state_profile(trace)
            else:
                raise ParseError(f"Unknown trace_connect kind '{kind}'")

    def _parse_config(self, elem) -> None:
        from ..utils.config import config
        for child in elem:
            if child.tag == "prop":
                config.set(child.get("id"), child.get("value"))
