"""Hierarchical netzones + global route resolution.

The port's copy of ``simgrid_tpu/routing/zone.py``.

Semantics from the reference's src/kernel/routing/NetZoneImpl.cpp: the
platform is a tree of netzones, each owning a local routing algorithm;
a global route is resolved by finding the common ancestor of src and dst,
taking the ancestor's local route between the two child zones' gateways
and recursing toward both endpoints (NetZoneImpl.cpp:374-416), with
optional bypass routes short-circuiting the walk (265-360).
"""

from __future__ import annotations

from enum import Enum
from typing import Dict, List, Optional, Tuple

from ..utils.signal import Signal


class NetPointType(Enum):
    HOST = 0
    ROUTER = 1
    NETZONE = 2


class NetPoint:
    """A routing endpoint (reference NetPoint.cpp)."""

    on_creation = Signal()

    def __init__(self, engine, name: str, kind: NetPointType,
                 englobing_zone: Optional["NetZoneImpl"]):
        self.engine = engine
        self.name = name
        self.kind = kind
        self.englobing_zone = englobing_zone
        self.id = -1  # position inside the englobing zone's routing table
        self.coords: Optional[List[float]] = None  # vivaldi coordinates
        if englobing_zone is not None:
            self.id = englobing_zone.register_netpoint(self)
        engine.netpoints[name] = self
        NetPoint.on_creation(self)

    def is_netzone(self) -> bool:
        return self.kind == NetPointType.NETZONE

    def is_router(self) -> bool:
        return self.kind == NetPointType.ROUTER

    def __repr__(self):
        return f"<NetPoint {self.name}>"


class Route:
    """A local route (reference RouteCreationArgs)."""

    __slots__ = ("links", "gw_src", "gw_dst")

    def __init__(self, links=None, gw_src=None, gw_dst=None):
        self.links: List = links or []
        self.gw_src: Optional[NetPoint] = gw_src
        self.gw_dst: Optional[NetPoint] = gw_dst


class NetZoneImpl:
    """Base netzone (reference NetZoneImpl.cpp)."""

    on_creation = Signal()
    on_seal = Signal()

    def __init__(self, engine, father: Optional["NetZoneImpl"], name: str):
        self.engine = engine
        self.father = father
        self.name = name
        self.children: List["NetZoneImpl"] = []
        self.vertices: List[NetPoint] = []   # netpoints of this zone
        self.bypass_routes: Dict[Tuple[NetPoint, NetPoint], Route] = {}
        self.properties: Dict[str, str] = {}
        self.sealed = False
        if father is not None:
            father.children.append(self)
        else:
            engine.netzone_root = self
        self.netpoint = NetPoint(engine, name, NetPointType.NETZONE, father)
        NetZoneImpl.on_creation(self)

    def __repr__(self):
        return f"<{type(self).__name__} {self.name}>"

    def register_netpoint(self, netpoint: NetPoint) -> int:
        self.vertices.append(netpoint)
        return len(self.vertices) - 1

    def get_hosts(self) -> List:
        return [self.engine.hosts[v.name] for v in self.vertices
                if v.kind == NetPointType.HOST]

    # -- route declaration -------------------------------------------------
    def add_route(self, src: NetPoint, dst: NetPoint,
                  gw_src: Optional[NetPoint], gw_dst: Optional[NetPoint],
                  links: List, symmetrical: bool = True) -> None:
        raise NotImplementedError(
            f"NetZone {self.name} does not accept explicit routes")

    def add_bypass_route(self, src: NetPoint, dst: NetPoint,
                         gw_src: Optional[NetPoint],
                         gw_dst: Optional[NetPoint], links: List,
                         symmetrical: bool = False) -> None:
        route = Route(list(links), gw_src, gw_dst)
        self.bypass_routes[(src, dst)] = route
        if symmetrical:
            self.bypass_routes[(dst, src)] = Route(list(reversed(links)),
                                                   gw_dst, gw_src)

    def seal(self) -> None:
        self.sealed = True
        for child in self.children:
            child.seal()
        NetZoneImpl.on_seal(self)

    # -- local routing -----------------------------------------------------
    def get_local_route(self, src: NetPoint, dst: NetPoint, route: Route,
                        latency: List[float]) -> None:
        raise NotImplementedError

    def _add_link_latency(self, route_links: List, link, latency: List[float]):
        route_links.append(link)
        if latency is not None:
            latency[0] += link.get_latency()

    # -- bypass ------------------------------------------------------------
    def get_bypass_route(self, src: NetPoint, dst: NetPoint, links: List,
                         latency: List[float]) -> bool:
        # reference NetZoneImpl.cpp:265-360
        if not self.bypass_routes:
            return False
        if (src.englobing_zone is self and dst.englobing_zone is self):
            route = self.bypass_routes.get((src, dst))
            if route is not None:
                for link in route.links:
                    self._add_link_latency(links, link, latency)
                return True
            return False

        path_src = _path_to_root(src)
        path_dst = _path_to_root(dst)
        while (len(path_src) > 1 and len(path_dst) > 1
               and path_src[-1] is path_dst[-1]):
            path_src.pop()
            path_dst.pop()

        max_index_src = len(path_src) - 1
        max_index_dst = len(path_dst) - 1
        bypassed = None
        key = None
        for mx in range(max(max_index_src, max_index_dst) + 1):
            for i in range(mx):
                if i <= max_index_src and mx <= max_index_dst:
                    key = (path_src[i].netpoint, path_dst[mx].netpoint)
                    bypassed = self.bypass_routes.get(key)
                    if bypassed:
                        break
                if mx <= max_index_src and i <= max_index_dst:
                    key = (path_src[mx].netpoint, path_dst[i].netpoint)
                    bypassed = self.bypass_routes.get(key)
                    if bypassed:
                        break
            if bypassed:
                break
            if mx <= max_index_src and mx <= max_index_dst:
                key = (path_src[mx].netpoint, path_dst[mx].netpoint)
                bypassed = self.bypass_routes.get(key)
                if bypassed:
                    break
        if bypassed:
            if src is not key[0]:
                get_global_route_impl(src, bypassed.gw_src, links, latency)
            for link in bypassed.links:
                self._add_link_latency(links, link, latency)
            if key[1] is not dst:
                get_global_route_impl(bypassed.gw_dst, dst, links, latency)
            return True
        return False


def _path_to_root(netpoint: NetPoint) -> List[NetZoneImpl]:
    path = []
    current = netpoint.englobing_zone
    while current is not None:
        path.append(current)
        current = current.father
    return path


def _find_common_ancestors(src: NetPoint, dst: NetPoint):
    # reference NetZoneImpl.cpp:221-263
    path_src = _path_to_root(src)
    path_dst = _path_to_root(dst)
    father = None
    while (len(path_src) > 1 and len(path_dst) > 1
           and path_src[-1] is path_dst[-1]):
        father = path_src[-1]
        path_src.pop()
        path_dst.pop()
    src_ancestor = path_src[-1]
    dst_ancestor = path_dst[-1]
    common_ancestor = src_ancestor if src_ancestor is dst_ancestor else father
    return common_ancestor, src_ancestor, dst_ancestor


def get_global_route_impl(src: NetPoint, dst: NetPoint, links: List,
                          latency: Optional[List[float]]) -> None:
    # reference NetZoneImpl::get_global_route (NetZoneImpl.cpp:374-416)
    common_ancestor, src_ancestor, dst_ancestor = _find_common_ancestors(src, dst)

    if common_ancestor.get_bypass_route(src, dst, links, latency):
        return

    if src_ancestor is dst_ancestor:
        route = Route(links=links)
        common_ancestor.get_local_route(src, dst, route, latency)
        links[:] = route.links
        return

    route = Route()
    common_ancestor.get_local_route(src_ancestor.netpoint,
                                    dst_ancestor.netpoint, route, latency)
    assert route.gw_src is not None and route.gw_dst is not None, \
        f"Bad gateways for route from '{src.name}' to '{dst.name}'"

    if src is not route.gw_src:
        get_global_route_impl(src, route.gw_src, links, latency)
    links.extend(route.links)
    if route.gw_dst is not dst:
        get_global_route_impl(route.gw_dst, dst, links, latency)


def get_global_route(src: NetPoint, dst: NetPoint, links: List) -> float:
    """Resolve the full route; returns the accumulated latency."""
    latency = [0.0]
    get_global_route_impl(src, dst, links, latency)
    return latency[0]
