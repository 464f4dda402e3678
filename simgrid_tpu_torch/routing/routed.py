"""Table-driven routing zones: Full, Floyd, Dijkstra, Empty, Vivaldi.

The port's copy of ``simgrid_tpu/routing/routed.py``.

Semantics from the reference's src/kernel/routing/{RoutedZone,FullZone,
FloydZone,DijkstraZone,EmptyZone,VivaldiZone}.cpp: explicit route tables,
all-pairs shortest path, on-demand shortest path with cache, no routing at
all, and coordinate-based latency estimation.
"""

from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional, Tuple

from ..ops.lmm_host import SharingPolicy
from .zone import NetPoint, NetZoneImpl, Route


class RoutedZone(NetZoneImpl):
    """Base for zones with explicit route declarations
    (reference RoutedZone.cpp)."""

    def _new_route(self, src: NetPoint, dst: NetPoint,
                   gw_src: Optional[NetPoint], gw_dst: Optional[NetPoint],
                   links: List, symmetrical: bool, reverse: bool) -> Route:
        route = Route()
        route.gw_src = gw_dst if reverse else gw_src
        route.gw_dst = gw_src if reverse else gw_dst
        route.links = list(reversed(links)) if reverse else list(links)
        return route

    def _check_route(self, src: NetPoint, dst: NetPoint,
                     gw_src, gw_dst) -> None:
        if src.is_netzone():
            assert gw_src is not None and not gw_src.is_netzone(), \
                f"The gw_src of route {src.name}->{dst.name} must be a host/router"
        if dst.is_netzone():
            assert gw_dst is not None and not gw_dst.is_netzone(), \
                f"The gw_dst of route {src.name}->{dst.name} must be a host/router"


class FullZone(RoutedZone):
    """Full routing table (reference FullZone.cpp)."""

    def __init__(self, engine, father, name):
        super().__init__(engine, father, name)
        self._table: Dict[Tuple[int, int], Route] = {}

    def add_route(self, src, dst, gw_src, gw_dst, links,
                  symmetrical: bool = True) -> None:
        self._check_route(src, dst, gw_src, gw_dst)
        assert (src.id, dst.id) not in self._table, \
            f"Route from '{src.name}' to '{dst.name}' already defined"
        self._table[(src.id, dst.id)] = self._new_route(
            src, dst, gw_src, gw_dst, links, symmetrical, False)
        if symmetrical and src is not dst:
            assert (dst.id, src.id) not in self._table, \
                f"Reverse route from '{dst.name}' to '{src.name}' already defined"
            self._table[(dst.id, src.id)] = self._new_route(
                src, dst, gw_src, gw_dst, links, symmetrical, True)

    def get_local_route(self, src, dst, route, latency) -> None:
        e_route = self._table.get((src.id, dst.id))
        assert e_route is not None, \
            f"No route from '{src.name}' to '{dst.name}' in zone '{self.name}'"
        route.gw_src = e_route.gw_src
        route.gw_dst = e_route.gw_dst
        for link in e_route.links:
            self._add_link_latency(route.links, link, latency)


class FloydZone(RoutedZone):
    """All-pairs shortest path, computed at seal time
    (reference FloydZone.cpp)."""

    def __init__(self, engine, father, name):
        super().__init__(engine, father, name)
        self._edges: Dict[Tuple[int, int], Route] = {}
        self._nxt: Optional[Dict[Tuple[int, int], int]] = None

    def add_route(self, src, dst, gw_src, gw_dst, links,
                  symmetrical: bool = True) -> None:
        self._check_route(src, dst, gw_src, gw_dst)
        self._edges[(src.id, dst.id)] = self._new_route(
            src, dst, gw_src, gw_dst, links, symmetrical, False)
        if symmetrical and src is not dst:
            self._edges[(dst.id, src.id)] = self._new_route(
                src, dst, gw_src, gw_dst, links, symmetrical, True)

    def seal(self) -> None:
        # Floyd-Warshall over link counts, with first-hop reconstruction.
        n = len(self.vertices)
        cost = [[math.inf] * n for _ in range(n)]
        nxt: Dict[Tuple[int, int], int] = {}
        for i in range(n):
            cost[i][i] = 0.0
        for (i, j), route in self._edges.items():
            cost[i][j] = len(route.links)
            nxt[(i, j)] = j
        for k in range(n):
            for i in range(n):
                if cost[i][k] == math.inf:
                    continue
                row_k = cost[k]
                row_i = cost[i]
                for j in range(n):
                    alt = row_i[k] + row_k[j]
                    if alt < row_i[j]:
                        row_i[j] = alt
                        nxt[(i, j)] = nxt[(i, k)]
        self._nxt = nxt
        super().seal()

    def get_local_route(self, src, dst, route, latency) -> None:
        assert getattr(self, "_nxt", None) is not None, \
            "FloydZone must be sealed first"
        cur = src.id
        first = True
        while cur != dst.id:
            hop = self._nxt.get((cur, dst.id))
            assert hop is not None, \
                f"No route from '{src.name}' to '{dst.name}' in zone '{self.name}'"
            e_route = self._edges[(cur, hop)]
            if first:
                route.gw_src = e_route.gw_src
                first = False
            route.gw_dst = e_route.gw_dst
            for link in e_route.links:
                self._add_link_latency(route.links, link, latency)
            cur = hop


class DijkstraZone(RoutedZone):
    """On-demand shortest path with optional route cache
    (reference DijkstraZone.cpp)."""

    def __init__(self, engine, father, name, cached: bool = True):
        super().__init__(engine, father, name)
        self.cached = cached
        self._graph: Dict[int, List[Tuple[int, Tuple[int, int]]]] = {}
        self._edges: Dict[Tuple[int, int], Route] = {}
        self._cache: Dict[int, Dict[int, int]] = {}

    def add_route(self, src, dst, gw_src, gw_dst, links,
                  symmetrical: bool = True) -> None:
        self._check_route(src, dst, gw_src, gw_dst)
        self._edges[(src.id, dst.id)] = self._new_route(
            src, dst, gw_src, gw_dst, links, symmetrical, False)
        self._graph.setdefault(src.id, []).append((dst.id, (src.id, dst.id)))
        if symmetrical and src is not dst:
            self._edges[(dst.id, src.id)] = self._new_route(
                src, dst, gw_src, gw_dst, links, symmetrical, True)
            self._graph.setdefault(dst.id, []).append((src.id, (dst.id, src.id)))

    def _shortest(self, src_id: int) -> Dict[int, int]:
        """Dijkstra from src; returns predecessor map."""
        if self.cached and src_id in self._cache:
            return self._cache[src_id]
        dist = {src_id: 0.0}
        pred: Dict[int, int] = {}
        heap = [(0.0, src_id)]
        while heap:
            d, u = heapq.heappop(heap)
            if d > dist.get(u, math.inf):
                continue
            for v, edge_key in self._graph.get(u, ()):
                nd = d + len(self._edges[edge_key].links)
                if nd < dist.get(v, math.inf):
                    dist[v] = nd
                    pred[v] = u
                    heapq.heappush(heap, (nd, v))
        if self.cached:
            self._cache[src_id] = pred
        return pred

    def get_local_route(self, src, dst, route, latency) -> None:
        if src.id == dst.id:
            loop = self._edges.get((src.id, dst.id))
            if loop is not None:
                for link in loop.links:
                    self._add_link_latency(route.links, link, latency)
            return
        pred = self._shortest(src.id)
        assert dst.id in pred, \
            f"No route from '{src.name}' to '{dst.name}' in zone '{self.name}'"
        path = [dst.id]
        while path[-1] != src.id:
            path.append(pred[path[-1]])
        path.reverse()
        for i in range(len(path) - 1):
            e_route = self._edges[(path[i], path[i + 1])]
            if i == 0:
                route.gw_src = e_route.gw_src
            route.gw_dst = e_route.gw_dst
            for link in e_route.links:
                self._add_link_latency(route.links, link, latency)


class EmptyZone(NetZoneImpl):
    """routing="None": no routing at all (reference EmptyZone.cpp)."""

    def get_local_route(self, src, dst, route, latency) -> None:
        raise AssertionError(
            f"No routing in zone '{self.name}' (routing='None'): "
            f"cannot route from {src.name} to {dst.name}")


class VivaldiZone(NetZoneImpl):
    """Coordinate-based latency (reference VivaldiZone.cpp): endpoints
    carry (x, y, h) network coordinates; latency = euclidean xy distance
    plus both heights, in ms; peers get directed private links
    link_<name>_{UP,DOWN} (set_peer_link, VivaldiZone.cpp:67-81)."""

    def __init__(self, engine, father, name):
        super().__init__(engine, father, name)
        self.private_links = {}  # netpoint.id -> (link_up, link_down)

    def add_route(self, src, dst, gw_src, gw_dst, links,
                  symmetrical: bool = True) -> None:
        raise AssertionError("No explicit routes in Vivaldi zones")

    def set_peer_link(self, netpoint, bw_in: float, bw_out: float) -> None:
        up = self.engine.network_model.create_link(
            f"link_{netpoint.name}_UP", bw_out, 0.0, SharingPolicy.SHARED)
        down = self.engine.network_model.create_link(
            f"link_{netpoint.name}_DOWN", bw_in, 0.0, SharingPolicy.SHARED)
        self.private_links[netpoint.id] = (up, down)

    def get_local_route(self, src, dst, route, latency) -> None:
        if src.is_netzone():
            # Gateways follow the child-router naming convention
            # (VivaldiZone.cpp:88-92).
            route.gw_src = self.engine.netpoints.get(f"router_{src.name}")
            route.gw_dst = self.engine.netpoints.get(f"router_{dst.name}")

        src_links = self.private_links.get(src.id)
        if src_links is not None and src_links[0] is not None:
            self._add_link_latency(route.links, src_links[0], latency)
        dst_links = self.private_links.get(dst.id)
        if dst_links is not None and dst_links[1] is not None:
            self._add_link_latency(route.links, dst_links[1], latency)

        if latency is not None:
            c_src = src.coords
            c_dst = dst.coords
            assert c_src is not None and c_dst is not None, \
                f"Missing coordinates for {src.name} or {dst.name}"
            dist = math.sqrt((c_src[0] - c_dst[0]) ** 2
                             + (c_src[1] - c_dst[1]) ** 2)
            latency[0] += (dist + abs(c_src[2]) + abs(c_dst[2])) / 1000.0

