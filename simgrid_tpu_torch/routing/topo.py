"""Cluster interconnect topologies: fat-tree (d-mod-k), torus, dragonfly.

The port's copy of ``simgrid_tpu/routing/topo.py``.

Semantics from the reference implementations (structure re-designed around
an explicit rank map instead of global-netpoint-id arithmetic, so these
zones also work inside multi-zone platforms):

* FatTreeZone — p-ary l-tree per Zahavi's d-mod-k routing; construction
  and route walk per src/kernel/routing/FatTreeZone.cpp:62-359 (topo
  string ``levels;down-counts;up-counts;link-counts``).
* TorusZone — n-dim torus, dimension-order routing with wrap-around
  shortcut choice per src/kernel/routing/TorusZone.cpp:26-190 (topo
  string ``d1,d2,...``).
* DragonflyZone — Cray-Cascade-style group/chassis/blade/node hierarchy
  with green (intra-chassis), black (intra-group) and blue (inter-group)
  links, minimal routing, per
  src/kernel/routing/DragonflyZone.cpp:26-334 (topo string
  ``groups,blue;chassis,black;blades,green;nodes``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..exceptions import ParseError
from ..ops.lmm_host import SharingPolicy
from .cluster import ClusterZone, make_duplex_link, register_topo_zone
from .zone import NetPoint

_duplex = make_duplex_link


# ---------------------------------------------------------------------------
# Fat tree
# ---------------------------------------------------------------------------

class _FatTreeNode:
    __slots__ = ("id", "level", "position", "label", "parents", "children",
                 "limiter_link", "loopback")

    def __init__(self, id_, level, position):
        self.id = id_
        self.level = level
        self.position = position
        self.label: List[int] = []
        self.parents: List[Optional["_FatTreeLink"]] = []
        self.children: List[Optional["_FatTreeLink"]] = []
        self.limiter_link = None
        self.loopback = None


class _FatTreeLink:
    __slots__ = ("up_node", "down_node", "up_link", "down_link")

    def __init__(self, down_node, up_node, up_link, down_link):
        self.up_node = up_node
        self.down_node = down_node
        self.up_link = up_link
        self.down_link = down_link


class FatTreeZone(ClusterZone):
    """Fat tree with d-mod-k routing (FatTreeZone.cpp; topology from
    Zahavi, "D-Mod-K Routing Providing Non-Blocking Traffic for Shift
    Permutations on Real Life Fat Trees", 2010)."""

    def __init__(self, engine, father, name, topo_parameters: str):
        super().__init__(engine, father, name)
        parts = topo_parameters.split(";")
        if len(parts) != 4:
            raise ParseError(
                "Fat trees are defined by the levels number and 3 vectors: "
                f"'levels;downs;ups;link counts', got {topo_parameters!r}")
        try:
            self.levels = int(parts[0])
            self.num_children = [int(x) for x in parts[1].split(",")]
            self.num_parents = [int(x) for x in parts[2].split(",")]
            self.num_ports_lower = [int(x) for x in parts[3].split(",")]
        except ValueError as e:
            raise ParseError(f"Bad fat-tree topology {topo_parameters!r}: {e}")
        if not (len(self.num_children) == len(self.num_parents)
                == len(self.num_ports_lower) == self.levels):
            raise ParseError(
                f"Fat-tree vectors must each have {self.levels} entries")
        self.nodes: List[_FatTreeNode] = []
        self.compute_nodes: Dict[int, _FatTreeNode] = {}  # netpoint.id -> node
        self.tree_links: List[_FatTreeLink] = []
        self.nodes_by_level: List[int] = []
        self.num_links_per_node = 0

    # one compute node per <cluster> radical entry (sg_platf.cpp:254-255)
    def add_processing_node(self, netpoint: NetPoint, rank: int) -> None:
        node = _FatTreeNode(netpoint.id, 0, rank)
        node.parents = [None] * (self.num_parents[0] * self.num_ports_lower[0])
        node.label = [0] * self.levels
        self.compute_nodes[netpoint.id] = node
        self.nodes.append(node)

    def create_links_for_node(self, cluster_name, node_id, rank, position,
                              sharing, bw, lat) -> None:
        # Tree links replace the flat cluster's private links; loopback /
        # limiter stay in private_links (generic creation in cluster.py).
        pass

    # -- construction (reference seal(), FatTreeZone.cpp:133-177) ----------
    def build_interconnect(self, bw: float, lat: float, sharing: str) -> None:
        if self.levels == 0:
            return
        self._generate_switches()
        self._generate_labels()
        k = 0
        for lvl in range(self.levels):
            for _ in range(self.nodes_by_level[lvl]):
                self._connect_node_to_parents(self.nodes[k], bw, lat, sharing)
                k += 1
        if self.has_limiter:
            # Switch limiter links (compute nodes use the generic private
            # limiter; reference creates per-FatTreeNode links instead,
            # FatTreeZone.cpp:445-452 — same constraints either way).
            for node in self.nodes:
                if node.level > 0 and node.limiter_link is None:
                    node.limiter_link = self.engine.network_model.create_link(
                        f"{self.name}_limiter_switch_{node.id}",
                        self.limiter_bw, 0.0, SharingPolicy.SHARED)

    def _generate_switches(self) -> None:
        # FatTreeZone.cpp:236-276
        self.nodes_by_level = [0] * (self.levels + 1)
        n = 1
        for c in self.num_children:
            n *= c
        self.nodes_by_level[0] = n
        if n != len(self.nodes):
            raise ParseError(
                "The number of provided nodes does not fit with the wanted "
                f"fat-tree topology: need {n}, got {len(self.nodes)}")
        for i in range(self.levels):
            per = 1
            for j in range(i + 1):
                per *= self.num_parents[j]
            for j in range(i + 1, self.levels):
                per *= self.num_children[j]
            self.nodes_by_level[i + 1] = per

        switch_id = 0
        for i in range(self.levels):
            for j in range(self.nodes_by_level[i + 1]):
                switch_id -= 1
                node = _FatTreeNode(switch_id, i + 1, j)
                node.children = [None] * (self.num_children[i]
                                          * self.num_ports_lower[i])
                if i != self.levels - 1:
                    node.parents = [None] * (self.num_parents[i + 1]
                                             * self.num_ports_lower[i + 1])
                node.label = [0] * self.levels
                self.nodes.append(node)

    def _generate_labels(self) -> None:
        # Odometer labeling (FatTreeZone.cpp:278-327).
        k = 0
        for i in range(self.levels + 1):
            max_label = [(self.num_children[j] if j + 1 > i
                          else self.num_parents[j])
                         for j in range(self.levels)]
            current = [0] * self.levels
            for _ in range(self.nodes_by_level[i]):
                self.nodes[k].label = list(current)
                pos = 0
                while pos < self.levels:
                    current[pos] += 1
                    if current[pos] >= max_label[pos]:
                        current[pos] = 0
                        pos += 1
                    else:
                        break
                k += 1

    def _are_related(self, parent: _FatTreeNode, child: _FatTreeNode) -> bool:
        # FatTreeZone.cpp:203-234
        if parent.level != child.level + 1:
            return False
        for i in range(self.levels):
            if parent.label[i] != child.label[i] and i + 1 != parent.level:
                return False
        return True

    def _connect_node_to_parents(self, node: _FatTreeNode, bw, lat,
                                 sharing) -> None:
        # FatTreeZone.cpp:179-201
        lvl = node.level
        start = sum(self.nodes_by_level[:lvl + 1])
        for parent in self.nodes[start:start + self.nodes_by_level[lvl + 1]]:
            if not self._are_related(parent, node):
                continue
            for j in range(self.num_ports_lower[lvl]):
                link_id = (f"{self.name}_link_from_{node.id}_to_{parent.id}"
                           f"_{len(self.tree_links)}")
                up, down = _duplex(self.engine, link_id, bw, lat, sharing)
                link = _FatTreeLink(node, parent, up, down)
                parent_port = node.label[lvl] + j * self.num_children[lvl]
                child_port = parent.label[lvl] + j * self.num_parents[lvl]
                parent.children[parent_port] = link
                node.parents[child_port] = link
                self.tree_links.append(link)

    # -- routing (FatTreeZone.cpp:62-130) ----------------------------------
    def _in_sub_tree(self, root: _FatTreeNode, node: _FatTreeNode) -> bool:
        if root.level <= node.level:
            return False
        for i in range(node.level):
            if root.label[i] != node.label[i]:
                return False
        for i in range(root.level, self.levels):
            if root.label[i] != node.label[i]:
                return False
        return True

    def _limiter(self, node: _FatTreeNode, route) -> None:
        if not self.has_limiter:
            return
        if node.level == 0:
            pair = self.private_links.get(
                self.node_pos_with_loopback(self.node_rank[node.id]))
            if pair:
                route.links.append(pair[0])
        elif node.limiter_link is not None:
            route.links.append(node.limiter_link)

    def get_local_route(self, src: NetPoint, dst: NetPoint, route,
                        latency) -> None:
        if src.is_router() or dst.is_router():
            return
        source = self.compute_nodes[src.id]
        destination = self.compute_nodes[dst.id]

        if source.id == destination.id and self.has_loopback:
            pair = self.private_links[self.node_pos(self.node_rank[src.id])]
            self._add_link_latency(route.links, pair[0], latency)
            return

        current = source
        # Up: d-mod-k parent choice on the destination's position.
        while not self._in_sub_tree(current, destination):
            d = destination.position
            for i in range(current.level):
                d //= self.num_parents[i]
            d %= self.num_parents[current.level]
            link = current.parents[d]
            self._add_link_latency(route.links, link.up_link, latency)
            self._limiter(current, route)
            current = link.up_node

        # Down: label-guided descent (the reference keeps scanning the
        # (changing) children array mid-walk; replicated for identical
        # port selection, FatTreeZone.cpp:115-129).
        while current is not destination:
            i = 0
            while i < len(current.children):
                if (i % self.num_children[current.level - 1]
                        == destination.label[current.level - 1]):
                    link = current.children[i]
                    self._add_link_latency(route.links, link.down_link,
                                           latency)
                    current = link.down_node
                    self._limiter(current, route)
                i += 1


# ---------------------------------------------------------------------------
# Torus
# ---------------------------------------------------------------------------

class TorusZone(ClusterZone):
    """N-dimensional torus with dimension-order shortest-wrap routing
    (TorusZone.cpp)."""

    def __init__(self, engine, father, name, topo_parameters: str):
        super().__init__(engine, father, name)
        try:
            self.dimensions = [int(x) for x in topo_parameters.split(",")]
        except ValueError as e:
            raise ParseError(f"Bad torus dimensions {topo_parameters!r}: {e}")
        self.num_links_per_node = len(self.dimensions)

    def create_links_for_node(self, cluster_name, node_id, rank, position,
                              sharing, bw, lat) -> None:
        # One link per dimension towards the +1 neighbor (wrapping), stored
        # at position+j (TorusZone.cpp:26-67).
        dim_product = 1
        for j, dim in enumerate(self.dimensions):
            if (rank // dim_product) % dim == dim - 1:
                neighbor = rank - (dim - 1) * dim_product
            else:
                neighbor = rank + dim_product
            link_id = f"{cluster_name}_link_from_{node_id}_to_{neighbor}"
            up, down = _duplex(self.engine, link_id, bw, lat, sharing)
            self.add_private_link(position + j, up, down)
            dim_product *= dim

    def get_local_route(self, src: NetPoint, dst: NetPoint, route,
                        latency) -> None:
        if src.is_router() or dst.is_router():
            return
        src_rank = self.node_rank[src.id]
        dst_rank = self.node_rank[dst.id]

        if src_rank == dst_rank and self.has_loopback:
            pair = self.private_links[self.node_pos(src_rank)]
            self._add_link_latency(route.links, pair[0], latency)
            return

        dims = self.dimensions
        my_coords = []
        target_coords = []
        prod = 1
        for dim in dims:
            my_coords.append((src_rank // prod) % dim)
            target_coords.append((dst_rank // prod) % dim)
            prod *= dim

        current = src_rank
        while current != dst_rank:
            next_node = 0
            link_offset = 0
            node_offset = 0
            use_up = False
            dim_product = 1
            for j, dim in enumerate(dims):
                if (current // dim_product) % dim == (dst_rank // dim_product) % dim:
                    dim_product *= dim
                    continue
                # shorter to go "right" (+) with or without wrap-around?
                if ((target_coords[j] > my_coords[j]
                     and target_coords[j] <= my_coords[j] + dim // 2)
                        or (my_coords[j] > dim // 2
                            and (my_coords[j] + dim // 2) % dim
                            >= target_coords[j])):
                    if (current // dim_product) % dim == dim - 1:
                        next_node = current + dim_product - dim_product * dim
                    else:
                        next_node = current + dim_product
                    node_offset = self.node_pos(current)
                    use_up = True
                else:
                    if (current // dim_product) % dim == 0:
                        next_node = current - dim_product + dim_product * dim
                    else:
                        next_node = current - dim_product
                    node_offset = self.node_pos(next_node)
                    use_up = False
                link_offset = (node_offset
                               + (1 if self.has_loopback else 0)
                               + (1 if self.has_limiter else 0) + j)
                break

            if self.has_limiter:
                # The reference keys the limiter on nodeOffset, which is the
                # *next* node's offset for leftward/wrap hops
                # (TorusZone.cpp:176-179).
                pair = self.private_links[node_offset
                                          + (1 if self.has_loopback else 0)]
                route.links.append(pair[0])

            up, down = self.private_links[link_offset]
            self._add_link_latency(route.links, up if use_up else down,
                                   latency)
            current = next_node


# ---------------------------------------------------------------------------
# Dragonfly
# ---------------------------------------------------------------------------

class _DragonflyRouter:
    __slots__ = ("group", "chassis", "blade", "my_nodes", "green_links",
                 "black_links", "blue_link")

    def __init__(self, group, chassis, blade):
        self.group = group
        self.chassis = chassis
        self.blade = blade
        self.my_nodes: List = []
        self.green_links: List = []
        self.black_links: List = []
        self.blue_link = None


class DragonflyZone(ClusterZone):
    """Dragonfly (Cray Cascade): groups of chassis of blades of nodes;
    green/black/blue link classes, minimal routing (DragonflyZone.cpp)."""

    def __init__(self, engine, father, name, topo_parameters: str):
        super().__init__(engine, father, name)
        parts = topo_parameters.split(";")
        err = ("Dragonfly topologies are 'groups,blue;chassis,black;"
               "blades,green;nodes'")
        if len(parts) != 4:
            raise ParseError(err + f", got {topo_parameters!r}")
        try:
            self.num_groups, self.num_links_blue = \
                [int(x) for x in parts[0].split(",")]
            self.num_chassis, self.num_links_black = \
                [int(x) for x in parts[1].split(",")]
            self.num_blades, self.num_links_green = \
                [int(x) for x in parts[2].split(",")]
            self.num_nodes_per_blade = int(parts[3])
        except ValueError as e:
            raise ParseError(f"{err}: {e}")
        if self.num_groups > 1 and self.num_blades < self.num_groups:
            raise ParseError(
                "Dragonfly minimal routing reaches the group gateway through "
                "green links indexed by target group number: "
                "blades-per-chassis must be >= the number of groups")
        self.routers: List[_DragonflyRouter] = []
        self.num_links_per_node = 0

    def create_links_for_node(self, cluster_name, node_id, rank, position,
                              sharing, bw, lat) -> None:
        # Node<->router local links are generated with the interconnect;
        # the reference's (unused) per-node flat link is not replicated.
        pass

    def _coords(self, rank: int):
        # DragonflyZone.cpp:26-35
        per_group = self.num_chassis * self.num_blades * self.num_nodes_per_blade
        g, rank = divmod(rank, per_group)
        c, rank = divmod(rank, self.num_blades * self.num_nodes_per_blade)
        b, n = divmod(rank, self.num_nodes_per_blade)
        return g, c, b, n

    def _router(self, group, chassis, blade) -> _DragonflyRouter:
        return self.routers[group * self.num_chassis * self.num_blades
                            + chassis * self.num_blades + blade]

    def build_interconnect(self, bw: float, lat: float, sharing: str) -> None:
        # DragonflyZone.cpp:127-236.  Multi-link classes scale bandwidth
        # (create_link's numlinks multiplier).
        if self.num_nodes_per_blade == 0:
            return
        make = lambda lid, n: _duplex(self.engine, lid, bw * n, lat, sharing)

        for g in range(self.num_groups):
            for c in range(self.num_chassis):
                for b in range(self.num_blades):
                    self.routers.append(_DragonflyRouter(g, c, b))

        uid = 0
        n_routers = len(self.routers)
        # local node<->router links
        for i, router in enumerate(self.routers):
            router.green_links = [None] * self.num_blades
            router.black_links = [None] * self.num_chassis
            for j in range(self.num_nodes_per_blade):
                up, down = make(
                    f"{self.name}_local_link_from_router_{i}_to_node_{j}"
                    f"_{uid}", 1)
                router.my_nodes.append((up, down))
                uid += 1

        # green: all-to-all between blades of one chassis
        for i in range(self.num_groups * self.num_chassis):
            for j in range(self.num_blades):
                for k in range(j + 1, self.num_blades):
                    up, down = make(
                        f"{self.name}_green_link_in_chassis_"
                        f"{i % self.num_chassis}_between_routers_{j}_and_{k}"
                        f"_{uid}", self.num_links_green)
                    self.routers[i * self.num_blades + j].green_links[k] = up
                    self.routers[i * self.num_blades + k].green_links[j] = down
                    uid += 1

        # black: all-to-all between chassis of one group, blade-wise
        per_group = self.num_chassis * self.num_blades
        for g in range(self.num_groups):
            for j in range(self.num_chassis):
                for k in range(j + 1, self.num_chassis):
                    for b in range(self.num_blades):
                        up, down = make(
                            f"{self.name}_black_link_in_group_{g}"
                            f"_between_chassis_{j}_and_{k}_blade_{b}_{uid}",
                            self.num_links_black)
                        self.routers[g * per_group + j * self.num_blades
                                     + b].black_links[k] = up
                        self.routers[g * per_group + k * self.num_blades
                                     + b].black_links[j] = down
                        uid += 1

        # blue: router j of group i <-> router i of group j
        for i in range(self.num_groups):
            for j in range(i + 1, self.num_groups):
                ri = i * per_group + j
                rj = j * per_group + i
                assert ri < n_routers and rj < n_routers  # by the ctor guard
                up, down = make(
                    f"{self.name}_blue_link_between_group_{i}_and_{j}"
                    f"_routers_{ri}_and_{rj}_{uid}", self.num_links_blue)
                self.routers[ri].blue_link = up
                self.routers[rj].blue_link = down
                uid += 1

    def get_local_route(self, src: NetPoint, dst: NetPoint, route,
                        latency) -> None:
        # Minimal routing (DragonflyZone.cpp:238-334).
        if src.is_router() or dst.is_router():
            return
        src_rank = self.node_rank[src.id]
        dst_rank = self.node_rank[dst.id]

        if src_rank == dst_rank and self.has_loopback:
            pair = self.private_links[self.node_pos(src_rank)]
            self._add_link_latency(route.links, pair[0], latency)
            return

        mg, mc, mb, mn = self._coords(src_rank)
        tg, tc, tb, tn = self._coords(dst_rank)
        my_router = self._router(mg, mc, mb)
        target_router = self._router(tg, tc, tb)
        current = my_router

        # node -> source router
        self._add_link_latency(route.links, my_router.my_nodes[mn][0],
                               latency)
        if self.has_limiter:
            pair = self.private_links[self.node_pos_with_loopback(src_rank)]
            route.links.append(pair[0])

        per_group = self.num_chassis * self.num_blades
        if target_router is not my_router:
            if target_router.group != current.group:
                # Reach our group's gateway router (flat in-group offset ==
                # target group number, mirroring the blue wiring), hop the
                # blue link, land on the peer gateway.  Flat offsets below
                # replicate the reference arithmetic exactly
                # (DragonflyZone.cpp:285-309).
                if current.blade != tg:
                    self._add_link_latency(route.links,
                                           current.green_links[tg], latency)
                    current = self.routers[mg * per_group
                                           + mc * self.num_blades + tg]
                if current.chassis != 0:
                    self._add_link_latency(route.links,
                                           current.black_links[0], latency)
                    current = self.routers[mg * per_group + tg]
                self._add_link_latency(route.links, current.blue_link,
                                       latency)
                current = self.routers[tg * per_group + mg]
            if target_router.blade != current.blade:
                self._add_link_latency(route.links,
                                       current.green_links[tb], latency)
                current = self.routers[tg * per_group + tb]
            if target_router.chassis != current.chassis:
                self._add_link_latency(route.links,
                                       current.black_links[tc], latency)

        if self.has_limiter:
            pair = self.private_links[self.node_pos_with_loopback(dst_rank)]
            route.links.append(pair[0])
        # target router -> node (down direction)
        self._add_link_latency(route.links, target_router.my_nodes[tn][1],
                               latency)


register_topo_zone("FAT_TREE", FatTreeZone)
register_topo_zone("TORUS", TorusZone)
register_topo_zone("DRAGONFLY", DragonflyZone)
