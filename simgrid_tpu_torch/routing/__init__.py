"""Platform routing of the port: netzone tree, route resolution, topology
zones."""

from .zone import (NetPoint, NetPointType, NetZoneImpl, Route,
                   get_global_route)
from .routed import (RoutedZone, FullZone, FloydZone, DijkstraZone,
                     EmptyZone, VivaldiZone)
from .cluster import ClusterZone
from .topo import FatTreeZone, TorusZone, DragonflyZone

__all__ = ["NetPoint", "NetPointType", "NetZoneImpl", "Route",
           "get_global_route", "RoutedZone", "FullZone", "FloydZone",
           "DijkstraZone", "EmptyZone", "VivaldiZone", "ClusterZone",
           "FatTreeZone", "TorusZone", "DragonflyZone"]
