"""Scenario campaigns: fleets of what-if drains over one shared system
(:mod:`.campaign`)."""

from .campaign import (MIN_LINK_FACTOR, Campaign, ReplicaResult,
                       ScenarioPlan, ScenarioSpec)

__all__ = ["MIN_LINK_FACTOR", "Campaign", "ReplicaResult", "ScenarioPlan",
           "ScenarioSpec"]
