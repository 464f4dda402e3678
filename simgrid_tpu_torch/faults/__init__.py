"""Fault campaigns of the port: seeded MTBF/MTTR schedules compiled to
the drain's device event tape (:class:`FaultCampaign`)."""

from .campaign import DISTRIBUTIONS, FaultCampaign

__all__ = ["DISTRIBUTIONS", "FaultCampaign"]
