"""Kernel layer of the port: resource models base, profiles, the engine's
resource half (actors are not ported yet)."""
