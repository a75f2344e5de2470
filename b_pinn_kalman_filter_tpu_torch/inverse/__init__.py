"""Inverse problems: observation operators, observation SDEs and the
conditional samplers (DPS and the projection-controlled sampler)."""
