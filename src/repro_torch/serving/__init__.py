"""Serving: the shared scheduler core, the token and vision engines,
fault injection, SLO classes and the wall-clock serving daemon."""
