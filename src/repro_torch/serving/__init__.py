"""Serving: the shared scheduler core and the batched vision engine."""
