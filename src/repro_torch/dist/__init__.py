"""Distributed-training helpers (twin of ``repro.dist``): gradient
compression."""
