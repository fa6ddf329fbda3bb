"""Optimizers (twin of ``repro.optim``)."""
