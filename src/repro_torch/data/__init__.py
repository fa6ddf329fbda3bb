"""Synthetic data (numpy) and the trained proxy model's weights."""
