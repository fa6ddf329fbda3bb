"""Deterministic, resumable, rank-sharded synthetic data pipeline (a copy
of ``repro.data.pipeline``, which is numpy-only: the same seeds give the
same batches byte for byte in both packages).

Every batch is a pure function of (seed, step, rank) via counter-based
Philox keys — resume-after-restart needs no state file and skip-ahead is
O(1); data-parallel ranks slice disjoint rows of the global batch.  The
token stream is a fixed random Markov chain (order-1 + induction copies),
so small LMs show a real, monotonically improving loss (used by the train
examples and the fault-tolerance tests).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # synthetic structure
    markov_alpha: float = 0.25  # peakiness of the transition matrix
    induction_prob: float = 0.3  # fraction of sequences with copy structure


class SyntheticLM:
    """Markov-chain + induction-head synthetic corpus."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # sparse-ish row-stochastic transition matrix (each token prefers a
        # few successors) — learnable signal for tiny models
        prefs = rng.integers(0, v, size=(v, 4))
        self._prefs = prefs.astype(np.int64)

    def _batch_rng(self, step: int, rank: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, rank]))

    def batch(self, step: int, rank: int = 0, num_ranks: int = 1):
        """Returns {tokens, labels}: (local_batch, seq_len) int32."""
        cfg = self.cfg
        lb = cfg.global_batch // num_ranks
        rng = self._batch_rng(step, rank)
        toks = np.empty((lb, cfg.seq_len + 1), dtype=np.int64)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=lb)
        explore = rng.random((lb, cfg.seq_len)) < cfg.markov_alpha
        choice = rng.integers(0, 4, size=(lb, cfg.seq_len))
        randtok = rng.integers(0, cfg.vocab_size, size=(lb, cfg.seq_len))
        for t in range(cfg.seq_len):
            nxt = self._prefs[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(explore[:, t], randtok[:, t], nxt)
        # induction copies: repeat the first half in the second half
        n_ind = int(lb * cfg.induction_prob)
        if n_ind and cfg.seq_len >= 8:
            half = cfg.seq_len // 2
            toks[:n_ind, half + 1: 2 * half + 1] = toks[:n_ind, 1: half + 1]
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, :-1]}

    def iter_batches(self, start_step: int = 0, rank: int = 0,
                     num_ranks: int = 1) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step, rank, num_ranks)
            step += 1


class SyntheticVision:
    """Gaussian-blob classification task for the EfficientViT benchmarks:
    class k = a fixed random spatial template + noise. PTQ-accuracy deltas
    measured on this task reproduce the paper's Table I/II *trends*."""

    def __init__(self, n_classes: int, res: int, seed: int = 0,
                 noise: float = 0.6):
        rng = np.random.default_rng(seed)
        self.templates = rng.normal(0, 1, (n_classes, res, res, 3)).astype(
            np.float32)
        # low-pass the templates so they have spatial structure
        for _ in range(2):
            self.templates = (
                self.templates
                + np.roll(self.templates, 1, 1) + np.roll(self.templates, -1, 1)
                + np.roll(self.templates, 1, 2) + np.roll(self.templates, -1, 2)
            ) / 5.0
        self.n_classes = n_classes
        self.noise = noise

    def batch(self, step: int, batch_size: int):
        rng = np.random.default_rng(np.random.SeedSequence([7, step]))
        y = rng.integers(0, self.n_classes, size=batch_size)
        x = self.templates[y] + self.noise * rng.normal(
            0, 1, (batch_size,) + self.templates.shape[1:]).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int32)
