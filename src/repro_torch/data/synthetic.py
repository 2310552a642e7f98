"""Deterministic, restart-safe synthetic LM data.

The port's own copy of ``repro/data/synthetic.py``. It is numpy, so the same
seed gives the same tokens as the JAX package's. Every batch is a pure
function of (seed, step, shard): no iterator state. The stream is a
learnable order-2 Markov chain over the vocab with a deterministic Philox
counter keyed on (seed, step, shard).
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab: int, seq_len: int, *, seed: int = 0, order: int = 2,
                 branch: int = 4):
        self.vocab = vocab
        self.seq_len = seq_len
        self.seed = seed
        self.order = order
        self.branch = branch  # successors per context
        # successor set of context c is {hash(c, j) % V}, with Zipf-ish weights
        self._weights = (1.0 / np.arange(1, branch + 1)) ** 1.2
        self._weights /= self._weights.sum()

    def _succ(self, ctx: np.ndarray, j: np.ndarray) -> np.ndarray:
        h = (ctx * 1000003 + j * 999983 + self.seed * 7919 + 12345) & 0x7FFFFFFF
        return h % self.vocab

    def batch(self, step: int, shard: int, num_shards: int, batch_size: int) -> dict:
        """{'tokens': [B, S] int32, 'labels': [B, S] int32}."""
        rng = np.random.Generator(np.random.Philox(
            key=np.uint64(self.seed), counter=[np.uint64(step), np.uint64(shard), 0, 0]))
        b, s = batch_size, self.seq_len
        toks = np.empty((b, s + 1), np.int64)
        toks[:, 0] = rng.integers(0, self.vocab, b)
        ctx = toks[:, 0].copy()
        choices = rng.choice(self.branch, size=(b, s), p=self._weights)
        noise = rng.random((b, s)) < 0.05  # 5% uniform noise
        rand_toks = rng.integers(0, self.vocab, (b, s))
        for t in range(s):
            nxt = self._succ(ctx, choices[:, t])
            nxt = np.where(noise[:, t], rand_toks[:, t], nxt)
            toks[:, t + 1] = nxt
            ctx = (ctx * 31 + nxt) & 0x7FFFFFFF
        del num_shards  # determinism contract: the shard id alone keys the stream
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def global_batch(self, step: int, global_batch: int, num_shards: int) -> dict:
        """The full global batch, shard by shard."""
        per = global_batch // num_shards
        parts = [self.batch(step, sh, num_shards, per) for sh in range(num_shards)]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
