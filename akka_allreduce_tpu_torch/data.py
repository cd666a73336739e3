"""Deterministic, resumable input pipeline (numpy only).

A copy of ``akka_allreduce_tpu/data.py``'s ``TokenCorpus``,
``load_corpus``, ``eval_batches`` and ``synthetic_corpus``: ``batch(i)``
is a pure function of (corpus, batch, seq, seed, i), so a resumed run
sees exactly the tokens the interrupted run would have; corpora are
memory-mapped; byte-level files (vocab 256) or ``*.bin`` little-endian
uint16 token files (vocab 65536).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenCorpus:
    """A memory-mapped 1-D token stream."""

    tokens: np.ndarray  # 1-D, any integer dtype
    vocab_size: int
    path: str = "<memory>"

    def __post_init__(self):
        if self.tokens.ndim != 1:
            raise ValueError(f"corpus must be 1-D, got {self.tokens.shape}")
        if len(self.tokens) < 2:
            raise ValueError("corpus too small")

    def __len__(self) -> int:
        return len(self.tokens)

    def max_token(self) -> int:
        """Largest token id present (one pass over the memmap, cached):
        lets callers size the model to the data rather than the
        container format's capacity."""
        cached = getattr(self, "_max_token", None)
        if cached is None:
            cached = int(np.max(self.tokens))
            object.__setattr__(self, "_max_token", cached)
        return cached

    def batch(self, step: int, batch: int, seq: int,
              seed: int = 0) -> np.ndarray:
        """(batch, seq) int32 windows for ``step`` — pure in (step, seed).
        Windows start at uniform offsets; the last valid start leaves a
        full ``seq`` tokens."""
        if seq > len(self.tokens):
            raise ValueError(
                f"seq {seq} does not fit corpus of {len(self.tokens)}")
        rng = np.random.default_rng((seed, step))
        # high is exclusive: len - seq is the last valid start
        starts = rng.integers(0, len(self.tokens) - seq + 1,
                              size=batch, dtype=np.int64)
        idx = starts[:, None] + np.arange(seq, dtype=np.int64)[None, :]
        return np.asarray(self.tokens[idx], dtype=np.int32)


def eval_batches(corpus: TokenCorpus, batch: int, seq: int):
    """Yield (batch, seq) int32 arrays tiling the corpus ONCE, in order
    (the held-out evaluation regime: each token seen once). Windows are
    non-overlapping and contiguous, each group a plain slice of the
    memory map; the final partial group is yielded at its smaller batch
    size."""
    n_windows = len(corpus.tokens) // seq
    for lo in range(0, n_windows, batch):
        hi = min(lo + batch, n_windows)
        yield np.asarray(corpus.tokens[lo * seq:hi * seq],
                         dtype=np.int32).reshape(hi - lo, seq)


def load_corpus(path: str) -> TokenCorpus:
    """Open a corpus file: ``*.bin`` — raw little-endian uint16 tokens,
    vocab 65536; anything else — raw bytes, vocab 256. Both are
    memory-mapped read-only."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if path.endswith(".bin"):
        tokens = np.memmap(path, dtype="<u2", mode="r")
        vocab = 65536
    else:
        tokens = np.memmap(path, dtype=np.uint8, mode="r")
        vocab = 256
    return TokenCorpus(tokens=tokens, vocab_size=vocab, path=path)


def synthetic_corpus(vocab_size: int, length: int = 1 << 16,
                     seed: int = 0) -> TokenCorpus:
    """Uniform-random corpus for demos and tests."""
    rng = np.random.default_rng(seed)
    return TokenCorpus(
        tokens=rng.integers(0, vocab_size, size=length, dtype=np.int32),
        vocab_size=vocab_size, path="<synthetic>")
