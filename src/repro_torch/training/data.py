"""Data pipeline: deterministic synthetic token streams with document
structure, the training-side substrate.

A copy of ``repro/training/data.py`` (numpy only), so that a seed draws
the same batches in both packages. Real deployments drop in a tokenized
corpus reader with the same interface; the synthetic stream (a mixture of
Zipfian unigrams and repeated n-gram "phrases") gives non-trivial,
learnable structure so example runs show a falling loss without shipping
licensed corpora.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    n_phrases: int = 512
    phrase_len: int = 8
    phrase_prob: float = 0.5


class SyntheticLM:
    """Zipfian unigrams mixed with a bank of recurring phrases."""

    def __init__(self, dc: DataConfig):
        self.dc = dc
        rng = np.random.default_rng(dc.seed)
        v = dc.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        self.phrases = rng.integers(0, v, (dc.n_phrases, dc.phrase_len))
        self.rng = rng

    def _doc(self, length: int) -> np.ndarray:
        out = []
        while sum(map(len, out)) < length:
            if self.rng.random() < self.dc.phrase_prob:
                out.append(self.phrases[self.rng.integers(self.dc.n_phrases)])
            else:
                n = self.rng.integers(4, 16)
                out.append(self.rng.choice(self.dc.vocab_size, size=n,
                                           p=self.unigram))
        return np.concatenate(out)[:length]

    def batches(self, num: Optional[int] = None) -> Iterator[dict]:
        dc = self.dc
        i = 0
        while num is None or i < num:
            toks = np.stack([self._doc(dc.seq_len + 1)
                             for _ in range(dc.batch_size)])
            yield {"tokens": toks.astype(np.int32)}
            i += 1
