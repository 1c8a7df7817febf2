"""Synthetic GEC corpus with NUCLE-like statistics.

NUCLE 3.2 itself is licensed data, so the generator reproduces the paper's
reported corpus statistics instead: 50 essays / 1312 sentences / 30144
tokens (≈23 tokens per sentence) with *low error frequency* ("explained by
the greater proficiency of university students"). Clean sentences come from
a phrase-bank Markov source; corruptions are the exact inverses of the tag
operations, so gold edit tags are derivable by construction:

  drop token w        -> gold APPEND_w on the previous token
  substitute w -> w'  -> gold REPLACE_w on the corrupted token
  insert spurious w'  -> gold DELETE on the inserted token

A copy of ``repro/core/corpus.py`` with names, signatures and
records unchanged: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core.tags import KEEP, TagVocab


@dataclasses.dataclass
class CorpusConfig:
    vocab_size: int = 8192          # model token vocabulary
    edit_words: int = 512           # K most frequent words usable in edits
    n_sentences: int = 1312         # NUCLE test set size
    mean_len: int = 23              # 30144 tokens / 1312 sentences
    error_rate: float = 0.08        # low error frequency
    seed: int = 0


class GECCorpus:
    def __init__(self, cc: CorpusConfig):
        self.cc = cc
        self.vocab = TagVocab(cc.edit_words, token_offset=2)
        rng = np.random.default_rng(cc.seed)
        # frequent words (the editable set) are ids [2, 2+edit_words)
        ranks = np.arange(1, cc.vocab_size + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        self.phrases = rng.integers(2, 2 + cc.edit_words, (256, 6))
        self.rng = rng

    # ------------------------------------------------------------ sampling
    def _clean_sentence(self) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (tokens, corruptible) — corruptible marks phrase-interior
        positions (offset >= 2), where the phrase prefix identifies the
        phrase and therefore the correction. Errors on free (unigram) tokens
        would be unrecoverable from context — like a proper-noun typo with
        no reference — so the generator keeps the error model inside the
        'grammar' (the phrase bank), mirroring how real grammatical errors
        are recoverable from linguistic context."""
        cc = self.cc
        length = max(5, int(self.rng.normal(cc.mean_len, 6)))
        toks: List[np.ndarray] = []
        corr: List[np.ndarray] = []
        while sum(map(len, toks)) < length:
            if self.rng.random() < 0.8:
                ph = self.phrases[self.rng.integers(len(self.phrases))]
                toks.append(ph)
                c = np.zeros(len(ph), bool)
                c[2:] = True
                corr.append(c)
            else:
                n = self.rng.integers(2, 6)
                toks.append(self.rng.choice(cc.vocab_size, size=n,
                                            p=self.unigram))
                corr.append(np.zeros(n, bool))
        return (np.concatenate(toks)[:length].astype(np.int64),
                np.concatenate(corr)[:length])

    def _corrupt(self, clean: np.ndarray,
                 corruptible: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (src_tokens, gold_tags) aligned per source token."""
        cc, v = self.cc, self.vocab
        src: List[int] = []
        tags: List[int] = []
        i = 0
        while i < len(clean):
            tok = int(clean[i])
            r = self.rng.random()
            editable = corruptible[i] and 2 <= tok < 2 + cc.edit_words
            if r < cc.error_rate / 3 and editable and src \
                    and tags[-1] == KEEP:
                # drop this clean token -> APPEND on previous source token
                tags[-1] = v.append(tok)
                i += 1
                continue
            if r < 2 * cc.error_rate / 3 and editable:
                # substitute -> REPLACE_orig on the corrupted token
                wrong = int(self.rng.integers(2, 2 + cc.edit_words))
                src.append(wrong)
                tags.append(v.replace(tok))
                i += 1
                continue
            if r < cc.error_rate and editable:
                # insert a spurious token -> DELETE
                spur = int(self.rng.integers(2, 2 + cc.edit_words))
                src.append(spur)
                tags.append(1)  # DELETE
                # do not consume the clean token
                continue
            src.append(tok)
            tags.append(KEEP)
            i += 1
        return np.array(src, np.int64), np.array(tags, np.int64)

    # ------------------------------------------------------------ datasets
    def generate(self, n: int = None):
        """Yields (src, gold_tags, clean) triples."""
        n = n or self.cc.n_sentences
        for _ in range(n):
            clean, corruptible = self._clean_sentence()
            src, tags = self._corrupt(clean, corruptible)
            yield src, tags, clean

    def batches(self, batch_size: int, seq_len: int, n_batches: int):
        """Padded training batches: tokens (B,S), tags (B,S), mask (B,S)."""
        gen = self.generate(batch_size * n_batches)
        for _ in range(n_batches):
            toks = np.zeros((batch_size, seq_len), np.int32)
            tags = np.zeros((batch_size, seq_len), np.int32)
            mask = np.zeros((batch_size, seq_len), bool)
            for b in range(batch_size):
                src, gt, _ = next(gen)
                L = min(len(src), seq_len)
                toks[b, :L] = src[:L]
                tags[b, :L] = gt[:L]
                mask[b, :L] = True
            yield {"tokens": toks, "tags": tags, "mask": mask}

    def stats(self, n: int = None) -> dict:
        tot_tok = tot_err = n_sent = 0
        for src, tags, _ in self.generate(n):
            tot_tok += len(src)
            tot_err += int(np.sum(tags != KEEP))
            n_sent += 1
        return {"sentences": n_sent, "tokens": tot_tok,
                "tokens_per_sentence": tot_tok / n_sent,
                "error_rate": tot_err / tot_tok}
