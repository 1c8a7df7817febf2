"""GECToR edit-tag vocabulary ("Tag, Not Rewrite"): a copy of
``repro/core/tags.py``.

Tags per source token: KEEP, DELETE, APPEND_w (insert w after this token),
REPLACE_w (substitute this token with w), with w drawn from the K most
frequent words. This is the paper-faithful reduction of GECToR's 5000-tag
vocabulary (g-transforms like CASE/AGREEMENT are lexical in our synthetic
setting, so APPEND/REPLACE cover them).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

KEEP = 0
DELETE = 1


class TagVocab:
    def __init__(self, n_words: int, token_offset: int = 0):
        """``token_offset``: token id of edit-word 0 (the corpus reserves
        low ids for specials, so its editable words are ids [2, 2+K))."""
        self.n_words = n_words
        self.token_offset = token_offset
        self.n_tags = 2 + 2 * n_words

    def append(self, token: int) -> int:
        w = token - self.token_offset
        assert 0 <= w < self.n_words
        return 2 + w

    def replace(self, token: int) -> int:
        w = token - self.token_offset
        assert 0 <= w < self.n_words
        return 2 + self.n_words + w

    def describe(self, tag: int) -> str:
        if tag == KEEP:
            return "KEEP"
        if tag == DELETE:
            return "DELETE"
        if tag < 2 + self.n_words:
            return f"APPEND_{tag - 2}"
        return f"REPLACE_{tag - 2 - self.n_words}"

    def is_append(self, tag) -> bool:
        return 2 <= tag < 2 + self.n_words

    def is_replace(self, tag) -> bool:
        return tag >= 2 + self.n_words

    def word_of(self, tag: int) -> int:
        """Token id of the word carried by an APPEND/REPLACE tag."""
        if self.is_append(tag):
            return tag - 2 + self.token_offset
        if self.is_replace(tag):
            return tag - 2 - self.n_words + self.token_offset
        raise ValueError(tag)


def apply_edits(vocab: TagVocab, tokens: Sequence[int],
                tags: Sequence[int]) -> List[int]:
    """Apply one round of predicted edits to a token sequence."""
    out: List[int] = []
    for tok, tag in zip(tokens, tags):
        if tag == DELETE:
            continue
        if vocab.is_replace(tag):
            out.append(vocab.word_of(tag))
            continue
        out.append(int(tok))
        if vocab.is_append(tag):
            out.append(vocab.word_of(tag))
    return out


def edit_f_beta(pred_tags: np.ndarray, gold_tags: np.ndarray,
                mask: np.ndarray, beta: float = 0.5) -> dict:
    """Tag-level F_beta over non-KEEP edits (the GEC convention: precision-
    weighted F0.5, as in the paper's 65.3% CoNLL-2014 reference)."""
    pred_e = (pred_tags != KEEP) & mask
    gold_e = (gold_tags != KEEP) & mask
    tp = int(np.sum(pred_e & gold_e & (pred_tags == gold_tags)))
    fp = int(np.sum(pred_e)) - tp
    fn = int(np.sum(gold_e & ~(pred_e & (pred_tags == gold_tags))))
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    b2 = beta * beta
    f = ((1 + b2) * prec * rec / max(b2 * prec + rec, 1e-9)
         if (prec + rec) else 0.0)
    return {"precision": prec, "recall": rec, f"f{beta}": f,
            "tp": tp, "fp": fp, "fn": fn}
