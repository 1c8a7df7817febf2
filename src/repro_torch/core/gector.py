"""GECToR (Omelianchuk et al., 2020) in PyTorch: the paper's deployed model.

Port of ``repro/core/gector.py``: a bidirectional transformer encoder
(configs/gector_base.py) with two linear heads on top, an error-detection
head and an edit-tag head, trained with ``gector_loss`` (K1 forward and
backward on the card). Inference is iterative: predict tags, apply
edits, re-run, for up to ``max_iters`` rounds or until every tag is KEEP.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.tags import KEEP, TagVocab, apply_edits
from repro_torch.models import forward, init_params
from repro_torch.models.layers import dense_init


def init_gector(cfg, tag_vocab: TagVocab, seed: int = 0, *, device=None):
    """Encoder weights from ``seed`` plus fp32 detect/label heads, in the
    JAX package's tree (``encoder``, ``detect_head``, ``label_head``)."""
    dev = resolve_device(device)
    params = {"encoder": init_params(cfg, seed, device=dev)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    params["detect_head"] = {
        "w": dense_init(gen, (cfg.d_model, 2), cfg.d_model, torch.float32)}
    params["label_head"] = {
        "w": dense_init(gen, (cfg.d_model, tag_vocab.n_tags), cfg.d_model,
                        torch.float32)}
    return params


def gector_heads(params, hidden):
    """fp32 (tag_logits (B,S,T), detect_logits (B,S,2)) from hidden states."""
    hid = hidden.float()
    return hid @ params["label_head"]["w"], hid @ params["detect_head"]["w"]


def gector_forward(cfg, params, tokens, mask=None, *,
                   plain_attention: bool = False):
    """tokens: (B, S) -> (tag_logits (B,S,T), detect_logits (B,S,2)).
    ``mask`` is unused, as in the JAX package: pad tokens are attended to."""
    hid = forward(cfg, params["encoder"], tokens=tokens, causal=False,
                  return_hidden=True, plain_attention=plain_attention)
    return gector_heads(params, hid)


def gector_loss(cfg, params, batch, *, keep_weight: float = 0.2):
    """CE on edit tags + CE on the binary detect head (the paper's
    architecture), masked by valid tokens. KEEP is down-weighted (GECToR's
    class-imbalance handling: ~90% of tokens are correct, so an unweighted
    loss collapses to the all-KEEP predictor). batch: {"tokens", "tags",
    "mask"} (B, S) tensors. Returns (loss, {"tag_acc", "edit_acc"})."""
    tags, mask = batch["tags"].long(), batch["mask"].bool()
    tag_logits, det_logits = gector_forward(cfg, params, batch["tokens"])
    logp = torch.log_softmax(tag_logits, dim=-1)
    nll_tag = -torch.gather(logp, -1, tags[..., None])[..., 0]
    w = torch.where(tags == KEEP, keep_weight, 1.0) * mask
    det_target = (tags != KEEP).long()
    logp_d = torch.log_softmax(det_logits, dim=-1)
    nll_det = -torch.gather(logp_d, -1, det_target[..., None])[..., 0]
    denom = torch.clamp(w.sum(), min=1e-6)
    loss = torch.sum((nll_tag + 0.5 * nll_det) * w) / denom
    hit = tag_logits.argmax(-1) == tags
    acc = torch.sum(hit & mask) / torch.clamp(mask.sum(), min=1)
    edit_mask = (tags != KEEP) & mask
    edit_acc = (torch.sum(hit & edit_mask)
                / torch.clamp(edit_mask.sum(), min=1))
    return loss, {"tag_acc": acc, "edit_acc": edit_acc}


def tags_from_logits(tag_logits, det_logits, mask, *,
                     min_error_prob: float = 0.0):
    """Argmax tags, optionally gated by the detect head (GECToR's
    confidence-bias trick); KEEP outside ``mask``."""
    tags = tag_logits.argmax(-1)
    if min_error_prob > 0:
        perr = torch.softmax(det_logits, -1)[..., 1]
        tags = torch.where(perr >= min_error_prob, tags, KEEP)
    return torch.where(mask, tags, KEEP)


def tag_head(params, hidden, mask):
    """``ServingEngine`` head: per-token edit tags, KEEP on padding."""
    tag_logits, det_logits = gector_heads(params, hidden)
    return tags_from_logits(tag_logits, det_logits, mask)


def _device_of(params) -> torch.device:
    return params["label_head"]["w"].device


@torch.inference_mode()
def predict_tags(cfg, params, tokens_batch: np.ndarray, mask: np.ndarray,
                 *, min_error_prob: float = 0.0) -> np.ndarray:
    """Argmax tags (numpy (B, S)) for a host token batch, run on the
    device that holds ``params``."""
    dev = _device_of(params)
    toks = torch.as_tensor(np.asarray(tokens_batch), dtype=torch.long,
                           device=dev)
    msk = torch.as_tensor(np.asarray(mask), dtype=torch.bool, device=dev)
    tag_logits, det_logits = gector_forward(cfg, params, toks)
    tags = tags_from_logits(tag_logits, det_logits, msk,
                            min_error_prob=min_error_prob)
    return tags.cpu().numpy()


def iterative_correct(cfg, params, vocab: TagVocab,
                      sentences: Sequence[np.ndarray], *, max_iters: int = 4,
                      max_len: int = 128) -> List[np.ndarray]:
    """The GECToR inference loop: tag -> apply -> repeat while edits fire."""
    current = [np.asarray(s)[:max_len] for s in sentences]
    active = list(range(len(current)))
    for _ in range(max_iters):
        if not active:
            break
        L = max(len(current[i]) for i in active)
        L = min(max(L, 1), max_len)
        toks = np.zeros((len(active), L), np.int32)
        msk = np.zeros((len(active), L), bool)
        for row, i in enumerate(active):
            n = min(len(current[i]), L)
            toks[row, :n] = current[i][:n]
            msk[row, :n] = True
        tags = predict_tags(cfg, params, toks, msk)
        still = []
        for row, i in enumerate(active):
            n = int(msk[row].sum())
            if np.all(tags[row, :n] == KEEP):
                continue
            current[i] = np.array(
                apply_edits(vocab, toks[row, :n], tags[row, :n]),
                np.int64)[:max_len]
            still.append(i)
        active = still
    return current
