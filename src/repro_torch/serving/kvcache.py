"""KV-cache pool with request-slot management for continuous batching.

Port of ``repro/serving/kvcache.py`` without the prefix store (ROADMAP
Queue 1 item 8) and speculative decoding's rollback (item 10). The cache
tree is ``models.make_caches``' (per-pattern trees stacked over periods,
slots on axis 1 of every leaf); the pool adds a fixed batch of slots,
per-slot request ids and lengths, and reset-on-assign, so a finished
request's slot is reusable at once without reallocating device buffers.

The helpers are leaf-generic over the cache dict, as in JAX, so int8 K/V
with their scale planes and the hybrid's ``{h, conv}`` states go through
them unchanged. Where JAX returns a new tree, a helper here writes the
pool's tensors in place (their storage never changes, which a captured
program relies on) and returns the same dict; a view is always a copy,
as JAX's values are. Slot indices reach the helpers as int64 device
tensors, so the engine can run them inside a captured program from an
index buffer it fills before each replay.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.models import make_caches


def _leaves(caches):
    for blk in caches.values():
        yield from blk.items()


def _map(fn, *trees):
    return {b: {k: fn(*(t[b][k] for t in trees)) for k in trees[0][b]}
            for b in trees[0]}


def _scatter_template(caches, template, idx):
    """Write the single-slot template into slots ``idx`` (int64 (n,)) of
    every leaf: the one definition of what 'reset' means."""
    n = idx.shape[0]
    for b, blk in caches.items():
        for k, x in blk.items():
            t = template[b][k]
            x.index_copy_(1, idx, t[:, :1].expand(
                t.shape[0], n, *t.shape[2:]).contiguous())
    return caches


def _reset_slots(caches, template, idx):
    """Reset slots ``idx`` in one scatter per leaf, in place."""
    return _scatter_template(caches, template, idx)


def _reset_and_view(caches, template, idx):
    """Reset-on-assign + batch view (a gather): (caches, view)."""
    caches = _scatter_template(caches, template, idx)
    return caches, _take_slots(caches, idx)


def _reset_and_view_run(caches, template, *, lo, n):
    """Contiguous-slot path: reset the slots lo..lo+n-1 and view them (a
    copy of the slice, as JAX's slice is a value)."""
    for b, blk in caches.items():
        for k, x in blk.items():
            x[:, lo:lo + n] = template[b][k][:, :1]
    return caches, _map(lambda x: x[:, lo:lo + n].clone(), caches)


def _write_slots(caches, batch, idx):
    """Write the batch view's rows into slots ``idx``, in place."""
    for b, blk in caches.items():
        for k, x in blk.items():
            x.index_copy_(1, idx, batch[b][k])
    return caches


def _take_slots(caches, idx):
    """Batch-view gather: slot ``idx[j]`` of the pool is row j of the
    view (a copy)."""
    return _map(lambda x: x.index_select(1, idx), caches)


def _scatter_prefix(caches, batch, idx, rows=None):
    """Scatter the first ``len(idx)`` rows of a (possibly wider) batch
    view back into pool slots ``idx``: the compacted decode segment's
    write-back. Padding rows beyond the prefix are never written, so
    pool slots outside ``idx`` stay bitwise untouched. ``rows`` (int64,
    as long as ``idx``) names the view row each entry of ``idx`` takes
    instead: a captured segment writes at a fixed width, with its
    padding entries naming the first slot and taking the first row, so
    a repeated slot receives one value however often it is written."""
    n = idx.shape[0]
    for b, blk in caches.items():
        for k, x in blk.items():
            src = batch[b][k]
            src = src[:, :n] if rows is None else src.index_select(1, rows)
            x.index_copy_(1, idx, src)
    return caches


class CachePool:
    def __init__(self, cfg, n_slots: int, max_len: int, *,
                 dtype=torch.bfloat16, kv_quant=None, device=None):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.kv_quant = kv_quant
        self.device = resolve_device(device)
        # kv_quant="int8": slots hold int8 K/V plus per-(position, head)
        # scale planes, extra leaves every helper carries
        self.caches = make_caches(cfg, n_slots, max_len, dtype=dtype,
                                  kv_quant=kv_quant, device=self.device)
        # single-slot template keeping each leaf's "empty" value (the
        # attention cache's pos = -1 sentinel)
        self._template = make_caches(cfg, 1, max_len, dtype=dtype,
                                     kv_quant=kv_quant, device=self.device)
        self.request_of = [None] * n_slots       # slot -> request id
        self.lengths = [0] * n_slots

    def _idx(self, slots) -> torch.Tensor:
        return torch.as_tensor(list(slots), dtype=torch.int64,
                               device=self.device)

    @property
    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size()
                   for _, x in _leaves(self.caches))

    # ------------------------------------------------------- single slot
    def assign(self, request_id) -> int:
        return self.assign_many([request_id])[0]

    def release(self, slot: int) -> None:
        self.request_of[slot] = None
        self.lengths[slot] = 0

    # -------------------------------------------------------- batch slots
    def _claim(self, request_ids: Sequence) -> List[int]:
        """Book-keep one free slot per request; prefers a contiguous run
        so views can slice instead of gather."""
        ids = list(request_ids)
        free = [i for i, r in enumerate(self.request_of) if r is None]
        if len(ids) > len(free):
            raise RuntimeError(
                f"CachePool exhausted: {len(ids)} requested, "
                f"{len(free)} of {self.n_slots} slots free")
        slots = self._contiguous_run(free, len(ids)) or free[:len(ids)]
        for rid, s in zip(ids, slots):
            self.request_of[s] = rid
            self.lengths[s] = 0
        return slots

    def assign_many(self, request_ids: Sequence) -> List[int]:
        """Claim one slot per request and reset them all at once."""
        slots = self._claim(request_ids)
        _reset_slots(self.caches, self._template, self._idx(slots))
        return slots

    @staticmethod
    def _contiguous_run(free: List[int], n: int) -> Optional[List[int]]:
        run: List[int] = []
        for s in free:
            if run and s == run[-1] + 1:
                run.append(s)
            else:
                run = [s]
            if len(run) == n:
                return run
        return None

    def acquire(self, request_ids: Sequence, *, gather: bool = False):
        """assign_many + batch_view: (slots, batch caches). A contiguous
        run takes the slice path unless ``gather``."""
        slots = self._claim(request_ids)
        lo, n = slots[0], len(slots)
        if not gather and slots == list(range(lo, lo + n)):
            _, view = _reset_and_view_run(self.caches, self._template,
                                          lo=lo, n=n)
        else:
            _, view = _reset_and_view(self.caches, self._template,
                                      self._idx(slots))
        return slots, view

    def release_many(self, slots: Sequence[int]) -> None:
        for s in slots:
            self.release(s)

    def batch_view(self, slots: Sequence[int], *, gather: bool = False):
        """Batch-sized cache tree for the given slots (row k is pool slot
        ``slots[k]``): a copied slice for a contiguous run, else a
        gather."""
        slots = list(slots)
        lo, n = slots[0], len(slots)
        if not gather and slots == list(range(lo, lo + n)):
            return _map(lambda x: x[:, lo:lo + n].clone(), self.caches)
        return _take_slots(self.caches, self._idx(slots))

    # ------------------------------------------- compacted decode segments
    def compact_view(self, slots: Sequence[int], width: int):
        """Tier-width view for a compacted decode segment: rows
        0..len(slots)-1 are the given slots, the rest duplicates of
        ``slots[0]`` that ride along inactive and are dropped by
        ``scatter_back``. Returns ``(idx, view)``, ``idx`` the gather
        order, by which callers gather their per-row state too."""
        slots = list(slots)
        if not 0 < len(slots) <= width:
            raise ValueError(f"{len(slots)} slots do not fit width {width}")
        idx = slots + [slots[0]] * (width - len(slots))
        return idx, _take_slots(self.caches, self._idx(idx))

    def scatter_back(self, slots: Sequence[int], batch_caches,
                     lengths: Optional[Sequence[int]] = None) -> None:
        """Write a compacted segment's result back to the home slots:
        only the first ``len(slots)`` view rows land, so every other slot
        keeps its KV bitwise."""
        _scatter_prefix(self.caches, batch_caches, self._idx(slots))
        if lengths is not None:
            for s, n in zip(slots, lengths):
                self.lengths[s] = int(n)

    def write_back(self, slots: Sequence[int], batch_caches,
                   lengths: Optional[Sequence[int]] = None) -> None:
        """Store a batch view's (updated) caches back into the pool
        slots, with each slot's length when given."""
        _write_slots(self.caches, batch_caches, self._idx(slots))
        if lengths is not None:
            for s, n in zip(slots, lengths):
                self.lengths[s] = int(n)

    def claim(self, request_ids: Sequence) -> List[int]:
        """Book slots without the reset, for callers that overwrite the
        whole slot."""
        return self._claim(request_ids)

    @property
    def free_slots(self) -> int:
        return self.request_of.count(None)
