"""KV-cache pool with request-slot management for continuous batching,
and the prefix store.

Port of ``repro/serving/kvcache.py``, speculative decoding's per-row
rollback (``_scatter_rollback``) included. The cache
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

import numpy as np
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


def _take_slots_into(view, caches, idx):
    """``_take_slots`` into an existing view tree of ``len(idx)`` rows
    (whose storage a captured program reads), in place."""
    for b, blk in view.items():
        for k, x in blk.items():
            torch.index_select(caches[b][k], 1, idx, out=x)
    return view


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


def _scatter_rollback(caches, batch, idx, boundary, rows=None):
    """``_scatter_prefix`` truncating each written row's attention cache
    to its own ``boundary`` (int32, as long as ``idx``): ``pos`` entries
    >= the boundary become the -1 empty sentinel and ``len`` is clamped
    to it; K/V payloads and scale planes land as they are. Speculative
    decoding's accept/rollback: a round writes KV for every proposed
    position, then each row keeps only its committed prefix, which
    restores the invariant the write-first verify chunk relies on (every
    slot at or past a row's frontier holds the sentinel). Slots outside
    ``idx`` stay bitwise untouched; ``rows`` as in ``_scatter_prefix``
    (a padding entry repeats the first slot, row and boundary). Only
    sound for pure global-attention caches ({k, v[, scales], pos, len}
    per block); the engine allows speculative decoding on those only."""
    n = idx.shape[0]
    for b, blk in caches.items():
        for k, x in blk.items():
            src = batch[b][k]
            src = src[:, :n] if rows is None else src.index_select(1, rows)
            if k == "pos":                       # (n_periods, n, L)
                src = torch.where(src < boundary[None, :, None], src, -1)
            elif k == "len":                     # (n_periods, n)
                src = torch.minimum(src, boundary[None, :])
            x.index_copy_(1, idx, src)
    return caches


class CachePool:
    def __init__(self, cfg, n_slots: int, max_len: int, *, long_ctx=False,
                 dtype=torch.bfloat16, kv_quant=None, device=None):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.kv_quant = kv_quant
        self.device = resolve_device(device)
        # kv_quant="int8": slots hold int8 K/V plus per-(position, head)
        # scale planes, extra leaves every helper carries
        # long_ctx: the global layers' slots capped as make_caches caps
        # them
        self.caches = make_caches(cfg, n_slots, max_len, long_ctx=long_ctx,
                                  dtype=dtype, kv_quant=kv_quant,
                                  device=self.device)
        # single-slot template keeping each leaf's "empty" value (the
        # attention cache's pos = -1 sentinel)
        self._template = make_caches(cfg, 1, max_len, long_ctx=long_ctx,
                                     dtype=dtype, kv_quant=kv_quant,
                                     device=self.device)
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

    def scatter_rollback(self, slots: Sequence[int], batch_caches,
                         boundaries: Sequence[int],
                         lengths: Optional[Sequence[int]] = None) -> None:
        """``scatter_back`` with a per-row truncate: row j of the view
        lands in slot ``slots[j]`` with every cached position >=
        ``boundaries[j]`` reset to the empty sentinel (and ``len``
        clamped), see ``_scatter_rollback``; ``lengths`` as in
        ``write_back``."""
        _scatter_rollback(self.caches, batch_caches, self._idx(slots),
                          torch.as_tensor(list(boundaries),
                                          dtype=torch.int32,
                                          device=self.device))
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


# ---------------------------------------------------------- prefix store
#
# Shared-prompt KV reuse: prompts are hashed at ``prefill_chunk``-token
# granularity into a radix trie; a joining request that shares a cached
# prefix copies the stored KV into its slot and prefills only the unseen
# suffix. Entries are refcounted while a load is in flight and evicted
# LRU-by-bytes against a capacity budget.

def _load_slots(dst, src, dst_idx, src_idx):
    """Copy slots ``src_idx`` of pool ``src`` into slots ``dst_idx`` of
    pool ``dst``, in place: one gather and one scatter per leaf."""
    for b, blk in dst.items():
        for k, x in blk.items():
            x.index_copy_(1, dst_idx, src[b][k].index_select(1, src_idx))
    return dst


def _store_prefix(dst, src, dst_idx, src_idx, n_tokens: int):
    """``_load_slots`` truncating the attention caches to their first
    ``n_tokens`` positions: ``pos`` entries >= n_tokens become the -1
    empty sentinel and ``len`` is clamped, so a stored prefix never
    exposes K/V its donor wrote past the prefix boundary (a whole-prompt
    prefill stamps valid positions on every padded bucket position).
    Only sound for pure global-attention caches ({k, v[, scales], pos,
    len} per block); the engine allows the prefix cache on those
    only."""
    for b, blk in dst.items():
        for k, x in blk.items():
            taken = src[b][k].index_select(1, src_idx)
            if k == "pos":
                taken = torch.where(taken < n_tokens, taken, -1)
            elif k == "len":
                taken = torch.clamp(taken, max=n_tokens)
            x.index_copy_(1, dst_idx, taken)
    return dst


class PrefixEntry:
    """One stored prefix: ``n_tokens`` of KV in slot ``slot`` of the
    store's pool. ``refs`` guards in-flight loads against eviction;
    ``tick`` is the LRU stamp."""
    __slots__ = ("slot", "n_tokens", "nbytes", "refs", "tick", "node")

    def __init__(self, slot, n_tokens, nbytes, node):
        self.slot = slot
        self.n_tokens = n_tokens
        self.nbytes = nbytes
        self.refs = 0
        self.tick = 0
        self.node = node


class _TrieNode:
    __slots__ = ("key", "parent", "children", "entry")

    def __init__(self, key=None, parent=None):
        self.key = key          # chunk-token bytes (edge label from parent)
        self.parent = parent
        self.children = {}      # chunk bytes -> _TrieNode
        self.entry = None       # PrefixEntry stored at this depth, if any


class PrefixTrie:
    """Host-side bookkeeping for stored prefixes: a radix trie over
    ``chunk``-token chunks (node depth d = prompt prefix of d*chunk
    tokens). Pure bookkeeping — device slots live in ``PrefixStore``.
    Owned by the scheduler worker thread; not thread-safe. A copy of
    JAX's ``PrefixTrie``."""

    def __init__(self, chunk: int, capacity_bytes: int):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if capacity_bytes < 0:
            raise ValueError("capacity_bytes must be >= 0")
        self.chunk = chunk
        self.capacity = capacity_bytes
        self.root = _TrieNode()
        self.entries: List[PrefixEntry] = []
        self.bytes = 0
        self._tick = 0

    def _keys(self, tokens, n_chunks: int):
        toks = np.asarray(tokens, np.int32)
        C = self.chunk
        for i in range(n_chunks):
            yield toks[i * C:(i + 1) * C].tobytes()

    # ------------------------------------------------------------ lookup
    def lookup(self, tokens) -> Optional[PrefixEntry]:
        """Deepest stored entry strictly shorter than the prompt (a full
        match would leave no suffix token to produce the first logits
        from). Acquires a reference — the caller must ``release`` it once
        the KV copy has landed."""
        cap = max(0, (len(tokens) - 1) // self.chunk)
        node, best = self.root, None
        for key in self._keys(tokens, cap):
            node = node.children.get(key)
            if node is None:
                break
            if node.entry is not None:
                best = node.entry
        if best is not None:
            best.refs += 1
            self._tick += 1
            best.tick = self._tick
        return best

    def release(self, entry: PrefixEntry) -> None:
        if entry.refs <= 0:
            raise RuntimeError("release() without a matching lookup ref")
        entry.refs -= 1

    # ------------------------------------------------------------ insert
    def divergence_chunks(self, tokens) -> int:
        """Depth (in chunks) of the deepest existing trie node along the
        prompt's chunk path — where this prompt diverges from everything
        already stored. An entry inserted here is the longest prefix this
        prompt shares with any prior one."""
        n = len(tokens) // self.chunk
        depth, node = 0, self.root
        for i, key in enumerate(self._keys(tokens, n)):
            node = node.children.get(key)
            if node is None:
                break
            depth = i + 1
        return depth

    def has_entry(self, tokens, n_chunks: int) -> bool:
        node = self.root
        for key in self._keys(tokens, n_chunks):
            node = node.children.get(key)
            if node is None:
                return False
        return node.entry is not None

    def make_room(self, nbytes: int, min_evict: int = 0):
        """Evict LRU unreferenced entries until ``nbytes`` more fits the
        budget AND at least ``min_evict`` entries are freed (the store
        passes 1 when its slot pool is full). Returns the evicted entries
        (caller releases their device slots), or None — trie unchanged —
        when the demand cannot be met (all candidates referenced, or
        nbytes alone exceeds capacity)."""
        if nbytes > self.capacity:
            return None
        victims, freed = [], 0
        cands = sorted((e for e in self.entries if e.refs == 0),
                       key=lambda e: e.tick)
        i = 0
        while (self.bytes - freed + nbytes > self.capacity
               or len(victims) < min_evict):
            if i >= len(cands):
                return None
            victims.append(cands[i])
            freed += cands[i].nbytes
            i += 1
        for e in victims:
            self._remove(e)
        return victims

    def attach(self, tokens, n_chunks: int, nbytes: int,
               slot: int) -> PrefixEntry:
        """Create the entry for the first ``n_chunks`` chunks of
        ``tokens`` (path nodes are created as needed). The caller has
        already made room and copied the KV into ``slot``."""
        node = self.root
        for key in self._keys(tokens, n_chunks):
            child = node.children.get(key)
            if child is None:
                child = node.children[key] = _TrieNode(key, node)
            node = child
        if node.entry is not None:
            raise RuntimeError(f"entry already stored at depth {n_chunks}")
        entry = PrefixEntry(slot, n_chunks * self.chunk, nbytes, node)
        node.entry = entry
        self.entries.append(entry)
        self.bytes += nbytes
        self._tick += 1
        entry.tick = self._tick
        return entry

    def _remove(self, entry: PrefixEntry) -> None:
        node = entry.node
        node.entry = None
        self.entries.remove(entry)
        self.bytes -= entry.nbytes
        # prune now-empty path nodes so stale chunks don't count as
        # divergence points for future inserts
        while (node is not self.root and node.entry is None
               and not node.children):
            parent = node.parent
            del parent.children[node.key]
            node = parent


class PrefixStore:
    """Device half of the prefix cache for one pad bucket: a ``CachePool``
    holding stored prefixes plus the trie that indexes them. Slots have
    the same ``max_len`` as the lane pool, so a load is a whole-slot
    copy. Owned by the scheduler worker thread. Loads and inserts run
    eagerly, as in-place index copies; the engine's hit program reads
    the store's slots itself (``engine._chunk_fn``)."""

    def __init__(self, cfg, n_slots: int, max_len: int, chunk: int, *,
                 capacity_bytes: Optional[int] = None, dtype=torch.bfloat16,
                 kv_quant=None, device=None):
        self.pool = CachePool(cfg, n_slots, max_len, dtype=dtype,
                              kv_quant=kv_quant, device=device)
        self.entry_bytes = sum(x.numel() * x.element_size()
                               for _, x in _leaves(self.pool._template))
        if capacity_bytes is None:
            capacity_bytes = n_slots * self.entry_bytes
        self.trie = PrefixTrie(chunk, capacity_bytes)
        self.chunk = chunk

    @property
    def bytes_used(self) -> int:
        return self.trie.bytes

    def lookup(self, tokens) -> Optional[PrefixEntry]:
        return self.trie.lookup(tokens)

    def release(self, entry: PrefixEntry) -> None:
        self.trie.release(entry)

    def load_many(self, entries: Sequence[PrefixEntry], dst_pool: CachePool,
                  dst_slots: Sequence[int]) -> None:
        """Copy-on-reference: every entry's stored KV into its
        destination slot (claimed, no reset needed: the copy overwrites
        the whole slot)."""
        _load_slots(dst_pool.caches, self.pool.caches,
                    dst_pool._idx(dst_slots),
                    self.pool._idx([e.slot for e in entries]))

    def insert(self, tokens, matched_tokens: int, src_pool: CachePool,
               src_slot: int):
        """Insert-on-complete. Two candidate depths per finished prompt:
        the divergence depth (the longest prefix shared with anything
        already in the trie — what the NEXT similar prompt will actually
        hit) and the full depth ``len(tokens)//chunk``. Each is stored
        only if strictly deeper than ``matched_tokens`` (what this
        request itself reused) and not already present. Returns
        (inserted, evicted) counts."""
        inserted = evicted = 0
        full = len(tokens) // self.chunk
        div = min(self.trie.divergence_chunks(tokens), full)
        depths = []
        for d in (div, full):
            if (d * self.chunk > matched_tokens and d not in depths
                    and not self.trie.has_entry(tokens, d)):
                depths.append(d)
        for d in depths:
            victims = self.trie.make_room(
                self.entry_bytes,
                min_evict=0 if self.pool.free_slots else 1)
            if victims is None:
                break                      # budget full of referenced entries
            for e in victims:
                self.pool.release(e.slot)
            evicted += len(victims)
            slot = self.pool.claim([("prefix", d)])[0]
            self.pool.caches = _store_prefix(
                self.pool.caches, src_pool.caches, self.pool._idx([slot]),
                src_pool._idx([src_slot]), d * self.chunk)
            self.pool.lengths[slot] = d * self.chunk
            self.trie.attach(tokens, d, self.entry_bytes, slot)
            inserted += 1
        return inserted, evicted
