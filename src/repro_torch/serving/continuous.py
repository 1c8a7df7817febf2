"""Multi-lane step-driven continuous-batching scheduler.

Port of ``repro/serving/continuous.py``.

Each pad bucket gets its own **lane**: a ``CachePool``-backed slot batch
with per-slot decode state and a per-lane pending queue
(``scheduler.LaneQueue``), and the worker round-robins decode segments
(``models.decode_segment``) across non-empty lanes, so a bucket-64
request admits into free bucket-64 slots at once while the bucket-32 set
keeps decoding. Between a lane's segments (a host sync it needs anyway to
stream tokens) the worker retires rows that finished (per-row eos or
budget), retires rows whose client cancelled, and admits the best pending
requests per lane (priority order, FIFO within a level) by
prefill-into-slot. ``EngineConfig.multi_lane=False`` keeps the
single-set admission gate (one bucket serves until it drains).

**Chunked prefill** (``EngineConfig.prefill_chunk``): a join whose prompt
is longer than one chunk reserves a lane slot and a slot of the lane's
staging pool, and its prompt advances one chunk per scheduler turn
(``models.prefill_chunk``, one captured program over the lane's fills),
interleaved with decode segments; when it completes, the staging slot is
copied into the lane slot at once. The staging slot absorbs the chunks
because inactive rows re-write their frozen KV position every full-width
segment, which would corrupt a partly filled live slot. **The prefix
cache** (``prefix_cache``): a join whose prompt extends a stored prefix
(``kvcache.PrefixStore``) by at most one chunk runs that one chunk over a
copy of the stored slot; a longer one starts its fill at the prefix;
every completed prompt offers its KV at chunk boundaries to the store.

Decode segments are **occupancy-adaptive**: before each segment the
scheduler picks the smallest width tier (``scheduler.width_tiers``) that
fits the lane's live rows, gathers those rows' slots and decode state into
a tier-width view, runs the segment at that width, and scatters the live
rows back, so slots outside the compact set stay bitwise untouched.
``EngineConfig.segment_width='fixed'`` keeps the always-full-width
segment. The engine runs the gather, the segment and the scatter as one
program per (bucket, width, sampled) (``engine._segment_fn``), captured
as a CUDA graph on the card. Per-segment occupancy lands in
``engine.batch_sizes``, and per-lane counters and the ``tier_hist`` of
segment widths in ``engine.metrics()['lanes']``.

**Speculative decoding** (``EngineConfig.spec_decode``): every turn of a
lane with live rows is one draft-and-verify round in place of a segment
(``engine._spec_round_fn``, always on the compacted view at the
occupancy's tier width): the draft model proposes ``spec_k`` tokens a
row, the target scores them in one verify chunk, and the host commits
each row's leading agreements plus one target token, clamped to its
budget and cut at its eos; then both pools are rolled back to each row's
commit boundary (``engine._rollback_fn``). Every admitted row also gets
its prompt prefilled into the draft's pool (``_draft_prefill``), whatever
path admitted it. The committed streams are plain decoding's, bit for
bit: verify scores each position with a decode step's bits.
"""
from __future__ import annotations

import dataclasses
import queue
import time
from typing import Dict, List, Optional

import numpy as np

import torch

from repro_torch.serving import kvcache
from repro_torch.serving.api import (FINISH_CANCELLED, FINISH_EOS,
                                     FINISH_LENGTH, GenerationResult,
                                     RequestTiming)
from repro_torch.serving.kvcache import CachePool
from repro_torch.serving.scheduler import LaneQueue, pick_tier


@dataclasses.dataclass(eq=False)     # identity semantics: list.remove /
class _Row:                          # membership must not compare the
    req: "object"                    # engine._Request (np token arrays)
    slot: int
    toks: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(eq=False)
class _Fill:
    """A join whose prompt is prefilling chunk by chunk: ``slot`` is its
    reserved lane slot (written once, when the prompt completes), ``stg``
    its staging-pool slot (written every chunk), ``filled`` the prompt
    tokens staged so far. Sampling/stop values are frozen at claim time
    so chunk batches regroup freely across scheduler turns."""
    req: "object"
    slot: int
    stg: int
    filled: int = 0
    matched: int = 0       # prompt tokens reused from the prefix store
    temp: float = 0.0
    topk: int = 0
    seed: int = 0
    eos: int = -1
    budget: int = 0


class _Lane:
    """One pad bucket's in-flight set: pool slots + per-slot decode state.

    State arrays are indexed by pool slot; free and prefilling slots ride
    along inactive (``active=False``) in every full-width segment,
    re-writing their frozen KV position, and reset-on-assign wipes a slot
    when it is re-acquired.
    """

    def __init__(self, eng, bucket: int):
        self._eng = eng                  # guarded-by: init
        self.bucket = bucket             # guarded-by: init
        self.staging: Optional[CachePool] = None   # guarded-by: worker
        n = eng.ec.max_batch
        self.last_tok = np.zeros(n, np.int32)   # guarded-by: worker — last sampled
        self.pos = np.zeros(n, np.int32)        # guarded-by: worker — abs position
        self.active = np.zeros(n, bool)         # guarded-by: worker
        self.budget = np.zeros(n, np.int32)     # guarded-by: worker — tokens left
        self.eos = np.full(n, -1, np.int32)     # guarded-by: worker
        self.temp = np.zeros(n, np.float32)     # guarded-by: worker
        self.topk = np.zeros(n, np.int32)       # guarded-by: worker
        self.seed = np.zeros(n, np.int32)       # guarded-by: worker
        self.rows: Dict[int, _Row] = {}         # guarded-by: worker — slot -> _Row
        self.fills: List[_Fill] = []            # guarded-by: worker — chunked prefills

    @property
    def busy(self) -> bool:  # holds: worker
        return bool(self.rows or self.fills)

    @property
    def pool(self) -> CachePool:  # holds: worker
        """The bucket's slot pool, through the engine's pool cache, so
        buckets the workload never touches allocate nothing."""
        return self._eng._get_pool(self.bucket)

    def get_staging(self, eng) -> CachePool:  # holds: worker
        """The lane's staging pool for chunked prefills: ``max_batch``
        slots as long as the lane's (a completed fill is a whole-slot
        copy), int8 KV when the engine's is; created on first use or by
        ``warmup``."""
        if self.staging is None:
            self.staging = CachePool(
                eng.cfg, eng.ec.max_batch, eng._slot_len(self.bucket),
                dtype=torch.float32, kv_quant=eng.ec.kv_quant,
                device=eng.device)
        return self.staging


class ContinuousScheduler:
    def __init__(self, engine):
        self.eng = engine                # guarded-by: init
        # every lane exists up front (device pools stay lazy): the
        # worker's idle/busy checks iterate this dict
        self.lanes: Dict[int, _Lane] = {  # guarded-by: worker
            b: _Lane(engine, b) for b in engine.ec.pad_buckets}
        self.pending = LaneQueue()              # guarded-by: worker — pending queues
        self._rr = 0                            # guarded-by: worker — round-robin

    def _lane(self, bucket: int) -> _Lane:  # holds: worker
        return self.lanes[bucket]

    # ------------------------------------------------------------ worker
    def run(self):  # holds: worker
        eng = self.eng
        try:
            while not eng._stop.is_set():
                try:
                    idle = not self.pending and not any(
                        l.busy for l in self.lanes.values())
                    self._drain(block=idle)
                    self._admit()
                    lane = self._next_lane()
                    if lane is not None:
                        self._step(lane)
                except Exception as e:  # surfaced to the affected clients
                    self._fail_inflight(e)
        finally:
            self._shutdown()

    def _drain(self, block: bool) -> None:  # holds: worker
        """Move newly submitted requests into their lane's pending queue;
        when idle, block briefly so the loop doesn't spin."""
        eng = self.eng
        try:
            while True:
                req = (eng._q.get(timeout=0.05) if block
                       else eng._q.get_nowait())
                block = False
                self.pending.push(req, req.priority,
                                  lane=eng._bucket(len(req.tokens)))
        except queue.Empty:
            pass

    def _next_lane(self) -> Optional[_Lane]:  # holds: worker
        """Round-robin over lanes with in-flight work, so no bucket's
        decode starves while another bucket is busy."""
        busy = [l for l in self.lanes.values() if l.busy]
        if not busy:
            return None
        self._rr = (self._rr + 1) % len(busy)
        return busy[self._rr]

    def _step(self, lane: _Lane) -> None:  # holds: worker
        """One scheduler turn for a lane: advance its chunked prefills by
        one chunk, then run one decode segment for its in-flight rows —
        the interleave that bounds how long a join can stall decode."""
        if lane.fills:
            self._fill_chunk(lane)
        if lane.rows:
            if self.eng.ec.spec_decode:
                self._spec_round(lane)
            else:
                self._segment(lane)

    # --------------------------------------------------------- admission
    def _admit(self) -> None:  # holds: worker
        eng = self.eng
        if not self.pending:
            return
        drop = lambda r: r.future.done()    # noqa: E731 — cancelled in queue
        if eng.ec.multi_lane:
            buckets = self.pending.lanes()
        else:
            # single-set gate: one bucket serves until it fully drains;
            # the next is picked by the globally best pending request
            busy = [b for b, l in self.lanes.items() if l.busy]
            if busy:
                buckets = [b for b in busy if self.pending.lane_len(b)]
            else:
                best = self.pending.best_lane(drop)
                buckets = [] if best is None else [best]
        any_busy = any(l.busy for l in self.lanes.values())
        for bucket in buckets:
            lane = self._lane(bucket)
            claimed = []
            while lane.pool.free_slots > len(claimed):
                r = self.pending.pop(bucket, drop=drop)
                if r is None:
                    break
                claimed.append(r)
            claimed = [r for r in claimed
                       if r.future.set_running_or_notify_cancel()]
            if not claimed:
                continue
            if any_busy:
                with eng._samples_lock:
                    eng._stats["joins_mid_flight"] += len(claimed)
                    eng._lane_stat(bucket)["joins"] += len(claimed)
            any_busy = True
            chunk = eng.ec.prefill_chunk
            store = eng._prefix_store(bucket)
            whole, hits, fills, fill_entries = [], [], [], []
            for r in claimed:
                entry = store.lookup(r.tokens) if store is not None else None
                if entry is not None:
                    with eng._samples_lock:
                        stat = eng._lane_stat(bucket)
                        stat["prefix_hits"] += 1
                        stat["prefix_hit_tokens"] += entry.n_tokens
                    if len(r.tokens) - entry.n_tokens <= chunk:
                        # the unseen suffix fits one chunk: one chunk call
                        # over a copy of the stored slot at admission
                        hits.append((r, entry))
                    else:
                        # partial match: the fill starts ``matched``
                        # tokens in instead of at zero
                        fills.append(r)
                        fill_entries.append(entry)
                    continue
                if store is not None:
                    with eng._samples_lock:
                        eng._lane_stat(bucket)["prefix_misses"] += 1
                if chunk is None or len(r.tokens) <= chunk:
                    whole.append(r)
                else:
                    fills.append(r)
                    fill_entries.append(None)
            if whole:
                self._prefill(whole, lane)
            if hits:
                self._prefill_hits(hits, lane)
            if fills:
                self._begin_fills(fills, lane, entries=fill_entries)

    # ----------------------------------------------- whole-prompt prefill
    def _prefill(self, claimed, lane: _Lane) -> None:  # holds: worker
        """Prefill-into-slot: fill the new rows' KV straight into pool
        slots and emit their first token; they join the in-flight set for
        the next segment. A failure must not strand the claimed requests
        (their futures are RUNNING and outside lane.rows): fail them here
        and release any slots that never became rows, then keep
        serving."""
        try:
            self._prefill_inner(claimed, lane)
        except Exception as e:
            self._fail_joins(lane, claimed, e)

    def _fail_joins(self, lane: _Lane, reqs, exc) -> None:  # holds: worker
        """A join failed: release the slots of ``reqs`` that never became
        rows and fail their futures."""
        live = {id(row.req) for row in lane.rows.values()}
        ids = {id(r) for r in reqs}
        for slot, rid in enumerate(lane.pool.request_of):
            if rid in ids and slot not in lane.rows:
                lane.pool.release(slot)
        for r in reqs:
            if id(r) not in live and not r.future.done():
                r.future.set_exception(exc)

    def _prefill_inner(self, claimed, lane: _Lane) -> None:  # holds: worker
        eng = self.eng
        t0 = time.perf_counter()
        B, bucket, pool = len(claimed), lane.bucket, lane.pool
        # the slots are reset and gathered inside the prefill program
        slots = pool.claim([id(r) for r in claimed])
        toks = np.zeros((B, bucket), np.int64)
        lens = np.zeros(B, np.int32)
        for i, r in enumerate(claimed):
            r.t_start = t0
            toks[i, :len(r.tokens)] = r.tokens
            lens[i] = len(r.tokens)
        temp, topk, seed, eos, budget, any_sample = \
            eng._sampling_arrays(claimed)
        sargs = (temp, topk, seed) if any_sample else (None, None, None)
        first = eng._prefill_call(bucket, toks, lens, slots, *sargs)
        if eng.ec.spec_decode:
            self._draft_prefill(lane, claimed, slots)
        for s, n in zip(slots, lens):
            pool.lengths[s] = int(n) + 1
        with eng._samples_lock:
            eng._stats["prefill_batches"] += 1
        t1 = time.perf_counter()
        for i, (r, s) in enumerate(zip(claimed, slots)):
            # a whole-prompt join can seed the store too (a prompt of
            # exactly one chunk is a storable boundary)
            self._insert_prefix(lane, r, 0, s)
            r.t_prefill_done = t1
            self._start_row(lane, r, s, int(first[i]), int(lens[i]),
                            budget=int(budget[i]), eos=int(eos[i]),
                            temp=float(temp[i]), topk=int(topk[i]),
                            seed=int(seed[i]), now=t1)

    def _start_row(self, lane: _Lane, r, slot: int, tok: int, plen: int, *,  # holds: worker
                   budget: int, eos: int, temp: float, topk: int, seed: int,
                   now: float) -> None:
        """Install a freshly prefilled request as an in-flight decode row
        (its first token already selected at the prompt's last position)."""
        row = _Row(req=r, slot=slot, toks=[tok])
        lane.rows[slot] = row
        r.handle._push([tok])
        lane.last_tok[slot] = tok
        lane.pos[slot] = plen           # first token sits at len(prompt)
        lane.budget[slot] = budget - 1  # the first token spent one
        lane.eos[slot], lane.temp[slot] = eos, temp
        lane.topk[slot], lane.seed[slot] = topk, seed
        hit = eos >= 0 and tok == eos
        if hit or lane.budget[slot] <= 0:
            self._finish(lane, row, FINISH_EOS if hit else FINISH_LENGTH,
                         now)
        else:
            lane.active[slot] = True

    # ----------------------------------------------- prefix-cache fast path
    def _prefill_hits(self, claimed, lane: _Lane) -> None:  # holds: worker
        """Admit requests whose prompt extends a stored prefix by at most
        one chunk: one chunk program reads each stored slot, runs the
        unseen suffix at the prefix's absolute offset and writes the
        result into a lane slot, so the whole prompt never runs.
        ``claimed`` is a list of (request, PrefixEntry) pairs; the entry
        refs are released once the program has been issued. Failure
        handling mirrors _prefill."""
        try:
            self._prefill_hits_inner(claimed, lane)
        except Exception as e:
            self._fail_joins(lane, [r for r, _ in claimed], e)

    def _prefill_hits_inner(self, claimed, lane: _Lane) -> None:  # holds: worker
        eng = self.eng
        store = eng._prefix_store(lane.bucket)
        C = eng.ec.prefill_chunk
        t0 = time.perf_counter()
        B, pool = len(claimed), lane.pool
        reqs = [r for r, _ in claimed]
        # claim without reset: the program overwrites the whole slot
        slots = pool.claim([id(r) for r in reqs])
        toks = np.zeros((B, C), np.int64)
        start = np.zeros(B, np.int32)
        nvalid = np.zeros(B, np.int32)
        for i, (r, e) in enumerate(claimed):
            r.t_start = t0
            suffix = np.asarray(r.tokens)[e.n_tokens:]
            toks[i, :len(suffix)] = suffix
            start[i], nvalid[i] = e.n_tokens, len(suffix)
        temp, topk, seed, eos, budget, any_sample = \
            eng._sampling_arrays(reqs)
        sargs = (temp, topk, seed) if any_sample else (None, None, None)
        try:
            first = eng._chunk_call("cont_hit", lane.bucket, store.pool,
                                    pool, toks, start, nvalid,
                                    [e.slot for _, e in claimed], slots,
                                    *sargs)
        finally:
            for _, e in claimed:
                store.release(e)
        if eng.ec.spec_decode:
            self._draft_prefill(lane, reqs, slots)
        for s, r in zip(slots, reqs):
            pool.lengths[s] = len(r.tokens) + 1
        with eng._samples_lock:
            eng._stats["prefill_batches"] += 1
        t1 = time.perf_counter()
        for i, ((r, e), s) in enumerate(zip(claimed, slots)):
            # a prompt extending >= 1 chunk past its matched prefix is a
            # new, deeper boundary worth storing
            self._insert_prefix(lane, r, e.n_tokens, s)
            r.t_prefill_done = t1
            self._start_row(lane, r, s, int(first[i]), len(r.tokens),
                            budget=int(budget[i]), eos=int(eos[i]),
                            temp=float(temp[i]), topk=int(topk[i]),
                            seed=int(seed[i]), now=t1)

    def _insert_prefix(self, lane: _Lane, r, matched: int,  # holds: worker
                       slot: int) -> None:
        """Insert-on-complete: offer the finished prompt's KV (sitting in
        its lane slot) to the bucket's prefix store. ``matched`` is what
        this request itself reused — depths at or below it are already
        stored. No-op when the prefix cache is off for the bucket."""
        store = self.eng._prefix_store(lane.bucket)
        if store is None:
            return
        ins, evc = store.insert(r.tokens, matched, lane.pool, slot)
        if ins or evc:
            with self.eng._samples_lock:
                stat = self.eng._lane_stat(lane.bucket)
                stat["prefix_inserts"] += ins
                stat["prefix_evictions"] += evc
                stat["prefix_bytes"] = store.bytes_used

    # --------------------------------------------------- chunked prefill
    def _begin_fills(self, claimed, lane: _Lane, entries=None) -> None:  # holds: worker
        """Reserve a lane slot and a staging slot per long-prompt join;
        the prompt then advances one chunk per scheduler turn in
        _fill_chunk. ``entries[i]`` (when given) is request i's matched
        ``PrefixEntry``: its stored KV is copied into the staging slot and
        the fill starts ``matched`` tokens in. Entry refs are released
        here whatever happens. Failure handling mirrors _prefill: the
        claimed futures are RUNNING, so fail them here and release both
        slots."""
        eng = self.eng
        store = eng._prefix_store(lane.bucket)
        if entries is None:
            entries = [None] * len(claimed)
        try:
            staging = lane.get_staging(eng)
            temp, topk, seed, eos, budget, _ = eng._sampling_arrays(claimed)
            slots = lane.pool.assign_many([id(r) for r in claimed])
            stg = staging.assign_many([id(r) for r in claimed])
            hit = [(ent, stg[i]) for i, ent in enumerate(entries)
                   if ent is not None]
            if hit:
                store.load_many([ent for ent, _ in hit], staging,
                                [s for _, s in hit])
            t0 = time.perf_counter()
            for i, r in enumerate(claimed):
                r.t_start = t0
                matched = entries[i].n_tokens if entries[i] else 0
                lane.fills.append(_Fill(
                    req=r, slot=slots[i], stg=stg[i],
                    filled=matched, matched=matched,
                    temp=float(temp[i]), topk=int(topk[i]),
                    seed=int(seed[i]), eos=int(eos[i]),
                    budget=int(budget[i])))
        except Exception as e:
            ids = {id(r) for r in claimed}
            self._release_fills(lane, [f for f in lane.fills
                                       if id(f.req) in ids])
            for pool in (lane.pool, lane.staging):
                if pool is None:
                    continue
                for slot, rid in enumerate(pool.request_of):
                    if rid in ids:
                        pool.release(slot)
            for r in claimed:
                if not r.future.done():
                    r.future.set_exception(e)
        finally:
            for ent in entries:
                if ent is not None:
                    store.release(ent)

    def _release_fills(self, lane: _Lane, fills) -> None:  # holds: worker
        for f in fills:
            if f in lane.fills:
                lane.fills.remove(f)
            lane.pool.release(f.slot)
            if lane.staging is not None:
                lane.staging.release(f.stg)

    def _fill_chunk(self, lane: _Lane) -> None:  # holds: worker
        """Advance every in-flight fill of this lane by one prompt chunk
        (one chunk program over the fill batch). Fills whose prompt
        completes are copied staging -> lane slot and join the decode set
        with their first token."""
        now = time.perf_counter()
        for f in list(lane.fills):       # cancelled mid-prefill: retire
            h = f.req.handle
            if h is not None and h.cancel_requested:
                self._release_fills(lane, [f])
                f.req.t_prefill_done = now
                self._resolve(f.req, [], FINISH_CANCELLED, now)
        if not lane.fills:
            return
        try:
            self._fill_chunk_inner(lane)
        except Exception as e:
            fills = list(lane.fills)
            self._release_fills(lane, fills)
            for f in fills:
                if not f.req.future.done():
                    f.req.future.set_exception(e)

    def _fill_chunk_inner(self, lane: _Lane) -> None:  # holds: worker
        eng = self.eng
        C = eng.ec.prefill_chunk
        fills = list(lane.fills)
        B = len(fills)
        staging = lane.get_staging(eng)
        toks = np.zeros((B, C), np.int64)
        start = np.zeros(B, np.int32)
        nvalid = np.zeros(B, np.int32)
        temp = np.zeros(B, np.float32)
        topk = np.zeros(B, np.int32)
        seed = np.zeros(B, np.int32)
        for i, f in enumerate(fills):
            chunk = np.asarray(f.req.tokens)[f.filled:f.filled + C]
            toks[i, :len(chunk)] = chunk
            start[i], nvalid[i] = f.filled, len(chunk)
            temp[i], topk[i], seed[i] = f.temp, f.topk, f.seed
        sargs = ((temp, topk, seed) if (temp > 0).any()
                 else (None, None, None))
        stg_slots = [f.stg for f in fills]
        first = eng._chunk_call("cont_chunk", lane.bucket, staging, staging,
                                toks, start, nvalid, stg_slots, stg_slots,
                                *sargs)
        for i, f in enumerate(fills):
            f.filled += int(nvalid[i])
            staging.lengths[f.stg] = f.filled
        with eng._samples_lock:
            eng._stats["prefill_chunks"] += B
            eng._lane_stat(lane.bucket)["prefill_chunks"] += B
        done = [(i, f) for i, f in enumerate(fills)
                if f.filled >= len(f.req.tokens)]
        if not done:
            return
        t1 = time.perf_counter()
        # one copy installs every completed prompt into its lane slot
        pool = lane.pool
        dst = pool._idx([f.slot for _, f in done])
        src = staging._idx([f.stg for _, f in done])
        with torch.inference_mode():
            if eng.ec.spec_decode:
                # cut at the prompt: the last chunk's padded tail holds
                # valid positions past it (see engine._prefill_fn)
                kvcache._scatter_rollback(
                    pool.caches, kvcache._take_slots(staging.caches, src),
                    dst, torch.as_tensor([f.filled for _, f in done],
                                         dtype=torch.int32,
                                         device=pool.device))
                self._draft_prefill(lane, [f.req for _, f in done],
                                    [f.slot for _, f in done])
            else:
                kvcache._load_slots(pool.caches, staging.caches, dst, src)
        for i, f in done:
            pool.lengths[f.slot] = f.filled + 1
            lane.fills.remove(f)
            staging.release(f.stg)
            self._insert_prefix(lane, f.req, f.matched, f.slot)
            f.req.t_prefill_done = t1
            self._start_row(lane, f.req, f.slot, int(first[i]), f.filled,
                            budget=f.budget, eos=f.eos, temp=f.temp,
                            topk=f.topk, seed=f.seed, now=t1)

    # ------------------------------------------------- speculative rounds
    def _draft_prefill(self, lane: _Lane, reqs, slots) -> None:  # holds: worker
        """Whole-prompt prefill of the draft model's KV for newly admitted
        rows, into the draft pool at the rows' lane slot indices, whichever
        path (whole, prefix hit, chunked fill) admitted them on the target
        side: prompts fit the bucket, and the draft has no prefix store.
        The draft pool keeps no slot bookkeeping: a slot's liveness is
        the lane pool's."""
        B, bucket = len(reqs), lane.bucket
        toks = np.zeros((B, bucket), np.int64)
        lens = np.zeros(B, np.int32)
        for i, r in enumerate(reqs):
            toks[i, :len(r.tokens)] = r.tokens
            lens[i] = len(r.tokens)
        self.eng._draft_prefill_call(bucket, toks, lens, list(slots))

    def _spec_round(self, lane: _Lane) -> None:  # holds: worker
        """One draft-and-verify round for a lane's live rows, in place of
        ``_segment``: always the compacted path at the occupancy's tier
        width ('fixed' pins the ladder to ``max_batch``), so slots outside
        the live set stay bitwise untouched. Per-row commit counts
        (1..spec_k + 1) move the rows' positions apart, and the rollback
        restores, in both pools, the empty sentinel at and past each row's
        frontier before the next round reads it. The rows are scattered
        back before any retires: a released slot must not be written
        afterwards."""
        eng = self.eng
        k = eng.ec.spec_k
        slots = sorted(lane.rows)         # deterministic gather order
        occ = len(slots)
        width = pick_tier(occ, eng._tiers)
        idx = slots + [slots[0]] * (width - occ)
        drafts, verify = eng._spec_round_call(
            lane.bucket, width, lane.last_tok[idx][:, None],
            lane.pos[idx][:, None], idx, *self._sampling(lane, idx, slots))
        drafts, verify = drafts[:occ], verify[:occ]
        now = time.perf_counter()
        bounds = np.zeros(occ, np.int32)
        retire, accepted = [], 0
        for j, s in enumerate(slots):
            row = lane.rows[s]
            a = 0                  # leading draft tokens the target agreed on
            while a < k and drafts[j, a] == verify[j, a]:
                a += 1
            accepted += a
            # the agreements plus one target token (the correction at the
            # first disagreement, or the bonus after a full accept),
            # clamped to the budget and cut at eos
            committed = verify[j, :min(a + 1, int(lane.budget[s]))].tolist()
            eos, eos_hit = int(lane.eos[s]), False
            if eos >= 0 and eos in committed:
                committed = committed[:committed.index(eos) + 1]
                eos_hit = True
            c = len(committed)
            bounds[j] = int(lane.pos[s]) + c
            lane.last_tok[s] = committed[-1]
            lane.pos[s] = bounds[j]
            lane.budget[s] -= c
            row.toks.extend(committed)
            row.req.handle._push(committed)
            lane.pool.lengths[s] = int(bounds[j]) + 1
            if eos_hit:
                retire.append((row, FINISH_EOS))
            elif lane.budget[s] <= 0:
                retire.append((row, FINISH_LENGTH))
            elif row.req.handle.cancel_requested:
                retire.append((row, FINISH_CANCELLED))
        with eng._samples_lock:
            stat = eng._lane_stat(lane.bucket)
            eng.batch_sizes.append(occ)
            eng._stats["decode_segments"] += 1
            stat["decode_segments"] += 1
            stat["occupancy_sum"] += occ
            stat["tier_hist"][width] += 1
            stat["spec_rounds"] += 1
            stat["spec_proposed"] += occ * k
            stat["spec_accepted"] += accepted
        eng._rollback_call(lane.bucket, width, slots, bounds.tolist())
        for row, reason in retire:
            self._finish(lane, row, reason, now)

    # ------------------------------------------------------ decode steps
    def _segment(self, lane: _Lane) -> None:  # holds: worker
        """One decode segment for a lane, at the smallest width tier that
        fits its live occupancy ('fixed' degenerates the ladder to
        ``max_batch`` and always takes the full-width path). Both paths
        return per-row results aligned with ``slots``."""
        eng = self.eng
        occ = len(lane.rows)
        width = pick_tier(occ, eng._tiers)
        if width >= eng.ec.max_batch:
            width = eng.ec.max_batch
            slots, toks, emits, st_active, st_eos = self._segment_full(lane)
        else:
            slots, toks, emits, st_active, st_eos = \
                self._segment_compact(lane, width)
        with eng._samples_lock:
            stat = eng._lane_stat(lane.bucket)
            if width < eng.ec.max_batch:
                stat["compact_segments"] += 1
            eng.batch_sizes.append(occ)          # per-segment occupancy
            eng._stats["decode_segments"] += 1
            stat["decode_segments"] += 1
            stat["occupancy_sum"] += occ
            stat["tier_hist"][width] += 1        # key pre-created per tier
        now = time.perf_counter()
        pool = lane.pool
        for j, s in enumerate(slots):
            row = lane.rows[s]
            new = toks[j][emits[j]].tolist()
            row.toks.extend(new)
            row.req.handle._push(new)
            pool.lengths[s] = int(lane.pos[s]) + 1
            if not st_active[j]:
                self._finish(lane, row,
                             FINISH_EOS if st_eos[j] else FINISH_LENGTH, now)
            elif row.req.handle.cancel_requested:
                self._finish(lane, row, FINISH_CANCELLED, now)

    def _sampling(self, lane: _Lane, rows, live) -> tuple:  # holds: worker
        """Sampling arrays for a segment's view rows, or Nones when every
        live row is greedy."""
        if not any(lane.temp[s] > 0 for s in live):
            return None, None, None
        return lane.temp[rows], lane.topk[rows], lane.seed[rows]

    def _segment_full(self, lane: _Lane):  # holds: worker
        """Full-width segment over every pool slot (live rows plus inert
        free slots): the fixed-width path, and the adaptive path's top
        tier. The pool is updated in place."""
        eng = self.eng
        allrows = np.arange(eng.ec.max_batch)
        toks, emits, state = eng._segment_call(
            lane.bucket, eng.ec.max_batch,
            (lane.last_tok[:, None], lane.pos[:, None], lane.active,
             lane.budget, lane.eos),
            *self._sampling(lane, allrows, lane.rows))
        st_active, st_eos = state["active"], state["eos_hit"]
        lane.last_tok = state["tok"].copy()
        lane.pos = state["pos"].copy()
        lane.budget = state["budget"].copy()
        lane.active = st_active.copy()
        slots = list(lane.rows)
        return (slots, toks[slots], emits[slots], st_active[slots],
                st_eos[slots])

    def _segment_compact(self, lane: _Lane, width: int):  # holds: worker
        """Compacted segment: gather the live rows (and their decode
        state) into a ``width``-row view, decode at that width, scatter
        the live rows back to the home slots. View rows past the
        occupancy are duplicates of ``slots[0]`` that ride along inactive
        and are never written back as themselves, so pool slots outside
        ``slots`` keep their KV and state bitwise."""
        eng = self.eng
        slots = sorted(lane.rows)         # deterministic gather order
        occ = len(slots)
        # idx is the view's gather order (slots + padding duplicates); the
        # state rows are gathered by the same idx
        idx = slots + [slots[0]] * (width - occ)
        act = lane.active[idx].copy()
        act[occ:] = False                 # padding rows are inert
        toks, emits, state = eng._segment_call(
            lane.bucket, width,
            (lane.last_tok[idx][:, None], lane.pos[idx][:, None], act,
             lane.budget[idx], lane.eos[idx]),
            *self._sampling(lane, idx, slots), slots=slots)
        toks, emits = toks[:occ], emits[:occ]
        st_active = state["active"][:occ]
        st_eos = state["eos_hit"][:occ]
        lane.last_tok[slots] = state["tok"][:occ]
        lane.pos[slots] = state["pos"][:occ]
        lane.budget[slots] = state["budget"][:occ]
        lane.active[slots] = st_active
        return slots, toks, emits, st_active, st_eos

    # ------------------------------------------------------------ retire
    def _resolve(self, r, toks, reason: str, now: float) -> None:  # holds: worker
        eng = self.eng
        timing = RequestTiming(queue_s=r.t_start - r.t_submit,
                               prefill_s=r.t_prefill_done - r.t_start,
                               decode_s=now - r.t_prefill_done)
        with eng._samples_lock:
            eng.timings.append(timing)
            eng.latencies.append(now - r.t_submit)
        r.future.set_result(GenerationResult(
            tokens=np.asarray(toks, np.int32), finish_reason=reason,
            timing=timing, request_id=r.handle.request.request_id))

    def _finish(self, lane: _Lane, row: _Row, reason: str,  # holds: worker
                now: float) -> None:
        del lane.rows[row.slot]
        lane.pool.release(row.slot)
        lane.active[row.slot] = False
        self._resolve(row.req, row.toks, reason, now)

    def _fail_inflight(self, exc: Exception) -> None:  # holds: worker
        for lane in self.lanes.values():
            for row in list(lane.rows.values()):
                del lane.rows[row.slot]
                lane.pool.release(row.slot)
                lane.active[row.slot] = False
                if not row.req.future.done():
                    row.req.future.set_exception(exc)
            fills = list(lane.fills)
            self._release_fills(lane, fills)
            for f in fills:
                if not f.req.future.done():
                    f.req.future.set_exception(exc)

    def _shutdown(self) -> None:  # holds: worker
        err = RuntimeError("engine is closed")
        self._fail_inflight(err)
        for r in self.pending.drain():
            if not r.future.done():
                r.future.set_exception(err)
