"""Multi-lane step-driven continuous-batching scheduler.

Port of ``repro/serving/continuous.py`` without chunked prefill (ROADMAP
Queue 1 item 7), the prefix cache (item 8) and speculative decoding
(item 10): their entry points raise naming the item.

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
"""
from __future__ import annotations

import dataclasses
import queue
import time
from typing import Dict, List, Optional

import numpy as np

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


class _Fill:
    """A join whose prompt prefills chunk by chunk: chunked prefill is
    ROADMAP Queue 1 item 7."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "chunked prefill (_Fill) is ROADMAP Queue 1 item 7")


class _Lane:
    """One pad bucket's in-flight set: pool slots + per-slot decode state.

    State arrays are indexed by pool slot; free slots ride along inactive
    (``active=False``) in every full-width segment, re-writing their frozen
    KV position, and reset-on-assign wipes a slot when it is re-acquired.
    """

    def __init__(self, eng, bucket: int):
        self._eng = eng                  # guarded-by: init
        self.bucket = bucket             # guarded-by: init
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
        self.fills: List[_Fill] = []            # guarded-by: worker — chunked prefills (item 7)

    @property
    def busy(self) -> bool:  # holds: worker
        return bool(self.rows or self.fills)

    @property
    def pool(self) -> CachePool:  # holds: worker
        """The bucket's slot pool, through the engine's pool cache, so
        buckets the workload never touches allocate nothing."""
        return self._eng._get_pool(self.bucket)


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
        """One scheduler turn for a lane: one decode segment for its
        in-flight rows."""
        if lane.fills:
            self._fill_chunk(lane)
        if lane.rows:
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
            # no prefix store and no chunked prefill (items 8 and 7): every
            # join prefills its whole prompt
            self._prefill(claimed, lane)

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
            live = {id(row.req) for row in lane.rows.values()}
            ids = {id(r) for r in claimed}
            for slot, rid in enumerate(lane.pool.request_of):
                if rid in ids and slot not in lane.rows:
                    lane.pool.release(slot)
            for r in claimed:
                if id(r) not in live and not r.future.done():
                    r.future.set_exception(e)

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
        for s, n in zip(slots, lens):
            pool.lengths[s] = int(n) + 1
        with eng._samples_lock:
            eng._stats["prefill_batches"] += 1
        t1 = time.perf_counter()
        for i, (r, s) in enumerate(zip(claimed, slots)):
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

    # ------------------------------------------- not ported: items 7, 8, 10
    def _prefill_hits(self, claimed, lane: _Lane) -> None:  # holds: worker
        raise NotImplementedError(
            "prefix-cache hits are ROADMAP Queue 1 item 8")

    def _insert_prefix(self, lane: _Lane, r, matched: int,  # holds: worker
                       slot: int) -> None:
        raise NotImplementedError(
            "prefix-cache inserts are ROADMAP Queue 1 item 8")

    def _begin_fills(self, claimed, lane: _Lane, entries=None) -> None:  # holds: worker
        raise NotImplementedError("chunked prefill is ROADMAP Queue 1 item 7")

    def _fill_chunk(self, lane: _Lane) -> None:  # holds: worker
        raise NotImplementedError("chunked prefill is ROADMAP Queue 1 item 7")

    def _draft_prefill(self, lane: _Lane, reqs, slots) -> None:  # holds: worker
        raise NotImplementedError(
            "speculative decoding is ROADMAP Queue 1 item 10")

    def _spec_round(self, lane: _Lane) -> None:  # holds: worker
        raise NotImplementedError(
            "speculative decoding is ROADMAP Queue 1 item 10")

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

    def _shutdown(self) -> None:  # holds: worker
        err = RuntimeError("engine is closed")
        self._fail_inflight(err)
        for r in self.pending.drain():
            if not r.future.done():
                r.future.set_exception(err)
