"""A copy of ``repro/serving/scheduler.py``.

Admission-control queue — the mitigation the paper *proposes* in §4
("create a queue in the application layer to control submission flow taking
this processing threshold into account") but does not implement.

We implement it: a bounded in-flight window with FIFO overflow queueing.
Under overload the paper's Flask setup lets every request contend (latency
blows up superlinearly, their Tables 2–4 above the red line); with admission
control, excess requests wait in queue and in-flight work stays at the
throughput-optimal concurrency, so p50 service latency stays flat and only
queue wait grows linearly. examples/serve_poc.py measures both modes.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field, replace
from typing import List, Sequence, Tuple


# --------------------------------------------------- segment-width policy
def width_tiers(max_batch: int) -> Tuple[int, ...]:
    """The ladder of decode-segment widths a lane may run: powers of two
    up to (and always including) ``max_batch`` — e.g. 8 -> (1, 2, 4, 8),
    6 -> (1, 2, 4, 6). Each tier is one compiled ``decode_segment``
    specialization, so the ladder bounds compile count at
    O(log max_batch) while keeping batch waste under 2x of occupancy."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    tiers = []
    w = 1
    while w < max_batch:
        tiers.append(w)
        w *= 2
    tiers.append(max_batch)
    return tuple(tiers)


def pick_tier(occupancy: int, tiers: Sequence[int]) -> int:
    """Smallest tier that fits ``occupancy`` live rows (the width the
    scheduler compacts the next decode segment to)."""
    for w in tiers:
        if occupancy <= w:
            return w
    return tiers[-1]


class RequestQueue:
    """Priority-aware request ordering (admission overflow + the continuous
    scheduler's pending set): pop returns the highest-priority entry, FIFO
    within a priority level. Not thread-safe — callers hold the engine's
    submit lock (overflow) or own the worker thread (pending)."""

    def __init__(self):
        self._heap: list = []            # guarded-by: external
        self._seq = itertools.count()    # guarded-by: external

    def push(self, item, priority: int = 0) -> None:
        heapq.heappush(self._heap, (-priority, next(self._seq), item))

    def pop(self, pred=None, drop=None):
        """Pop the best item for which ``pred`` holds (default: any).
        Entries matching ``drop`` (e.g. requests cancelled while queued)
        are discarded during the scan; entries failing ``pred`` are kept.
        Returns None when no item qualifies."""
        kept, best = [], None
        while self._heap:
            entry = heapq.heappop(self._heap)
            if drop is not None and drop(entry[2]):
                continue
            if pred is None or pred(entry[2]):
                best = entry[2]
                break
            kept.append(entry)
        for entry in kept:
            heapq.heappush(self._heap, entry)
        return best

    def peek_key(self, drop=None):
        """(-priority, seq) of the best live entry, discarding ``drop``
        matches from the top; None when empty. Lets a multi-lane scheduler
        compare lane heads without popping."""
        while self._heap:
            if drop is not None and drop(self._heap[0][2]):
                heapq.heappop(self._heap)
                continue
            return self._heap[0][:2]
        return None

    def drain(self) -> List:
        items = [e[2] for e in sorted(self._heap)]
        self._heap.clear()
        return items

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


class LaneQueue:
    """Pending requests partitioned by scheduling lane (pad bucket).

    The single-set scheduler kept one shared heap and popped with a
    bucket predicate — an O(pending) pop/push rescan every segment while
    requests for *other* buckets sat in the heap. Keying a ``RequestQueue``
    per lane makes the per-lane pop O(log n_lane) and gives the multi-lane
    scheduler its admission view: which lanes have work, and which lane
    holds the globally best request (priority order, FIFO within a level,
    consistent across lanes via the shared sequence counter). Not
    thread-safe — owned by the scheduler worker thread."""

    def __init__(self):
        self._lanes: dict = {}           # guarded-by: external — lane -> RequestQueue
        self._seq = itertools.count()    # guarded-by: external — cross-lane FIFO

    def push(self, item, priority: int = 0, *, lane) -> None:
        q = self._lanes.get(lane)
        if q is None:
            q = self._lanes[lane] = RequestQueue()
            q._seq = self._seq           # one counter across all lanes
        q.push(item, priority)

    def pop(self, lane, drop=None):
        q = self._lanes.get(lane)
        return q.pop(drop=drop) if q is not None else None

    def lanes(self) -> List:
        """Lane keys that currently hold entries (insertion order)."""
        return [k for k, q in self._lanes.items() if q]

    def lane_len(self, lane) -> int:
        q = self._lanes.get(lane)
        return len(q) if q is not None else 0

    def best_lane(self, drop=None):
        """The lane whose head is the globally best pending request."""
        best_key, best_lane = None, None
        for lane, q in self._lanes.items():
            key = q.peek_key(drop=drop)
            if key is not None and (best_key is None or key < best_key):
                best_key, best_lane = key, lane
        return best_lane

    def drain(self) -> List:
        items = []
        for q in self._lanes.values():
            items.extend(q.drain())
        return items

    def __len__(self) -> int:
        return sum(len(q) for q in self._lanes.values())

    def __bool__(self) -> bool:
        return any(self._lanes.values())


@dataclass
class AdmissionStats:
    admitted: int = 0
    queued_peak: int = 0
    wait_total_s: float = 0.0


class AdmissionQueue:
    def __init__(self, max_inflight: int):
        self.max_inflight = max_inflight  # guarded-by: init
        self._sem = threading.Semaphore(max_inflight)  # guarded-by: threadsafe
        self._lock = threading.Lock()     # guarded-by: threadsafe
        self._waiting = 0                 # guarded-by: _lock
        self.stats = AdmissionStats()     # guarded-by: _lock

    def acquire(self) -> None:
        """Block until an in-flight slot is free (FIFO-ish via semaphore)."""
        t0 = time.perf_counter()
        with self._lock:
            self._waiting += 1
            self.stats.queued_peak = max(self.stats.queued_peak,
                                         self._waiting)
        self._sem.acquire()
        with self._lock:
            self._waiting -= 1
            self.stats.admitted += 1
            self.stats.wait_total_s += time.perf_counter() - t0

    def try_acquire(self) -> bool:
        """Non-blocking admission — the engine's submit path: a free slot
        admits immediately; otherwise the caller parks the request on an
        overflow queue (no dispatcher thread, no blocked submitter) and
        reports its depth via note_queued/admit_transfer."""
        if not self._sem.acquire(blocking=False):
            return False
        with self._lock:
            self.stats.admitted += 1
        return True

    def note_queued(self, depth: int) -> None:
        """Record the overflow-queue depth (server-side queueing stat)."""
        with self._lock:
            self.stats.queued_peak = max(self.stats.queued_peak, depth)

    def admit_transfer(self, waited_s: float) -> None:
        """A finishing request handed its slot straight to a queued one."""
        with self._lock:
            self.stats.admitted += 1
            self.stats.wait_total_s += waited_s

    def snapshot(self) -> AdmissionStats:
        """Consistent copy of the admission counters — the lock-safe way
        for ``engine.metrics()`` (a client thread) to read them."""
        with self._lock:
            return replace(self.stats)

    def release(self) -> None:
        self._sem.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False
