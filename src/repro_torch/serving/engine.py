"""MLaaS serving engine, encoder mode: the PyTorch stand-in for the
paper's Nginx + Flask + GECToR stack (Fig. 6).

Port of the encoder mode of ``repro/serving/engine.py``. Requests are
token sequences; a background worker drains the queue into batches (up to
``max_batch``, waiting at most ``batch_window_ms``), pads each batch to
the smallest pad bucket that fits its longest request, runs one
bidirectional forward on the device (K1 for attention on the card) and
resolves each request's future with its row of the output, copied to the
host. An optional ``AdmissionQueue`` bounds in-flight work (the paper's
proposed §4 mitigation): submit try-acquires a slot and, when saturated,
parks the request on an overflow queue; a finishing request hands its
slot to the oldest parked one. Decoder mode, quantized
weights and the quantized KV cache are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import forward
from repro_torch.serving.api import HeadFn
from repro_torch.serving.scheduler import AdmissionQueue, RequestQueue


class RequestTooLong(ValueError):
    """Raised (into the request's future) when a request exceeds the largest
    pad bucket — rejecting beats the silent truncation it replaces."""


@dataclasses.dataclass
class EngineConfig:
    """The JAX engine's knobs, with the same defaults. Encoder mode reads
    mode, max_batch, batch_window_ms, pad_buckets and max_inflight; the
    decoder knobs are here for the decoder slice (ROADMAP Queue 1 items
    5-10), and turning on one that changes behaviour raises."""
    mode: str = "encoder"             # 'encoder' | 'decoder'
    max_batch: int = 32
    batch_window_ms: float = 2.0
    pad_buckets: tuple = (32, 64, 128, 256, 512)
    max_inflight: Optional[int] = None   # admission control; None = off
    max_new_tokens: int = 16
    use_scan_decode: bool = True
    use_cache_pool: bool = True
    continuous: bool = True
    decode_segment: int = 4
    multi_lane: bool = True
    prefill_chunk: Optional[int] = None
    segment_width: str = "adaptive"
    prefix_cache: bool = False
    prefix_cache_bytes: Optional[int] = None
    weight_quant: Optional[str] = None
    kv_quant: Optional[str] = None
    spec_decode: bool = False
    spec_k: int = 4


@dataclasses.dataclass
class _Request:
    tokens: np.ndarray
    future: Future
    t_submit: float


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    return [tree]


def _check_config(ec: EngineConfig) -> None:
    if ec.mode == "decoder":
        raise NotImplementedError(
            "mode='decoder' is ROADMAP Queue 1 item 5 (batch-at-a-time "
            "decode with K2) and item 6 (KV pool, continuous scheduler)")
    if ec.mode != "encoder":
        raise ValueError(f"mode must be 'encoder' or 'decoder', got "
                         f"{ec.mode!r}")
    if ec.weight_quant is not None:
        raise NotImplementedError(
            "weight_quant is ROADMAP Queue 1 item 9 (quantized serving)")
    if ec.kv_quant is not None:
        raise NotImplementedError(
            "kv_quant is ROADMAP Queue 1 item 9 (quantized serving)")
    if ec.prefix_cache or ec.spec_decode:
        raise ValueError("prefix_cache and spec_decode require the "
                         "continuous decoder path")
    if ec.segment_width not in ("adaptive", "fixed"):
        raise ValueError(f"segment_width must be 'adaptive' or 'fixed', "
                         f"got {ec.segment_width!r}")


class ServingEngine:
    def __init__(self, cfg, params, engine_cfg: EngineConfig,
                 head_fn: Optional[HeadFn] = None, *, device=None):
        """``params``: an encoder tree or a GECToR tree (the encoder under
        ``'encoder'``), moved to ``device`` (default: the card).
        ``head_fn(params, hidden, mask)`` — see ``serving.api.HeadFn`` —
        maps the final hidden states to each request's payload; without
        it a request resolves to its hidden states."""
        _check_config(engine_cfg)
        self.device = resolve_device(device)      # guarded-by: init
        self.cfg = cfg                    # guarded-by: init
        self.params = _tree_map(          # guarded-by: init
            lambda t: t.to(self.device), params)
        self.ec = engine_cfg              # guarded-by: init
        self.head_fn = head_fn            # guarded-by: init
        self._weight_bytes = sum(         # guarded-by: init
            t.numel() * t.element_size() for t in _tree_leaves(self.params))
        self._q: "queue.Queue[_Request]" = queue.Queue()  # guarded-by: threadsafe
        self._admission = (AdmissionQueue(engine_cfg.max_inflight)  # guarded-by: threadsafe
                           if engine_cfg.max_inflight else None)
        # samples the worker appends and clients read (metrics/window)
        self._samples_lock = threading.Lock()     # guarded-by: threadsafe
        self.latencies: List[float] = []          # guarded-by: _samples_lock
        self.batch_sizes: List[int] = []          # guarded-by: _samples_lock
        self._win_cursor = {"latencies": 0,       # guarded-by: _samples_lock
                            "batch_sizes": 0}
        self._stop = threading.Event()            # guarded-by: threadsafe
        # reentrant: a done-callback attached under the lock can fire
        # synchronously (future cancelled in the attach window) and re-enter
        self._submit_lock = threading.RLock()  # guarded-by: threadsafe — orders submit vs close
        self._overflow = RequestQueue()        # guarded-by: _submit_lock — admission overflow
        self._parked_cancelled = 0             # guarded-by: _submit_lock — phantoms in heap
        self._worker = threading.Thread(target=self._run, daemon=True)  # guarded-by: init
        self._worker.start()

    # ------------------------------------------------------------- client
    def submit(self, tokens: np.ndarray) -> Future:
        """Untyped tokens in, future out. The future resolves to the head's
        payload for this request (a CPU tensor row, or a tree of them)."""
        fut: Future = Future()
        toks = np.asarray(tokens, np.int32)
        if self._stop.is_set():
            fut.set_exception(RuntimeError("engine is closed"))
            return fut
        try:
            self._bucket(len(toks))
        except RequestTooLong as e:
            fut.set_exception(e)
            return fut
        self._submit_req(_Request(toks, fut, time.perf_counter()))
        return fut

    def _submit_req(self, req: _Request) -> None:
        """Admission + enqueue."""
        if self._admission is not None:
            with self._submit_lock:
                if self._stop.is_set():
                    req.future.set_exception(RuntimeError("engine is closed"))
                    return
                if self._admission.try_acquire():
                    self._enqueue_admitted(req)
                else:
                    # saturated: park without blocking the submitter; a
                    # finishing request's done-callback transfers its slot
                    # to the oldest parked request. The reported depth
                    # excludes requests cancelled while parked
                    self._overflow.push(req)
                    req.future.add_done_callback(self._on_parked_done)
                    self._admission.note_queued(
                        len(self._overflow) - self._parked_cancelled)
            return
        # the lock orders this enqueue against close()'s drain: either the
        # request lands before the drain (and is failed by it) or it sees
        # _stop and is rejected here — it can never be silently stranded
        with self._submit_lock:
            if self._stop.is_set():
                req.future.set_exception(RuntimeError("engine is closed"))
                return
            self._q.put(req)

    def _enqueue_admitted(self, req: _Request) -> None:  # holds: _submit_lock
        """Put an admitted request on the worker queue; its slot is held
        until the future resolves, then handed to the next parked request.
        Caller holds _submit_lock (reentrant: a done-callback on an
        already-done future fires synchronously in this thread)."""
        req.future.add_done_callback(self._on_admitted_done)
        self._q.put(req)

    def _on_parked_done(self, fut) -> None:
        if fut.cancelled():
            with self._submit_lock:
                self._parked_cancelled += 1

    def _drop_parked(self, r) -> bool:  # holds: _submit_lock
        """Pop predicate: discard done (cancelled-while-parked) entries,
        reconciling the phantom counter as they leave the heap."""
        if r.future.done():
            if r.future.cancelled():
                self._parked_cancelled -= 1
            return True
        return False

    def _on_admitted_done(self, _fut) -> None:
        with self._submit_lock:
            if not self._stop.is_set():
                nxt = self._overflow.pop(drop=self._drop_parked)
                if nxt is not None:
                    self._admission.admit_transfer(
                        time.perf_counter() - nxt.t_submit)
                    self._enqueue_admitted(nxt)
                    return
            self._admission.release()

    def warmup(self, batch_sizes=None, *, buckets=None) -> None:
        """Serve one synthetic batch per (bucket, batch size) — default
        every pad bucket x ``1..max_batch`` — so the first measured request
        pays no first-use cost (kernel build and load, library handles,
        allocator growth). The batches count into ``metrics()``; call
        ``discard_samples()`` afterwards to drop them."""
        buckets = tuple(buckets) if buckets else self.ec.pad_buckets
        sizes = sorted(set(batch_sizes or range(1, self.ec.max_batch + 1)))
        for bucket in buckets:
            tok = np.ones(bucket, np.int32)    # full width -> this bucket
            for b in sizes:
                self._serve_batch([
                    _Request(tok.copy(), Future(), time.perf_counter())
                    for _ in range(b)])

    def discard_samples(self) -> None:
        """Drop the accumulated per-request samples (wall latencies, batch
        sizes) and re-sync the ``window()`` cursor, so later ``metrics()``
        / ``window()`` spans cover only measured requests."""
        with self._samples_lock:
            self.latencies.clear()
            self.batch_sizes.clear()
            self._win_cursor = {"latencies": 0, "batch_sizes": 0}

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)
        # fail everything still parked or queued: resolves client futures
        # (and, via the done-callbacks, frees any held admission slots)
        with self._submit_lock:
            pending = self._overflow.drain()
        while True:
            try:
                pending.append(self._q.get_nowait())
            except queue.Empty:
                break
        for req in pending:
            if not req.future.done():
                req.future.set_exception(RuntimeError("engine is closed"))

    # ------------------------------------------------------------- server
    def _bucket(self, n: int) -> int:
        for b in self.ec.pad_buckets:
            if n <= b:
                return b
        raise RequestTooLong(
            f"request of {n} tokens exceeds the largest pad bucket "
            f"({self.ec.pad_buckets[-1]}); split the request or configure "
            f"larger pad_buckets")

    def _encode(self, tokens, mask):  # holds: worker
        """One bidirectional forward over a padded batch. Every bucket
        position carries a valid position and ``mask`` reaches only
        ``head_fn``, so real tokens attend to the pad tokens, as in the
        JAX engine."""
        enc_params = self.params.get("encoder", self.params)
        hid = forward(self.cfg, enc_params, tokens=tokens, causal=False,
                      return_hidden=True)
        if self.head_fn is not None:
            return self.head_fn(self.params, hid, mask)
        return hid

    def _serve_batch(self, reqs: List[_Request]):  # holds: worker
        # claim each future (concurrent.futures protocol): a client-side
        # cancel() that won between enqueue and here drops the request
        # instead of poisoning set_result for the whole batch
        reqs = [r for r in reqs if r.future.set_running_or_notify_cancel()]
        if not reqs:
            return
        lens = [len(r.tokens) for r in reqs]
        bucket = self._bucket(max(lens))
        B = len(reqs)
        toks = np.zeros((B, bucket), np.int64)
        mask = np.zeros((B, bucket), bool)
        for i, r in enumerate(reqs):
            toks[i, :len(r.tokens)] = r.tokens
            mask[i, :len(r.tokens)] = True
        with torch.inference_mode():
            out = self._encode(torch.from_numpy(toks).to(self.device),
                               torch.from_numpy(mask).to(self.device))
            out = _tree_map(lambda t: t.cpu(), out)   # waits for the device
        # record samples BEFORE resolving futures: a client whose
        # .result() returns must find its sample in metrics()/window()
        self._record_batch(reqs)
        for i, r in enumerate(reqs):
            r.future.set_result(_tree_map(lambda x: x[i], out))

    def _record_batch(self, reqs: List[_Request]) -> None:  # holds: worker
        now = time.perf_counter()
        with self._samples_lock:
            self.batch_sizes.append(len(reqs))
            self.latencies.extend(now - r.t_submit for r in reqs)

    def _run(self):  # holds: worker
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.ec.batch_window_ms / 1e3
            while len(batch) < self.ec.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                self._serve_batch(batch)
            except Exception as e:  # surfaced to every client of the batch
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)

    # ------------------------------------------------------------ metrics
    @staticmethod
    def _aggregate(latencies, batch_sizes) -> dict:
        """Reduce one span of serving samples to the metrics dict shape."""
        n = len(latencies)
        m = {"requests": n}
        if n:
            lat = np.array(latencies)
            m.update(latency_mean_s=float(lat.mean()),
                     latency_p50_s=float(np.percentile(lat, 50)),
                     latency_p95_s=float(np.percentile(lat, 95)))
        else:
            m.update(latency_mean_s=None, latency_p50_s=None,
                     latency_p95_s=None)
        m["batch_size_mean"] = (float(np.mean(batch_sizes))
                                if batch_sizes else 0.0)
        return m

    def metrics(self) -> dict:
        """Cumulative serving stats since engine start (or the last
        ``discard_samples``), plus the admission counters. With no
        completed requests the latency percentiles are None."""
        with self._samples_lock:
            m = self._aggregate(list(self.latencies),
                                list(self.batch_sizes))
        m["weight_bytes"] = self._weight_bytes
        if self._admission is not None:
            adm = self._admission.snapshot()   # consistent read under _lock
            m["admission_peak_queue"] = adm.queued_peak
            m["admission_wait_total_s"] = adm.wait_total_s
        return m

    def window(self) -> dict:
        """The same stats for the span since the previous ``window()`` call
        (or engine start), then start a new window."""
        with self._samples_lock:
            cur = self._win_cursor
            i_lat, i_bs = len(self.latencies), len(self.batch_sizes)
            m = self._aggregate(self.latencies[cur["latencies"]:i_lat],
                                self.batch_sizes[cur["batch_sizes"]:i_bs])
            self._win_cursor = {"latencies": i_lat, "batch_sizes": i_bs}
        m["weight_bytes"] = self._weight_bytes     # gauge, not diffed
        return m
