"""MLaaS serving engine: the PyTorch stand-in for the paper's Nginx +
Flask + GECToR stack (Fig. 6).

Port of ``repro/serving/engine.py`` in two modes:
  * 'encoder': one bidirectional forward per request batch (GECToR);
    ``submit(tokens)`` resolves to the head's payload for the request.
  * 'decoder': ``generate(request)`` returns a ``RequestHandle`` that
    resolves to a ``GenerationResult``. The default worker is the
    continuous scheduler (``serving.continuous``): decode runs in short
    segments over a lane's slot batch of the ``CachePool``
    (``serving.kvcache``); between segments finished rows retire and new
    requests prefill straight into free slots, and each segment is
    compacted to the smallest width tier that fits the lane's live rows
    (``segment_width="adaptive"``). ``continuous=False`` keeps the
    batch-at-a-time worker: a batch is prefilled, its first token taken at
    each row's last real position and ``decode_segment`` run for the
    remaining ``max_new_tokens - 1`` steps, on the pool's slots
    (``use_cache_pool``) or fresh caches; the host then cuts each row at
    its budget or its first eos.

What JAX compiles once per shape runs here as one captured CUDA graph
per shape (``serving.graphs``): the encoder forward per (bucket, batch),
a batch's prefill and decode per (bucket, batch, greedy or sampled), and
the continuous prefill-into-slot per (join size, bucket, sampled) and
decode segment per (bucket, width, sampled). ``use_scan_decode=False``
runs the batch-at-a-time decode eagerly instead, as JAX's per-token path
runs outside its scan. On the CPU every one of them runs eagerly. The
number of programs built is ``metrics()["jit_compiles"]``.

A background worker drains the queue; every request's result is copied
to the host before its future resolves. An optional ``AdmissionQueue``
bounds in-flight work (the paper's proposed §4 mitigation): submit
try-acquires a slot and, when saturated, parks the request on a
priority-ordered overflow queue; a finishing request hands its slot to
the best parked one. With ``weight_quant="int8"`` the engine quantizes
the tree once at init and every projection runs K3; with
``kv_quant="int8"`` (decoder mode) the caches hold int8 K/V with fp32
scale planes; both for the plain ``("attn",)`` stack only. The decoder
serves the RecurrentGemma hybrid too: its caches hold local-attention
rings of ``min(bucket + max_new_tokens, window)`` slots and the RG-LRU
blocks' recurrent states. Chunked prefill, the prefix cache and
speculative decoding are not ported yet and raise.
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
from repro_torch.models import (decode_segment, forward, make_caches,
                                sample_logits)
from repro_torch.models.layers import head_weight, lm_head_apply
from repro_torch.quant import (params_bytes, quantize_params,
                               validate_kv_quant)
from repro_torch.serving import kvcache
from repro_torch.serving.api import (FINISH_CANCELLED, FINISH_EOS,
                                     FINISH_LENGTH, GenerationRequest,
                                     GenerationResult, HeadFn,
                                     RequestHandle, RequestTiming,
                                     SamplingParams)
from repro_torch.serving.graphs import GraphCache
from repro_torch.serving.kvcache import CachePool
from repro_torch.serving.scheduler import (AdmissionQueue, RequestQueue,
                                           pick_tier, width_tiers)


class RequestTooLong(ValueError):
    """Raised (into the request's future) when a request exceeds the largest
    pad bucket — rejecting beats the silent truncation it replaces."""


@dataclasses.dataclass
class EngineConfig:
    """The JAX engine's knobs, with the same defaults. ``continuous``
    (with ``use_scan_decode`` and ``use_cache_pool``) selects the
    continuous scheduler, as in JAX; ``decode_segment``, ``multi_lane``
    and ``segment_width`` shape it. ``prefill_chunk``, ``prefix_cache``
    and ``spec_decode`` on the continuous path are ROADMAP Queue 1 items
    7, 8 and 10 and raise; off it they take the JAX engine's errors.
    ``weight_quant`` (None or "int8") serves both modes; ``kv_quant``
    (None or "int8") the decoder."""
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
    """Internal carrier. Encoder requests and warmup batches carry the
    three positional fields; decoder requests also carry their sampling
    params, effective budget, priority and client handle."""
    tokens: np.ndarray
    future: Future
    t_submit: float
    sampling: Optional[SamplingParams] = None
    budget: int = 0
    priority: int = 0
    handle: Optional[RequestHandle] = None
    t_start: float = 0.0              # worker picked it up (prefill start)
    t_prefill_done: float = 0.0


def _trim_host(gen: np.ndarray, eos: np.ndarray, budget: np.ndarray):
    """Host-side emission trim for the batch-at-a-time path: a row's
    output ends at its budget or just after its first eos token. Returns
    (emits (B, T) bool, eos_hit (B,) bool)."""
    B, T = gen.shape
    emits = np.zeros((B, T), bool)
    eos_hit = np.zeros(B, bool)
    for i in range(B):
        n = int(min(budget[i], T))
        if eos[i] >= 0:
            where = np.where(gen[i, :n] == eos[i])[0]
            if where.size:
                n = int(where[0]) + 1
                eos_hit[i] = True
        emits[i, :n] = True
    return emits, eos_hit


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


# A prefill's projections run at M = rows x bucket. On the card a row's
# bits change with M below 128 rows (cuBLAS takes other kernels for
# float weights there, K3 its split-K path up to 64 rows), while at the
# M that chip_smoke phase 22 measures from 128 up (every join size of
# its continuous loads) they do not. So the captured prefills pad a
# batch with copies of its first row to at least PREFILL_MIN_M rows of
# M. A decode step takes K2's split count from ``max_batch``, not from
# the width it runs at (``forward``'s ``decode_width``), since the split
# count sets the order of K2's fold.
PREFILL_MIN_M = 128


def _pad_rows(n: int, *arrays):
    """Each host array (or None) with its first axis padded to ``n`` by
    copies of its first row."""
    return tuple(None if a is None else
                 np.concatenate([a, np.repeat(a[:1], n - len(a), axis=0)])
                 for a in arrays)


def _continuous(ec: EngineConfig) -> bool:
    """JAX's ``continuous_active``."""
    return (ec.mode == "decoder" and ec.continuous and ec.use_scan_decode
            and ec.use_cache_pool)


def _check_config(ec: EngineConfig) -> None:
    """The JAX engine's configuration errors, then the features of the
    continuous path that are not ported yet."""
    if ec.mode not in ("encoder", "decoder"):
        raise ValueError(f"mode must be 'encoder' or 'decoder', got "
                         f"{ec.mode!r}")
    if ec.weight_quant not in (None, "int8"):
        raise ValueError(f"weight_quant must be None or 'int8', got "
                         f"{ec.weight_quant!r}")
    validate_kv_quant(ec.kv_quant)
    if ec.kv_quant and ec.mode != "decoder":
        raise ValueError("kv_quant requires mode='decoder' (the KV "
                         "cache only exists on the decode path)")
    if ec.segment_width not in ("adaptive", "fixed"):
        raise ValueError(f"segment_width must be 'adaptive' or 'fixed', "
                         f"got {ec.segment_width!r}")
    cont = _continuous(ec)
    C = ec.prefill_chunk
    for name in ("prefix_cache", "spec_decode"):
        if getattr(ec, name) and not cont:
            raise ValueError(
                f"{name} requires the continuous decoder path "
                f"(mode='decoder', continuous/use_scan_decode/"
                f"use_cache_pool all on)")
    if ec.prefix_cache and C is None:
        raise ValueError("prefix_cache requires prefill_chunk: chunk "
                         "boundaries define the prefix granularity")
    if ec.spec_decode and ec.spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {ec.spec_k}")
    needs = []
    if cont and C is not None:
        needs.append("prefill_chunk (chunked prefill) is ROADMAP Queue 1 "
                     "item 7")
    if ec.prefix_cache:
        needs.append("prefix_cache is ROADMAP Queue 1 item 8")
    if ec.spec_decode:
        needs.append("spec_decode (speculative decoding) is ROADMAP Queue "
                     "1 item 10")
    if needs:
        raise NotImplementedError("; ".join(needs))


class ServingEngine:
    def __init__(self, cfg, params, engine_cfg: EngineConfig,
                 head_fn: Optional[HeadFn] = None, *, device=None):
        """``params``: a model tree, or (encoder mode) a GECToR tree with
        the encoder under ``'encoder'``, moved to ``device`` (default: the
        card). ``head_fn(params, hidden, mask)`` — see
        ``serving.api.HeadFn`` — maps the encoder's final hidden states to
        each request's payload; without it a request resolves to its
        hidden states. Decoder requests resolve to their tokens. With
        ``weight_quant="int8"`` the tree is quantized on the device, once
        (``quantize_params``); otherwise the engine keeps the caller's
        leaves."""
        _check_config(engine_cfg)
        if ((engine_cfg.weight_quant or engine_cfg.kv_quant)
                and tuple(cfg.pattern) != ("attn",)):
            raise NotImplementedError(
                f"{cfg.name}: int8 serving of a pattern other than "
                f"('attn',) (pattern={cfg.pattern!r}: local-attention rings "
                f"and float recurrent leaves) is ROADMAP Queue 1 item 15")
        self.device = resolve_device(device)      # guarded-by: init
        self.cfg = cfg                    # guarded-by: init
        self.params = _tree_map(          # guarded-by: init
            lambda t: t.to(self.device), params)
        if engine_cfg.weight_quant == "int8":
            self.params = quantize_params(self.params)
        self.ec = engine_cfg              # guarded-by: init
        self.head_fn = head_fn            # guarded-by: init
        self._weight_bytes = params_bytes(self.params)   # guarded-by: init
        # the decoder's output matrix in the model dtype, cast once (a
        # captured program reads it in place)
        self._head_w = (                  # guarded-by: init
            head_weight(cfg, self.params.get("lm_head"),
                        self.params["embed"])
            if engine_cfg.mode == "decoder" else None)
        # built by the worker (or by warmup before any traffic); clients
        # read only its capture count
        self._graphs = GraphCache(self.device)    # guarded-by: threadsafe
        self._pools = {}                  # guarded-by: worker — bucket -> CachePool
        self.continuous_active = _continuous(engine_cfg)  # guarded-by: init
        # the width ladder compacted segments may run at; 'fixed'
        # degenerates to the max_batch-only ladder
        self._tiers = (width_tiers(engine_cfg.max_batch)  # guarded-by: init
                       if engine_cfg.segment_width == "adaptive"
                       else (engine_cfg.max_batch,))
        self._q: "queue.Queue[_Request]" = queue.Queue()  # guarded-by: threadsafe
        self._admission = (AdmissionQueue(engine_cfg.max_inflight)  # guarded-by: threadsafe
                           if engine_cfg.max_inflight else None)
        # samples and counters the worker appends and clients read
        self._samples_lock = threading.Lock()     # guarded-by: threadsafe
        self.latencies: List[float] = []          # guarded-by: _samples_lock
        self.batch_sizes: List[int] = []          # guarded-by: _samples_lock
        self.timings: List[RequestTiming] = []    # guarded-by: _samples_lock
        self._stats = {"decode_segments": 0,      # guarded-by: _samples_lock
                       "joins_mid_flight": 0,
                       "prefill_batches": 0, "prefill_chunks": 0}
        self.lane_stats = {}              # guarded-by: _samples_lock — per-lane counters
        self._win_cursor = {"latencies": 0,       # guarded-by: _samples_lock
                            "batch_sizes": 0, "timings": 0,
                            "stats": dict(self._stats), "lanes": {}}
        self._stop = threading.Event()            # guarded-by: threadsafe
        # reentrant: a done-callback attached under the lock can fire
        # synchronously (future cancelled in the attach window) and re-enter
        self._submit_lock = threading.RLock()  # guarded-by: threadsafe — orders submit vs close
        self._overflow = RequestQueue()        # guarded-by: _submit_lock — admission overflow
        self._parked_cancelled = 0             # guarded-by: _submit_lock — phantoms in heap
        if self.continuous_active:
            with self._samples_lock:
                for b in engine_cfg.pad_buckets:
                    self._lane_stat(b)   # fixed key set
            from repro_torch.serving.continuous import ContinuousScheduler
            self._scheduler = ContinuousScheduler(self)  # guarded-by: init
            target = self._scheduler.run
        else:
            target = self._run
        self._worker = threading.Thread(target=target, daemon=True)  # guarded-by: init
        self._worker.start()

    # ------------------------------------------------------------- client
    def generate(self, request, sampling: Optional[SamplingParams] = None,
                 *, priority: int = 0,
                 request_id: Optional[str] = None) -> RequestHandle:
        """Submit a typed generation request (decoder mode).

        ``request`` is a ``GenerationRequest`` or a raw token array (then
        ``sampling``/``priority``/``request_id`` build one). Returns a
        ``RequestHandle`` at once; validation errors (``RequestTooLong``,
        an empty prompt, bad sampling params) resolve the handle's future
        exceptionally rather than raising here."""
        if self.ec.mode != "decoder":
            raise ValueError("generate() requires mode='decoder'; encoder "
                             "mode serves via submit()")
        if not isinstance(request, GenerationRequest):
            request = GenerationRequest(
                tokens=np.asarray(request, np.int32),
                sampling=sampling or SamplingParams(),
                priority=priority, request_id=request_id)
        fut: Future = Future()
        handle = RequestHandle(request, fut)
        toks = np.asarray(request.tokens, np.int32)
        try:
            if self._stop.is_set():
                raise RuntimeError("engine is closed")
            if toks.ndim != 1 or toks.size < 1:
                raise ValueError(
                    f"prompt must be a non-empty 1-D token sequence, got "
                    f"shape {toks.shape}")
            budget = request.sampling.validate(self.ec.max_new_tokens)
            if (request.sampling.temperature > 0
                    and not self.ec.use_scan_decode):
                raise ValueError("sampling (temperature > 0) requires "
                                 "use_scan_decode=True")
            self._bucket(len(toks))
        except Exception as e:  # surfaced through the handle
            fut.set_exception(e)
            return handle
        self._submit_req(_Request(toks, fut, time.perf_counter(),
                                  sampling=request.sampling, budget=budget,
                                  priority=request.priority, handle=handle))
        return handle

    def submit(self, tokens: np.ndarray) -> Future:
        """Untyped tokens in, future out. Encoder mode: the future
        resolves to the head's payload for this request (a CPU tensor
        row, or a tree of them). Decoder mode (the JAX engine's v1 shim):
        ``generate()`` with greedy ``SamplingParams``, the future resolving
        to the bare token array; cancelling it does not cancel the
        request (use the handle API)."""
        if self.ec.mode == "decoder":
            h = self.generate(tokens)
            out: Future = Future()

            def relay(f):
                if f.cancelled():
                    out.cancel()
                elif f.exception() is not None:
                    out.set_exception(f.exception())
                else:
                    out.set_result(f.result().tokens)

            h.future.add_done_callback(relay)
            return out
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
                    self._overflow.push(req, req.priority)
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


    def warmup(self, batch_sizes=None, *, buckets=None,
               sampled: bool = False) -> None:
        """Build every program a workload can hit, so captures land here
        instead of inside the first measured request.

        Every bucket in ``buckets`` (default: all ``pad_buckets``) is
        primed for every batch size in ``batch_sizes`` (default
        ``1..max_batch``). Encoder and batch-at-a-time decoder modes serve
        one synthetic batch per (bucket, size) through the serve path
        (the batches count into ``metrics()``; ``discard_samples()``
        drops them). The continuous decoder primes each bucket's
        prefill-into-slot per join size and its decode segment at full
        width and at each width tier the sizes map to, directly against
        the bucket's pool and without request samples; it must run
        before serving traffic. ``sampled=True`` also primes the
        temperature > 0 variant of every continuous program.
        ``metrics()["jit_compiles"]`` counts the programs built and
        ``window()`` diffs it."""
        buckets = tuple(buckets) if buckets else self.ec.pad_buckets
        sizes = sorted(set(batch_sizes or range(1, self.ec.max_batch + 1)))
        if self.continuous_active:
            self._warmup_continuous(buckets, sizes, sampled=sampled)
            return
        for bucket in buckets:
            tok = np.ones(bucket, np.int32)    # full width -> this bucket
            for b in sizes:
                self._serve_batch([
                    _Request(tok.copy(), Future(), time.perf_counter())
                    for _ in range(b)])

    def _warmup_continuous(self, buckets, sizes, sampled=False) -> None:  # holds: worker
        """Prime the continuous scheduler's programs per bucket: the
        prefill-into-slot per join size, the full-width segment, and one
        compacted segment per occupancy in ``sizes`` whose tier is below
        ``max_batch``; with ``sampled`` each again with temperature > 0
        arrays. The pools are created here too."""
        with self._samples_lock:
            served = bool(self.latencies)
        if (served or not self._q.empty()
                or any(l.busy for l in self._scheduler.lanes.values())):
            raise RuntimeError("warmup() must run before serving traffic")
        n = self.ec.max_batch

        def svariants(b):
            out = [(None, None, None)]
            if sampled:
                out.append((np.full(b, 0.5, np.float32),
                            np.zeros(b, np.int32), np.zeros(b, np.int32)))
            return out

        for bucket in buckets:
            pool = self._get_pool(bucket)
            for b in sizes:
                for sargs in svariants(b):
                    slots = pool.claim([f"warm{bucket}.{i}"
                                        for i in range(b)])
                    self._prefill_call(
                        bucket, np.zeros((b, bucket), np.int64),
                        np.full(b, min(4, bucket), np.int32), slots, *sargs)
                    pool.release_many(slots)
            for sargs in svariants(n):
                self._segment_call(bucket, n, self._idle_rows(n), *sargs)
            for occ in sizes:
                width = pick_tier(occ, self._tiers)
                if width >= n:
                    continue
                for sargs in svariants(width):
                    self._segment_call(bucket, width, self._idle_rows(width),
                                       *sargs, slots=list(range(occ)))
        if not self._graphs.eager:
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _idle_rows(n):
        """Segment inputs for ``n`` inactive rows: (tok, pos, active,
        budget, eos)."""
        return (np.zeros((n, 1), np.int32), np.zeros((n, 1), np.int32),
                np.zeros(n, bool), np.ones(n, np.int32),
                np.full(n, -1, np.int32))

    def discard_samples(self) -> None:
        """Drop the accumulated per-request samples (wall latencies, batch
        sizes, phase timings) and re-sync the ``window()`` cursor, so
        later ``metrics()`` / ``window()`` spans cover only measured
        requests. Counters (segments, joins, programs, lane stats) are
        cumulative by design; attribute those via ``window()``."""
        with self._samples_lock:
            self.latencies.clear()
            self.batch_sizes.clear()
            self.timings.clear()
        self.window()

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

    def _encoder_fn(self):  # holds: worker
        """One bidirectional forward over a padded batch, then the head.
        Every bucket position carries a valid position and ``mask``
        reaches only ``head_fn``, so real tokens attend to the pad tokens,
        as in the JAX engine. Captured per (bucket, batch)."""
        def fn(tokens, mask):
            enc_params = self.params.get("encoder", self.params)
            hid = forward(self.cfg, enc_params, tokens=tokens, causal=False,
                          return_hidden=True)
            if self.head_fn is not None:
                return self.head_fn(self.params, hid, mask)
            return hid
        return fn

    # --------------------------------------------------- decoder hot path
    def _sampling_arrays(self, reqs: List[_Request]):  # holds: worker
        """Per-row sampling/stop arrays from a request batch; requests
        without SamplingParams (warmup) are greedy full-budget rows."""
        T = self.ec.max_new_tokens
        B = len(reqs)
        temp = np.zeros(B, np.float32)
        topk = np.zeros(B, np.int32)
        seed = np.zeros(B, np.int32)
        eos = np.full(B, -1, np.int32)
        budget = np.full(B, T, np.int32)
        any_sample = False
        for i, r in enumerate(reqs):
            sp = r.sampling
            if sp is None:
                continue
            budget[i] = r.budget
            if sp.eos_id is not None:
                eos[i] = sp.eos_id
            if sp.temperature > 0:
                any_sample = True
                temp[i] = sp.temperature
                topk[i] = sp.top_k or 0
                seed[i] = sp.seed
        return temp, topk, seed, eos, budget, any_sample

    def _first_token(self, hid, lens, temp, topk, seed):  # holds: worker
        """Each row's first token from the hidden state at its last real
        position: only those rows go through the head, the same values
        per row as JAX's full (B, bucket, vocab) logits."""
        B = hid.shape[0]
        last = hid[torch.arange(B, device=hid.device), lens - 1][:, None]
        logits = lm_head_apply(self.cfg, None, last, w=self._head_w)[:, 0]
        return sample_logits(logits, temperature=temp, top_k=topk,
                             seed=seed, positions=lens)

    def _decode_batch(self, toks, lens, caches, temp, topk, seed):  # holds: worker
        """Prefill -> each row's first token -> ``decode_segment`` over
        the remaining steps, on ``caches`` of ``bucket + max_new_tokens``
        slots, fp32 or, with ``kv_quant``, int8 (the JAX engine's
        layout). ``temp``/``topk``/``seed`` are None for an all-greedy
        batch. Returns int32 (B, T) on the device."""
        cfg, params, T = self.cfg, self.params, self.ec.max_new_tokens
        hid = forward(cfg, params, tokens=toks, caches=caches, mode="full",
                      return_hidden=True)
        tok = self._first_token(hid, lens, temp, topk, seed)[:, None]
        if T == 1:
            return tok
        rest, _, _, _ = decode_segment(cfg, params, tok, lens[:, None],
                                       caches, n_steps=T - 1,
                                       temperature=temp, top_k=topk,
                                       seed=seed, head_w=self._head_w,
                                       decode_width=self.ec.max_batch)
        return torch.cat([tok, rest], dim=1)

    def _decode_scan_fn(self, bucket: int):  # holds: worker
        """The batch's whole prefill and decode as one program (JAX's
        ``_decode_scan_fn``): its caches are the pool's slots ``idx``,
        reset and gathered in the program, or fresh ``make_caches``
        ones. Captured per (bucket, batch, sampled)."""
        pool = self._get_pool(bucket) if self.ec.use_cache_pool else None

        def fn(toks, lens, idx, temp, topk, seed):
            if pool is None:
                caches = make_caches(self.cfg, toks.shape[0],
                                     self._slot_len(bucket),
                                     dtype=torch.float32,
                                     kv_quant=self.ec.kv_quant,
                                     device=self.device)
            else:
                _, caches = kvcache._reset_and_view(pool.caches,
                                                    pool._template, idx)
            return self._decode_batch(toks, lens, caches, temp, topk, seed)
        return fn

    def _slot_len(self, bucket: int) -> int:
        """KV length of the bucket's caches and pool slots."""
        return bucket + self.ec.max_new_tokens

    def _get_pool(self, bucket: int) -> CachePool:  # holds: worker
        pool = self._pools.get(bucket)
        if pool is None:
            pool = CachePool(self.cfg, self.ec.max_batch,
                             self._slot_len(bucket), dtype=torch.float32,
                             kv_quant=self.ec.kv_quant, device=self.device)
            self._pools[bucket] = pool
            if self.continuous_active:
                with self._samples_lock:
                    self._lane_stat(bucket)["kv_bytes"] = pool.nbytes
        return pool

    def _acquire_caches(self, B: int, bucket: int):  # holds: worker
        """Batch-sized decode caches for the eager path: pooled slots
        (reset-on-assign) or a fresh make_caches tree."""
        if not self.ec.use_cache_pool:
            return make_caches(self.cfg, B, self._slot_len(bucket),
                               dtype=torch.float32,
                               kv_quant=self.ec.kv_quant,
                               device=self.device), None
        pool = self._get_pool(bucket)
        slots, view = pool.acquire([f"b{bucket}.{i}" for i in range(B)])
        return view, (pool, slots)

    @staticmethod
    def _release_caches(handle):
        if handle is not None:
            pool, slots = handle
            pool.release_many(slots)

    def _serve_decoder(self, toks, lens, bucket, reqs):  # holds: worker
        """Batch-at-a-time decode. Returns (gen (B, T), emits (B, T) bool,
        eos_hit (B,) bool) on the host — emits marks each row's kept
        prefix (its budget / first-eos trim). ``use_scan_decode`` runs
        the captured program, else the same computation eagerly."""
        B = len(lens)
        temp, topk, seed, eos, budget, any_sample = \
            self._sampling_arrays(reqs)
        sargs = (temp, topk, seed) if any_sample else (None, None, None)
        lens = np.asarray(lens, np.int32)
        with torch.inference_mode():
            if self.ec.use_scan_decode:
                pool = (self._get_pool(bucket) if self.ec.use_cache_pool
                        else None)
                slots = (pool.claim([f"b{bucket}.{i}" for i in range(B)])
                         if pool is not None else [])
                n = self._prefill_rows(B, bucket)
                try:
                    gen = self._graphs.run(
                        ("dec_scan", bucket, B, any_sample),
                        self._decode_scan_fn(bucket),
                        *_pad_rows(n, toks, lens,
                                   np.asarray(slots, np.int64)
                                   if slots else None, *sargs)
                    )[:B].cpu().numpy()
                finally:
                    if pool is not None:
                        pool.release_many(slots)
            else:
                dev = self.device
                caches, handle = self._acquire_caches(B, bucket)
                try:
                    gen = self._decode_batch(
                        torch.from_numpy(toks).to(dev),
                        torch.from_numpy(lens).to(dev), caches,
                        *(None if a is None else torch.from_numpy(a).to(dev)
                          for a in sargs)).cpu().numpy()
                finally:
                    self._release_caches(handle)
        emits, eos_hit = _trim_host(gen, eos, budget)
        return gen, emits, eos_hit

    # ----------------------------------------------- continuous programs
    @staticmethod
    def _prefill_rows(n: int, bucket: int) -> int:
        """Rows a captured prefill of ``n`` prompts runs (see
        ``PREFILL_MIN_M``)."""
        return max(n, -(-PREFILL_MIN_M // bucket))

    def _prefill_fn(self, bucket: int, n: int):  # holds: worker
        """Continuous prefill-into-slot (JAX's ``_prefill_fn`` with the
        pool's acquire and write-back around it): reset and gather the
        join's slots ``idx``, prefill them, select each row's first token,
        write the join's ``n`` slots back; rows past ``n`` are padding
        (``PREFILL_MIN_M``) naming the first slot, never written back.
        Captured per (join size, bucket, sampled)."""
        pool = self._get_pool(bucket)

        def fn(toks, lens, idx, temp, topk, seed):
            caches, view = kvcache._reset_and_view(pool.caches,
                                                   pool._template, idx)
            hid = forward(self.cfg, self.params, tokens=toks, caches=view,
                          mode="full", return_hidden=True)
            tok = self._first_token(hid, lens, temp, topk, seed)
            kvcache._scatter_prefix(caches, view, idx[:n])
            return tok[:n]
        return fn

    def _prefill_call(self, bucket, toks, lens, slots, temp=None,  # holds: worker
                      topk=None, seed=None) -> np.ndarray:
        """Run the join's prefill; returns its first tokens (host)."""
        n = len(slots)
        with torch.inference_mode():
            first = self._graphs.run(
                ("cont_prefill", bucket, n, temp is not None),
                self._prefill_fn(bucket, n),
                *_pad_rows(self._prefill_rows(n, bucket), toks, lens,
                           np.asarray(slots, np.int64), temp, topk, seed))
            return first.cpu().numpy()

    def _segment_fn(self, bucket: int):  # holds: worker
        """One decode segment of ``decode_segment`` steps (JAX's
        ``_segment_fn``), over the pool's full slot batch, or with
        ``idx`` over the compacted view gathered from the pool's slots
        ``idx`` and scattered back (rows ``rows``) in the same program.
        Returns the tokens, emissions and state packed into one int32
        (width, 2 * n_steps + 5) tensor, copied to the host at once.
        Captured per (bucket, width, sampled)."""
        pool = self._get_pool(bucket)
        seg = self.ec.decode_segment

        def fn(tok, pos, active, budget, eos, temp, topk, seed, idx, rows):
            caches = (pool.caches if idx is None
                      else kvcache._take_slots(pool.caches, idx))
            toks, emits, st, caches = decode_segment(
                self.cfg, self.params, tok, pos, caches, n_steps=seg,
                active=active, budget=budget, eos_id=eos, temperature=temp,
                top_k=topk, seed=seed, head_w=self._head_w,
                decode_width=self.ec.max_batch)
            if idx is not None:
                kvcache._scatter_prefix(pool.caches, caches, idx, rows)
            i32 = torch.int32
            return torch.cat([toks, emits.to(i32), st["tok"], st["pos"],
                              st["active"].to(i32)[:, None],
                              st["budget"][:, None],
                              st["eos_hit"].to(i32)[:, None]], 1)
        return fn

    def _segment_call(self, bucket, width, rows, temp=None, topk=None,  # holds: worker
                      seed=None, *, slots=None):
        """Run a segment of ``width`` rows, ``rows`` = (tok, pos, active,
        budget, eos) host arrays in view order; ``slots`` (the live rows'
        home slots) compacts it. Returns host arrays (toks, emits,
        state) with state = {tok, pos, active, budget, eos_hit}."""
        seg = self.ec.decode_segment
        idx = srcs = None
        if slots is not None:
            occ = len(slots)
            idx = np.asarray(slots + [slots[0]] * (width - occ), np.int64)
            srcs = np.asarray(list(range(occ)) + [0] * (width - occ),
                              np.int64)
        kind = "cont_segment" if slots is None else "cont_compact"
        with torch.inference_mode():
            out = self._graphs.run(
                (kind, bucket, width, temp is not None),
                self._segment_fn(bucket), *rows, temp, topk, seed, idx,
                srcs).cpu().numpy()
        state = {"tok": out[:, 2 * seg], "pos": out[:, 2 * seg + 1],
                 "active": out[:, 2 * seg + 2].astype(bool),
                 "budget": out[:, 2 * seg + 3],
                 "eos_hit": out[:, 2 * seg + 4].astype(bool)}
        return out[:, :seg], out[:, seg:2 * seg].astype(bool), state

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
        if self.ec.mode == "decoder":
            t_serve = time.perf_counter()
            gen, emits, eos_hit = self._serve_decoder(toks, lens, bucket,
                                                      reqs)
            t_done = time.perf_counter()
            # prefill and decode are one serve here: prefill_s is 0 and
            # decode_s carries the whole serve, as in the JAX engine
            timings = [RequestTiming(queue_s=t_serve - r.t_submit,
                                     prefill_s=0.0,
                                     decode_s=t_done - t_serve)
                       for r in reqs]
            self._record_batch(reqs, [t for t, r in zip(timings, reqs)
                                      if r.handle is not None])
            for i, r in enumerate(reqs):
                if r.handle is None:          # warmup / raw-batch caller
                    r.future.set_result(gen[i])
                    continue
                row = np.asarray(gen[i][emits[i]], np.int32)
                if r.handle.cancel_requested:  # cancel landed mid-serve
                    reason = FINISH_CANCELLED
                else:
                    reason = FINISH_EOS if eos_hit[i] else FINISH_LENGTH
                r.handle._push(row)
                r.future.set_result(GenerationResult(
                    tokens=row, finish_reason=reason, timing=timings[i],
                    request_id=r.handle.request.request_id))
            return
        with torch.inference_mode():
            out = self._graphs.run(("enc", bucket, B), self._encoder_fn(),
                                   toks, mask)
            out = _tree_map(lambda t: t.cpu(), out)   # waits for the device
        # record samples BEFORE resolving futures: a client whose
        # .result() returns must find its sample in metrics()/window()
        self._record_batch(reqs)
        for i, r in enumerate(reqs):
            r.future.set_result(_tree_map(lambda x: x[i], out))

    def _record_batch(self, reqs: List[_Request],
                      timings=()) -> None:  # holds: worker
        now = time.perf_counter()
        with self._samples_lock:
            self.batch_sizes.append(len(reqs))
            self.latencies.extend(now - r.t_submit for r in reqs)
            self.timings.extend(timings)

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
    def _lane_stat(self, bucket: int) -> dict:  # holds: _samples_lock
        """Per-lane counters, with JAX's keys (the prefix-cache and
        speculative ones stay 0 until items 8 and 10)."""
        stat = self.lane_stats.get(bucket)
        if stat is None:
            stat = self.lane_stats[bucket] = {
                "decode_segments": 0, "occupancy_sum": 0, "joins": 0,
                "prefill_chunks": 0, "compact_segments": 0,
                "prefix_hits": 0, "prefix_misses": 0,
                "prefix_hit_tokens": 0, "prefix_inserts": 0,
                "prefix_evictions": 0,
                "spec_rounds": 0, "spec_proposed": 0, "spec_accepted": 0,
                "prefix_bytes": 0,   # gauges (see _LANE_GAUGES)
                "kv_bytes": 0,
                # segment width -> segments run at it; every tier exists
                # from the start, zero counts are dropped from the view
                "tier_hist": {w: 0 for w in self._tiers}}
        return stat

    def _jit_compiles(self) -> int:
        """Programs built on the serving path (``GraphCache.captures``):
        captured graphs on the card, distinct shapes on the CPU."""
        return self._graphs.captures

    # lane stats reported as current values, not window-diffed deltas
    _LANE_GAUGES = frozenset({"prefix_bytes", "kv_bytes"})

    @classmethod
    def _lane_view(cls, now: dict, prev: Optional[dict] = None) -> dict:
        """Lane counter dicts (optionally diffed against a window cursor)
        with the occupancy mean derived per span; ``tier_hist`` diffs per
        key, dropping keys that did not move; gauges pass through."""
        out = {}
        for bucket, stat in now.items():
            base = (prev or {}).get(bucket, {})
            d = {}
            for k, v in stat.items():
                if isinstance(v, dict):
                    sub = base.get(k, {})
                    d[k] = {w: c - sub.get(w, 0) for w, c in v.items()
                            if c - sub.get(w, 0)}
                elif k in cls._LANE_GAUGES:
                    d[k] = v
                else:
                    d[k] = v - base.get(k, 0)
            segs = d.get("decode_segments", 0)
            d["occupancy_mean"] = (d.pop("occupancy_sum", 0) / segs
                                   if segs else 0.0)
            prop = d.get("spec_proposed", 0)
            d["spec_accept_rate"] = (d.get("spec_accepted", 0) / prop
                                     if prop else 0.0)
            out[bucket] = d
        return out

    def _aggregate(self, latencies, batch_sizes, timings, stats) -> dict:
        """Reduce one span of serving samples to the metrics dict shape;
        the phase means appear once decoder requests have finished."""
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
        if timings:
            m["queue_wait_mean_s"] = float(
                np.mean([t.queue_s for t in timings]))
            m["prefill_mean_s"] = float(
                np.mean([t.prefill_s for t in timings]))
            m["decode_mean_s"] = float(
                np.mean([t.decode_s for t in timings]))
        if self.continuous_active:
            # batch_sizes holds per-segment occupancy in continuous mode
            m["batch_occupancy_mean"] = m["batch_size_mean"]
            m.update(stats)
        return m

    def metrics(self) -> dict:
        """Cumulative serving stats since engine start (or the last
        ``discard_samples``), plus the admission counters. With no
        completed requests the latency percentiles are None. Continuous
        engines also report per-lane counters under ``'lanes'`` and
        ``'jit_compiles'``."""
        with self._samples_lock:
            m = self._aggregate(list(self.latencies),
                                list(self.batch_sizes), list(self.timings),
                                dict(self._stats))
            lanes = self._lane_view(self.lane_stats)
        m["weight_bytes"] = self._weight_bytes
        if self.continuous_active:
            m["lanes"] = lanes
            m["jit_compiles"] = self._jit_compiles()
        if self._admission is not None:
            adm = self._admission.snapshot()   # consistent read under _lock
            m["admission_peak_queue"] = adm.queued_peak
            m["admission_wait_total_s"] = adm.wait_total_s
        return m

    def window(self) -> dict:
        """The same stats for the span since the previous ``window()`` call
        (or engine start), then start a new window. Counters and
        ``jit_compiles`` are diffed; a cursor beyond a sample list's
        length (the caller cleared it) restarts that list at the clear."""
        compiles = self._jit_compiles()
        with self._samples_lock:
            cur = self._win_cursor
            i_lat, i_bs, i_tim = (len(self.latencies), len(self.batch_sizes),
                                  len(self.timings))
            stats_now = dict(self._stats)
            lanes_now = {b: {k: (dict(v) if isinstance(v, dict) else v)
                             for k, v in s.items()}
                         for b, s in self.lane_stats.items()}

            def span(lst, start, stop):
                return lst[start if start <= stop else 0:stop]

            m = self._aggregate(span(self.latencies, cur["latencies"], i_lat),
                                span(self.batch_sizes, cur["batch_sizes"],
                                     i_bs),
                                span(self.timings, cur["timings"], i_tim),
                                {k: v - cur["stats"].get(k, 0)
                                 for k, v in stats_now.items()})
            self._win_cursor = {"latencies": i_lat, "batch_sizes": i_bs,
                                "timings": i_tim, "stats": stats_now,
                                "lanes": lanes_now,
                                "jit_compiles": compiles}
        m["weight_bytes"] = self._weight_bytes     # gauge, not diffed
        if self.continuous_active:
            m["lanes"] = self._lane_view(lanes_now, cur.get("lanes"))
            m["jit_compiles"] = compiles - cur.get("jit_compiles", 0)
        return m
