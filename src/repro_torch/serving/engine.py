"""MLaaS serving engine: the PyTorch stand-in for the paper's Nginx +
Flask + GECToR stack (Fig. 6).

Port of ``repro/serving/engine.py`` in two modes:
  * 'encoder': one bidirectional forward per request batch (GECToR);
    ``submit(tokens)`` resolves to the head's payload for the request.
  * 'decoder', batch at a time (``continuous=False,
    use_cache_pool=False``): ``generate(request)`` returns a
    ``RequestHandle`` that resolves to a ``GenerationResult``.

A background worker drains the queue into batches (up to ``max_batch``,
waiting at most ``batch_window_ms``) and pads each batch to the smallest
pad bucket that fits its longest request. Encoder mode runs one forward
on the device (K1 for attention on the card). Decoder mode allocates
fp32 caches for the batch, prefills them (K1, causal), takes each row's
first token from the logits at its last real position, and runs
``decode_segment`` for the remaining ``max_new_tokens - 1`` steps (K2 for
attention on the card); the host then cuts each row at its budget or its
first eos. Every request's result is copied to the host before its future
resolves. An optional ``AdmissionQueue`` bounds in-flight work (the
paper's proposed §4 mitigation): submit try-acquires a slot and, when
saturated, parks the request on a priority-ordered overflow queue; a
finishing request hands its slot to the best parked one. With
``weight_quant="int8"`` the engine quantizes the tree once at init and
every projection runs K3; with ``kv_quant="int8"`` (decoder mode) the
caches hold int8 K/V with fp32 scale planes; both for the plain
``("attn",)`` stack only. The decoder serves the RecurrentGemma hybrid
too: its caches hold local-attention rings of ``min(bucket +
max_new_tokens, window)`` slots and the RG-LRU blocks' recurrent states,
and its prefill runs the scan through K5. The KV pool and the continuous
scheduler are not ported yet and raise.
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
from repro_torch.serving.api import (FINISH_CANCELLED, FINISH_EOS,
                                     FINISH_LENGTH, GenerationRequest,
                                     GenerationResult, HeadFn,
                                     RequestHandle, RequestTiming,
                                     SamplingParams)
from repro_torch.serving.scheduler import AdmissionQueue, RequestQueue


class RequestTooLong(ValueError):
    """Raised (into the request's future) when a request exceeds the largest
    pad bucket — rejecting beats the silent truncation it replaces."""


@dataclasses.dataclass
class EngineConfig:
    """The JAX engine's knobs, with the same defaults. Both modes read
    mode, max_batch, batch_window_ms, pad_buckets and max_inflight; the
    batch-at-a-time decoder also reads max_new_tokens and use_scan_decode
    (no jit stands behind it here: both values run the one decode loop,
    which gives the tokens the JAX engine's two paths give). The
    continuous decoder's knobs belong to ROADMAP Queue 1 items 6-10: the
    decoder runs only with ``continuous=False, use_cache_pool=False`` and
    the features that need the continuous path raise, as in JAX.
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


def _check_config(ec: EngineConfig) -> None:
    if ec.mode not in ("encoder", "decoder"):
        raise ValueError(f"mode must be 'encoder' or 'decoder', got "
                         f"{ec.mode!r}")
    if ec.mode == "decoder" and (ec.continuous or ec.use_cache_pool):
        raise NotImplementedError(
            "mode='decoder' runs batch at a time here (continuous=False, "
            "use_cache_pool=False); the KV cache pool and the continuous "
            "scheduler are ROADMAP Queue 1 item 6")
    # the JAX engine's quantization errors
    if ec.weight_quant not in (None, "int8"):
        raise ValueError(f"weight_quant must be None or 'int8', got "
                         f"{ec.weight_quant!r}")
    validate_kv_quant(ec.kv_quant)
    if ec.kv_quant and ec.mode != "decoder":
        raise ValueError("kv_quant requires mode='decoder' (the KV "
                         "cache only exists on the decode path)")
    # the JAX engine's errors: both features need the continuous path
    for name in ("prefix_cache", "spec_decode"):
        if getattr(ec, name):
            raise ValueError(
                f"{name} requires the continuous decoder path "
                f"(mode='decoder', continuous/use_scan_decode/"
                f"use_cache_pool all on)")
    if ec.segment_width not in ("adaptive", "fixed"):
        raise ValueError(f"segment_width must be 'adaptive' or 'fixed', "
                         f"got {ec.segment_width!r}")


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
        # the continuous decoder is ROADMAP Queue 1 item 6: never active yet
        self.continuous_active = False    # guarded-by: init
        self._q: "queue.Queue[_Request]" = queue.Queue()  # guarded-by: threadsafe
        self._admission = (AdmissionQueue(engine_cfg.max_inflight)  # guarded-by: threadsafe
                           if engine_cfg.max_inflight else None)
        # samples the worker appends and clients read (metrics/window)
        self._samples_lock = threading.Lock()     # guarded-by: threadsafe
        self.latencies: List[float] = []          # guarded-by: _samples_lock
        self.batch_sizes: List[int] = []          # guarded-by: _samples_lock
        self.timings: List[RequestTiming] = []    # guarded-by: _samples_lock
        self._win_cursor = {"latencies": 0,       # guarded-by: _samples_lock
                            "batch_sizes": 0, "timings": 0}
        self._stop = threading.Event()            # guarded-by: threadsafe
        # reentrant: a done-callback attached under the lock can fire
        # synchronously (future cancelled in the attach window) and re-enter
        self._submit_lock = threading.RLock()  # guarded-by: threadsafe — orders submit vs close
        self._overflow = RequestQueue()        # guarded-by: _submit_lock — admission overflow
        self._parked_cancelled = 0             # guarded-by: _submit_lock — phantoms in heap
        self._worker = threading.Thread(target=self._run, daemon=True)  # guarded-by: init
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

    def warmup(self, batch_sizes=None, *, buckets=None) -> None:
        """Serve one synthetic batch per (bucket, batch size) — default
        every pad bucket x ``1..max_batch`` — through the serve path of
        either mode, so the first measured request pays no first-use cost
        (kernel build and load, library handles, allocator growth). The
        batches count into ``metrics()``; call ``discard_samples()``
        afterwards to drop them."""
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
            self.timings.clear()
            self._win_cursor = {"latencies": 0, "batch_sizes": 0,
                                "timings": 0}

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

    def _decode_batch(self, toks, lens, temp, topk, seed):  # holds: worker
        """Prefill -> each row's first token from the logits at its last
        real position -> ``decode_segment`` over the remaining steps, on
        fresh caches of ``bucket + max_new_tokens`` slots, fp32 or, with
        ``kv_quant``, int8 (the JAX engine's layout). Only the last real position of each row goes
        through the head: the same values per row as JAX's full
        (B, bucket, vocab) logits, without them. ``temp``/``topk``/``seed``
        are None for an all-greedy batch. Returns int32 (B, T) on the
        device."""
        cfg, params, T = self.cfg, self.params, self.ec.max_new_tokens
        B, bucket = toks.shape
        caches = make_caches(cfg, B, bucket + T, dtype=torch.float32,
                             kv_quant=self.ec.kv_quant, device=self.device)
        hid = forward(cfg, params, tokens=toks, caches=caches, mode="full",
                      return_hidden=True)
        last = hid[torch.arange(B, device=self.device), lens - 1][:, None]
        head_w = head_weight(cfg, params.get("lm_head"), params["embed"])
        logits = lm_head_apply(cfg, None, last, w=head_w)[:, 0]
        tok = sample_logits(logits, temperature=temp, top_k=topk, seed=seed,
                            positions=lens)[:, None]
        if T == 1:
            return tok
        rest, _, _, _ = decode_segment(cfg, params, tok, lens[:, None],
                                       caches, n_steps=T - 1,
                                       temperature=temp, top_k=topk,
                                       seed=seed, head_w=head_w)
        return torch.cat([tok, rest], dim=1)

    def _serve_decoder(self, toks, lens, reqs):  # holds: worker
        """Batch-at-a-time decode. Returns (gen (B, T), emits (B, T) bool,
        eos_hit (B,) bool) on the host — emits marks each row's kept
        prefix (its budget / first-eos trim)."""
        temp, topk, seed, eos, budget, any_sample = \
            self._sampling_arrays(reqs)
        dev = self.device
        sargs = ((torch.from_numpy(temp).to(dev),
                  torch.from_numpy(topk).to(dev),
                  torch.from_numpy(seed).to(dev)) if any_sample
                 else (None, None, None))
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        with torch.inference_mode():
            gen = self._decode_batch(torch.from_numpy(toks).to(dev), lens_t,
                                     *sargs).cpu().numpy()
        emits, eos_hit = _trim_host(gen, eos, budget)
        return gen, emits, eos_hit

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
            gen, emits, eos_hit = self._serve_decoder(toks, lens, reqs)
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
            out = self._encode(torch.from_numpy(toks).to(self.device),
                               torch.from_numpy(mask).to(self.device))
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
    @staticmethod
    def _aggregate(latencies, batch_sizes, timings) -> dict:
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
        return m

    def metrics(self) -> dict:
        """Cumulative serving stats since engine start (or the last
        ``discard_samples``), plus the admission counters. With no
        completed requests the latency percentiles are None."""
        with self._samples_lock:
            m = self._aggregate(list(self.latencies),
                                list(self.batch_sizes), list(self.timings))
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
            i_lat, i_bs, i_tim = (len(self.latencies), len(self.batch_sizes),
                                  len(self.timings))
            m = self._aggregate(self.latencies[cur["latencies"]:i_lat],
                                self.batch_sizes[cur["batch_sizes"]:i_bs],
                                self.timings[cur["timings"]:i_tim])
            self._win_cursor = {"latencies": i_lat, "batch_sizes": i_bs,
                                "timings": i_tim}
        m["weight_bytes"] = self._weight_bytes     # gauge, not diffed
        return m
