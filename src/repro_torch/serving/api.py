"""Typed request lifecycle for the serving engine (API v2): a copy of
``repro/serving/api.py``. The port's engine serves encoder mode only so
far; the decoder types are here for the decoder slice.

The paper's core finding is that *per-request* latency under concurrency
load decides whether a low-cost deployment is viable — so the engine's
public surface is request-centric, not token-array-centric:

    ``GenerationRequest`` (tokens + per-request ``SamplingParams``)
        -> ``engine.generate(...)`` -> ``RequestHandle``
        -> ``handle.result()`` -> ``GenerationResult``

``RequestHandle`` is future-compatible (``result``/``done``/``cancel``) and
additionally a thread-safe streaming iterator: ``for tok in handle`` yields
generated token ids as decode segments complete, long before the request
finishes. ``GenerationResult`` carries the finish reason and the per-phase
timing breakdown (queue wait / prefill / decode) that the paper's
wall-clock-only tables (Fig. 7, Tables 2-4) cannot see.
"""
from __future__ import annotations

import dataclasses
import queue
from concurrent.futures import CancelledError, Future
from threading import Event
from typing import Iterator, List, Optional, Protocol

import numpy as np

FINISH_LENGTH = "length"
FINISH_EOS = "eos"
FINISH_CANCELLED = "cancelled"


class HeadFn(Protocol):
    """Contract for ``ServingEngine``'s optional output head.

    Called on the engine's device as ``head_fn(params, hidden, mask)`` with
    the *full* parameter tree (not just the encoder's), the final hidden
    states ``(B, S, d_model)`` and the validity mask ``(B, S)`` (True on
    real, non-padding tokens); returns the per-request payload (a tensor,
    or a dict/tuple/list of tensors, with a leading batch axis).
    """

    def __call__(self, params, hidden, mask): ...


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request generation knobs.

    max_new_tokens: emission budget; None = the engine's default; must not
        exceed the engine's ``max_new_tokens`` (KV slots are sized for it).
    eos_id: stop token — the row retires as soon as it *emits* this id
        (the eos token is included in the output); None disables.
    temperature: 0.0 = greedy argmax; > 0 samples softmax(logits / T).
    top_k: restrict sampling to the k highest logits; None/0 disables.
    seed: PRNG seed for sampling. Tokens are drawn with a counter-based
        key (seed, absolute position), so a given (prompt, seed) is
        reproducible regardless of batching or segment boundaries.
    """
    max_new_tokens: Optional[int] = None
    eos_id: Optional[int] = None
    temperature: float = 0.0
    top_k: Optional[int] = None
    seed: int = 0

    def validate(self, engine_max_new_tokens: int) -> int:
        """Return the effective token budget, raising on bad params."""
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature}")
        if self.top_k is not None and self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 or None, got {self.top_k}")
        n = (engine_max_new_tokens if self.max_new_tokens is None
             else self.max_new_tokens)
        if n < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {n}")
        if n > engine_max_new_tokens:
            raise ValueError(
                f"max_new_tokens={n} exceeds the engine's limit "
                f"({engine_max_new_tokens}); KV slots are sized for it — "
                f"raise EngineConfig.max_new_tokens")
        return n


@dataclasses.dataclass(frozen=True)
class GenerationRequest:
    """A typed generation request: prompt tokens + how to decode them.

    tokens: 1-D int32 prompt ids. Must be non-empty and fit the engine's
        largest pad bucket (otherwise the handle resolves with
        ``ValueError`` / ``RequestTooLong`` — ``generate()`` itself never
        raises mid-burst).
    sampling: per-request ``SamplingParams`` (budget, stop token,
        temperature/top-k/seed); the default decodes greedily to the
        engine's ``max_new_tokens``.
    priority: admission order — higher-priority requests are admitted
        (and un-parked from the admission overflow queue) first; FIFO
        within a level. Does not preempt requests already decoding.
    request_id: optional caller tag, echoed on ``GenerationResult`` —
        the engine never interprets it.
    """
    tokens: np.ndarray
    sampling: SamplingParams = SamplingParams()
    priority: int = 0
    request_id: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class RequestTiming:
    """Per-phase latency breakdown (seconds) — the decomposition the
    paper's end-to-end ladder cannot observe. In batch-at-a-time mode
    prefill and decode are one fused dispatch, so ``prefill_s`` is 0 and
    ``decode_s`` carries the whole serve time."""
    queue_s: float
    prefill_s: float
    decode_s: float

    @property
    def total_s(self) -> float:
        return self.queue_s + self.prefill_s + self.decode_s


@dataclasses.dataclass(frozen=True)
class GenerationResult:
    """What a finished request resolves to (``handle.result()``).

    tokens: generated ids, prompt excluded (the eos token is included
        when ``finish_reason == 'eos'``; a cancelled request keeps the
        tokens it produced before the cancel took effect).
    finish_reason: ``'length'`` (budget exhausted) | ``'eos'`` |
        ``'cancelled'``.
    timing: the per-phase ``RequestTiming`` breakdown.
    request_id: echoed from the ``GenerationRequest``.
    """
    tokens: np.ndarray
    finish_reason: str
    timing: RequestTiming
    request_id: Optional[str] = None


_STREAM_END = object()


class RequestHandle:
    """Client-side view of one in-flight generation request.

    Future-compatible — ``result(timeout)`` blocks for the
    ``GenerationResult`` (raising the request's exception, e.g.
    ``RequestTooLong``), ``done()``/``cancelled()``/``add_done_callback``
    delegate to the underlying future — plus a thread-safe streaming
    iterator: ``for tok in handle`` yields token ids as the engine
    completes decode segments (single consumer; iterating from several
    threads splits the stream between them). The iterator ends when the
    request finishes or is cancelled, and re-raises the request's
    exception if it failed.
    """

    def __init__(self, request: GenerationRequest, future: Future):
        self.request = request            # guarded-by: init
        self.future = future              # guarded-by: threadsafe
        self._stream: "queue.Queue" = queue.Queue()  # guarded-by: threadsafe
        self._cancel = Event()            # guarded-by: threadsafe
        future.add_done_callback(lambda _f: self._stream.put(_STREAM_END))

    # ---------------------------------------------------- future protocol
    def result(self, timeout: Optional[float] = None) -> GenerationResult:
        return self.future.result(timeout)

    def exception(self, timeout: Optional[float] = None):
        return self.future.exception(timeout)

    def done(self) -> bool:
        return self.future.done()

    def cancelled(self) -> bool:
        return self.future.cancelled() or (
            self.future.done() and not self.future.exception()
            and self.future.result().finish_reason == FINISH_CANCELLED)

    def add_done_callback(self, fn) -> None:
        self.future.add_done_callback(fn)

    def cancel(self) -> bool:
        """Cancel the request. Before it starts running this resolves the
        future as cancelled; mid-decode it flags the row, which the
        scheduler retires at the next segment boundary with
        ``finish_reason='cancelled'`` (partial tokens preserved; for the
        batch-at-a-time worker the whole serve is one segment, so the
        result carries its full output under that reason). Returns True
        unless the request already finished."""
        self._cancel.set()
        if self.future.cancel():
            return True
        return not self.future.done()

    @property
    def cancel_requested(self) -> bool:
        return self._cancel.is_set()

    # ---------------------------------------------------------- streaming
    def _push(self, tokens) -> None:
        """Engine-side: publish a completed segment's tokens."""
        for t in tokens:
            self._stream.put(int(t))

    def __iter__(self) -> Iterator[int]:
        while True:
            item = self._stream.get()
            if item is _STREAM_END:
                # re-arm the sentinel: later (or concurrent) iterations
                # must also terminate instead of blocking forever
                self._stream.put(_STREAM_END)
                break
            yield item
        if self.future.done() and not self.future.cancelled():
            exc = self.future.exception()
            if exc is not None:
                raise exc

    def stream(self) -> Iterator[int]:
        """Alias for ``iter(handle)``."""
        return iter(self)


def collect(handles: List[RequestHandle], timeout: Optional[float] = None
            ) -> List[GenerationResult]:
    """Gather results for a list of handles (CancelledError -> None)."""
    out = []
    for h in handles:
        try:
            out.append(h.result(timeout))
        except CancelledError:
            out.append(None)
    return out
