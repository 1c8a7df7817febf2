"""One captured program per shape: the port's counterpart of ``jax.jit``
in the serving engine.

The JAX engine compiles each serving function once per shape
(``repro/serving/engine.py``: the encoder forward per bucket, a batch's
prefill-and-decode scan, the continuous prefill and segment) and then
dispatches the whole function at once. Here ``GraphCache.run(key, fn,
*args)`` does the same with ``torch.cuda.CUDAGraph``s: the first call for
a ``key`` copies ``args`` into static device buffers, runs ``fn`` on them
once on a side stream (PyTorch's warm-up rule: lazy library
initialisation and the kernels' one-time attributes happen outside the
capture; that run's result is the call's result), then captures ``fn``
on the same buffers into a graph drawn from one memory pool shared by
every graph of the cache (``torch.cuda.graph_pool_handle()``). Every
later call copies ``args`` into the buffers and replays the graph. A
capture that fails raises: nothing falls back to running eagerly on the
card.

``fn`` must read its inputs only through its arguments (device tensors,
or None) and the tensors it closes over (weights, the KV pool), which
must keep their storage between calls: a replay reads and writes the
addresses seen at capture. Its results are the graph's static outputs,
overwritten by the next replay of the same key, so the caller copies
them out first.

On the CPU (the tests, ``device="cpu"``) ``fn`` runs eagerly on the
given arguments: the plain path, taken because the caller asked for the
CPU. The key is recorded all the same, so ``captures`` counts the
programs the engine built on either device; the engine reports it as
``metrics()["jit_compiles"]``.

The kernels' launch counters (``flash_attention.launches``, ...) count
Python calls of their wrappers, and a replay makes none. So each graph
keeps the launches its capture recorded: they are taken back off the
counters at capture (nothing ran) and added again at every replay.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, Optional

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.int8_matmul import cache_matmul, int8_matmul
from repro_torch.kernels.rglru_scan import rglru_scan

# every wrapper that counts its launches (K1, K2, K3, K4, K5)
KERNELS = (flash_attention, decode_attention, int8_matmul, cache_matmul,
           rglru_scan)


def _launches():
    return [k.launches for k in KERNELS]


def _to_static(a, device):
    return None if a is None else torch.as_tensor(a).to(device, copy=True)


class _Graph:
    __slots__ = ("graph", "inputs", "outputs", "launches")

    def __init__(self, graph, inputs, outputs, launches):
        self.graph = graph          # torch.cuda.CUDAGraph
        self.inputs = inputs        # static input buffers (tuple)
        self.outputs = outputs      # static outputs of the capture
        self.launches = launches    # kernel launches of one replay


class GraphCache:
    """Captured programs of one engine, keyed by shape. Used from the
    engine's worker thread only."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.captures = 0
        self.replays = 0
        self._graphs: Dict[Hashable, Optional[_Graph]] = {}
        self._pool = None
        self._side = None           # the warm-up stream, one per cache

    @property
    def eager(self) -> bool:
        return self.device.type != "cuda"

    def __contains__(self, key) -> bool:
        return key in self._graphs

    def run(self, key: Hashable, fn: Callable, *args):
        """``fn(*args)``: eagerly on the CPU, else through the graph
        captured for ``key`` (captured on the first call). ``args`` are
        tensors on either device, numpy arrays, or None; a key must
        always come with the same argument shapes, dtypes and Nones."""
        if self.eager:
            if key not in self._graphs:
                self._graphs[key] = None
                self.captures += 1
            return fn(*(None if a is None
                        else torch.as_tensor(a, device=self.device)
                        for a in args))
        g = self._graphs.get(key)
        if g is None:
            out = self._warm_and_capture(key, fn, args)
            self.captures += 1
            return out
        for buf, a in zip(g.inputs, args):
            if buf is not None:
                buf.copy_(torch.as_tensor(a), non_blocking=False)
        g.graph.replay()
        self.replays += 1
        for k, n in zip(KERNELS, g.launches):
            k.launches += n
        return g.outputs

    def _warm_and_capture(self, key, fn, args):
        """Copy ``args`` into static buffers, run ``fn`` on them once on
        a side stream (its result is returned), then capture it on the
        same buffers. The launches counted while capturing are taken back
        off the counters and kept with the graph."""
        inputs = tuple(_to_static(a, self.device) for a in args)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        stream = self._side
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            out = fn(*inputs)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = _launches()
        # thread_local: client threads may use the card while the worker
        # captures
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            outputs = fn(*inputs)
        launches = [a - b for a, b in zip(_launches(), before)]
        for k, n in zip(KERNELS, launches):
            k.launches -= n
        self._graphs[key] = _Graph(graph, inputs, outputs, launches)
        return out
