"""The port's continuous decoder (lanes over the KV pool, adaptive width
tiers) against the JAX package's continuous engine, on the CPU.

Both engines serve the Qwen2 smoke model (fp32, weights initialized in
JAX and bridged through numpy) with the default decoder config
(``continuous``, ``use_cache_pool``, ``segment_width="adaptive"``),
``pad_buckets=(16, 32)``, ``max_batch=4``, ``max_new_tokens=6`` and
segments of 2 steps: greedy, sampled, budget-capped and eos-stopped
requests across both buckets must come back with the same tokens and
finish reasons, and the port's adaptive, fixed-width and batch-at-a-time
engines with the same tokens as each other. The lane and tier counters
and the ``metrics()``/``window()`` keys are JAX's; ``warmup()`` leaves a
measured window that builds no program; the hybrid smoke config and
int8 weights and KV go through the pool. The graph cache's keying and
capture count are checked with the capture stubbed out; the captured
programs themselves run only on the card. JAX is imported in a fixture.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving import graphs
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.graphs import GraphCache

requires_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                   reason="captured programs need the card")

BASE = dict(mode="decoder", max_batch=4, max_new_tokens=6,
            pad_buckets=(16, 32), decode_segment=2)
SAMPLING = [dict(), dict(temperature=0.8, top_k=20, seed=3),
            dict(max_new_tokens=3), dict(eos_id=None),
            dict(temperature=1.0, seed=9), dict()]


def _cfg(name):
    return dataclasses.replace(get_config(name, smoke=True), dtype="float32")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_get_config
    from repro.models import init_params as jax_init_params
    from repro.serving import EngineConfig as JaxEngineConfig
    from repro.serving import ServingEngine as JaxServingEngine
    from repro.serving.api import SamplingParams as JaxSamplingParams

    def model(name):
        jcfg = dataclasses.replace(jax_get_config(name, smoke=True),
                                   dtype="float32")
        p = jax_init_params(jcfg, jax.random.PRNGKey(0))
        return jcfg, p, to_torch(jax.tree.map(np.asarray, p), device="cpu")
    return dict(model=model, Engine=JaxServingEngine,
                EngineConfig=JaxEngineConfig, Sampling=JaxSamplingParams)


@pytest.fixture(scope="module")
def qwen(jx):
    return jx["model"]("qwen2-0.5b")


def _prompts(cfg, n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1)))
            for _ in range(n)]


def _serve(eng, prompts, sampling, warm=False):
    """Serve on ``eng`` (closed afterwards): (results, metrics, the
    measured window)."""
    try:
        if warm:
            eng.warmup(sampled=True)
            eng.window()
        handles = [eng.generate(p, s) for p, s in zip(prompts, sampling)]
        results = [h.result(timeout=300) for h in handles]
        return results, eng.metrics(), eng.window()
    finally:
        eng.close()


def _port(cfg, params, **kw):
    return ServingEngine(cfg, params, EngineConfig(**dict(BASE, **kw)),
                         device="cpu")


def _jax(jx, jcfg, jparams, **kw):
    return jx["Engine"](jcfg, jparams, jx["EngineConfig"](**dict(BASE, **kw)))


def _load(jx, cfg, jcfg, jparams, n=12, **kw):
    """Prompts over both buckets and their sampling, with eos ids that
    the JAX greedy streams reach."""
    prompts = (_prompts(cfg, n // 2, 3, 16, seed=1)
               + _prompts(cfg, n - n // 2, 17, 30, seed=2))
    sampling = [dict(SAMPLING[i % len(SAMPLING)]) for i in range(n)]
    greedy, _, _ = _serve(_jax(jx, jcfg, jparams, **kw), prompts,
                          [jx["Sampling"]()] * n)
    for i, sp in enumerate(sampling):
        if "eos_id" in sp:
            sampling[i] = dict(eos_id=int(greedy[i].tokens[2]))
    return prompts, sampling


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.tokens, y.tokens)
        assert x.finish_reason == y.finish_reason


# ------------------------------------------------------------ graph cache
def test_graph_cache_keys_and_counter_on_the_cpu():
    """On the CPU a function runs eagerly on its arguments (numpy arrays
    become tensors); each new key counts once."""
    gc = GraphCache("cpu")
    assert gc.eager
    seen = []

    def fn(a, b):
        seen.append((type(a), b))
        return a * 2
    out = gc.run(("k", 1), fn, np.arange(3), None)
    assert torch.equal(out, torch.tensor([0, 2, 4]))
    gc.run(("k", 1), fn, np.arange(3), None)
    assert gc.captures == 1 and ("k", 1) in gc
    gc.run(("k", 2), fn, np.arange(2), None)
    assert gc.captures == 2 and gc.replays == 0
    assert seen == [(torch.Tensor, None)] * 3


def test_graph_cache_replays_and_counts_launches(monkeypatch):
    """With the capture stubbed out (the test's stand-in for the card):
    the first call of a key captures once and returns the warm-up result;
    later calls copy their arguments into the static buffers, replay, add
    the launches the capture recorded to the kernel counters, and return
    the static outputs."""
    gc = GraphCache("cuda")
    assert not gc.eager
    replays = []

    class FakeGraph:
        def __init__(self, fn, inputs, outputs):
            self.fn, self.inputs, self.outputs = fn, inputs, outputs

        def replay(self):
            replays.append(1)
            self.outputs.copy_(self.fn(*self.inputs))

    def capture(self, key, fn, args):
        inputs = tuple(torch.as_tensor(a).clone() for a in args)
        out = fn(*inputs)
        self._graphs[key] = graphs._Graph(FakeGraph(fn, inputs, out.clone()),
                                          inputs, None, [2, 0, 0, 0, 0])
        self._graphs[key].outputs = self._graphs[key].graph.outputs
        return out
    monkeypatch.setattr(GraphCache, "_warm_and_capture", capture)
    before = flash_attention.launches

    def fn(a):
        return a + 1
    assert torch.equal(gc.run("x", fn, np.array([1, 2])),
                       torch.tensor([2, 3]))
    assert gc.captures == 1 and not replays
    assert flash_attention.launches == before
    assert torch.equal(gc.run("x", fn, np.array([5, 6])),
                       torch.tensor([6, 7]))
    assert gc.captures == 1 and gc.replays == 1 and replays == [1]
    assert flash_attention.launches == before + 2
    gc.run("y", fn, np.array([0]))
    assert gc.captures == 2
    flash_attention.launches = before


# ------------------------------------------------------ against the JAX
def test_tokens_equal_the_jax_continuous_engine(jx, qwen):
    """Greedy, sampled, budget-capped and eos-stopped requests over both
    buckets: the port's continuous engine gives the JAX continuous
    engine's tokens and finish reasons, and its fixed-width and
    batch-at-a-time engines give the same tokens."""
    jcfg, jparams, params = qwen
    cfg = _cfg("qwen2-0.5b")
    prompts, sampling = _load(jx, cfg, jcfg, jparams)
    want, jm, jw = _serve(_jax(jx, jcfg, jparams), prompts,
                          [jx["Sampling"](**s) for s in sampling])
    sp = [SamplingParams(**s) for s in sampling]
    got, m, w = _serve(_port(cfg, params), prompts, sp)
    _same(got, want)
    reasons = [g.finish_reason for g in got]
    assert "eos" in reasons and "length" in reasons
    for kw in (dict(segment_width="fixed"), dict(continuous=False),
               dict(multi_lane=False)):
        other, _, _ = _serve(_port(cfg, params, **kw), prompts, sp)
        _same(other, got)
    # the JAX engine's keys, lane by lane
    for a, b in ((m, jm), (w, jw)):
        assert set(a) == set(b)
        assert set(a["lanes"]) == set(b["lanes"]) == {16, 32}
        for lane in a["lanes"]:
            assert set(a["lanes"][lane]) == set(b["lanes"][lane])
    assert m["requests"] == 12 and m["decode_segments"] > 0
    assert all(g.timing.total_s >= g.timing.decode_s >= 0 for g in got)


def test_lane_and_tier_counters_equal_jax(jx, qwen):
    """One request alone, then three more into the same lane: the
    segments, the joins, the prefill batches and the width histogram are
    the JAX engine's (the port serves the requests in the same order)."""
    jcfg, jparams, params = qwen
    cfg = _cfg("qwen2-0.5b")
    prompts = _prompts(cfg, 4, 3, 14, seed=5)
    out = {}
    for name, make, samp in (
            ("jax", lambda: _jax(jx, jcfg, jparams), jx["Sampling"]),
            ("port", lambda: _port(cfg, params), SamplingParams)):
        eng = make()
        try:
            first = eng.generate(prompts[0], samp()).result(timeout=300)
            w1 = eng.window()
            rest = [h.result(timeout=300) for h in
                    [eng.generate(p, samp()) for p in prompts[1:]]]
            w2 = eng.window()
        finally:
            eng.close()
        out[name] = ([first] + rest, w1, w2)
    (jr, jw1, jw2), (tr, tw1, tw2) = out["jax"], out["port"]
    _same(tr, jr)
    for tw, jw in ((tw1, jw1), (tw2, jw2)):
        for key in ("decode_segments", "prefill_batches", "requests"):
            assert tw[key] == jw[key], key
        for key in ("decode_segments", "compact_segments", "tier_hist",
                    "kv_bytes"):
            assert tw["lanes"][16][key] == jw["lanes"][16][key], key
    assert tw1["lanes"][16]["tier_hist"] == {1: tw1["decode_segments"]}
    assert tw1["lanes"][16]["kv_bytes"] > 0


def test_warmup_leaves_a_compile_clean_window(qwen):
    """``warmup(sampled=True)`` builds every program a greedy or sampled
    load over both buckets can hit: the measured window builds none. The
    count is the prefill per join size, the full-width segment and one
    compacted segment per tier below max_batch, per bucket, greedy and
    sampled."""
    _, _, params = qwen
    cfg = _cfg("qwen2-0.5b")
    eng = _port(cfg, params)
    try:
        assert eng.metrics()["jit_compiles"] == 0
        eng.warmup(sampled=True)
        assert eng.metrics()["jit_compiles"] == 2 * 2 * (4 + 1 + 2)
        assert eng.window()["requests"] == 0
        prompts = _prompts(cfg, 6, 3, 30, seed=6)
        sp = [SamplingParams(temperature=0.5, seed=i) if i % 2 else
              SamplingParams() for i in range(6)]
        [h.result(timeout=300) for h in
         [eng.generate(p, s) for p, s in zip(prompts, sp)]]
        w = eng.window()
        assert w["jit_compiles"] == 0 and w["requests"] == 6
        with pytest.raises(RuntimeError, match="before serving"):
            eng.warmup()
    finally:
        eng.close()


def test_hybrid_through_the_pool_equals_jax(jx):
    """RecurrentGemma's local-attention rings and recurrent states go
    through the lanes' pools: the JAX continuous engine's tokens."""
    jcfg, jparams, params = jx["model"]("recurrentgemma-9b")
    cfg = _cfg("recurrentgemma-9b")
    prompts = (_prompts(cfg, 3, 3, 16, seed=7)
               + _prompts(cfg, 3, 17, 30, seed=8))
    sampling = [dict(), dict(temperature=0.7, seed=2), dict()] * 2
    want, _, _ = _serve(_jax(jx, jcfg, jparams), prompts,
                        [jx["Sampling"](**s) for s in sampling])
    got, _, _ = _serve(_port(cfg, params), prompts,
                       [SamplingParams(**s) for s in sampling])
    _same(got, want)


def test_int8_weights_and_kv_through_the_pool_equal_jax(jx, qwen):
    """``weight_quant`` and ``kv_quant`` "int8" on the lanes and width
    tiers (the slot gathers and scatters carry the scale planes): the JAX
    continuous engine's tokens, adaptive and fixed."""
    jcfg, jparams, params = qwen
    cfg = _cfg("qwen2-0.5b")
    q = dict(weight_quant="int8", kv_quant="int8")
    prompts = (_prompts(cfg, 4, 3, 16, seed=9)
               + _prompts(cfg, 3, 17, 30, seed=10))
    sampling = [dict(), dict(temperature=0.9, top_k=10, seed=4)] * 3 + [{}]
    want, _, _ = _serve(_jax(jx, jcfg, jparams, **q), prompts,
                        [jx["Sampling"](**s) for s in sampling])
    sp = [SamplingParams(**s) for s in sampling]
    for kw in ({}, dict(segment_width="fixed")):
        got, m, _ = _serve(_port(cfg, params, **q, **kw), prompts, sp)
        _same(got, want)
        assert all(lane["kv_bytes"] > 0 for lane in m["lanes"].values()
                   if lane["decode_segments"])


def test_engine_decodes_at_its_max_batch_split_count(monkeypatch):
    """Every decode step of the continuous engine (its compacted tiers
    included) and of the batch-at-a-time one asks K2 for the split count of
    ``max_batch`` rows, so a row's bits do not follow its segment's
    width."""
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    seen = []
    plain = ops.gqa_decode

    def record(q, *args, width=None, **kw):
        seen.append((q.shape[0], width))
        return plain(q, *args, width=width, **kw)
    monkeypatch.setattr(ops, "gqa_decode", record)
    cfg = _cfg("qwen2-0.5b")
    params = init_params(cfg, 0, device="cpu")
    prompts = _prompts(cfg, 5, 3, 30, seed=13)
    for kw in ({}, dict(continuous=False)):
        seen.clear()
        eng = _port(cfg, params, **kw)
        try:
            eng.generate(prompts[0]).result(timeout=300)
            [h.result(timeout=300) for h in
             [eng.generate(p) for p in prompts]]
        finally:
            eng.close()
        assert seen and {w for _, w in seen} == {BASE["max_batch"]}
        if not kw:                      # the compacted tiers
            assert min(b for b, _ in seen) < BASE["max_batch"]


# --------------------------------------------------------------- the card
class _Uncaptured(GraphCache):
    """The engine's graph cache calling each program eagerly on the card:
    the same functions on the same padded shapes, uncaptured."""
    eager = property(lambda self: True)


@requires_cuda
def test_captured_continuous_engine_equals_eager_on_cuda():
    """On the card the continuous engine's programs are captured CUDA
    graphs: greedy and sampled requests, one at a time and staggered,
    come back with the tokens of the same engine whose programs are
    called eagerly (uncaptured, at the same padded shapes), and later
    requests replay the programs the first ones captured. The smoke
    config widened to Qwen2's head dim of 64, which the kernels take."""
    cfg = dataclasses.replace(_cfg("qwen2-0.5b"), d_model=896)
    from repro_torch.models import init_params
    params = init_params(cfg, 0, device="cuda")
    prompts = _prompts(cfg, 6, 3, 30, seed=11)
    sampling = [SamplingParams(**s) for s in SAMPLING]
    outs = {}
    for name in ("captured", "eager"):
        eng = ServingEngine(cfg, params, EngineConfig(**BASE),
                            device="cuda")
        if name == "eager":
            eng._graphs = _Uncaptured("cuda")
        try:
            one = [eng.generate(p, s).result(timeout=300).tokens
                   for p, s in zip(prompts, sampling)]
            both = [h.result(timeout=300).tokens for h in
                    [eng.generate(p, s) for p, s in zip(prompts, sampling)]]
            outs[name] = one + both
            if name == "captured":
                assert eng._graphs.replays > 0
        finally:
            eng.close()
    for a, b in zip(outs["captured"], outs["eager"]):
        np.testing.assert_array_equal(a, b)
