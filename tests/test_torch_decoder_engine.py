"""The port's decoder-mode ServingEngine (batch at a time) against the JAX
engine, on the CPU.

Both engines serve the Qwen2 smoke model (fp32, weights initialized in
JAX and bridged through numpy) with ``continuous=False,
use_cache_pool=False``, ``pad_buckets=(16, 32)`` and ``max_new_tokens=4``:
greedy, sampled, budget-capped and eos-stopped requests must come back
with identical tokens and finish reasons. The config gates, the ``submit``
shim, ``use_scan_decode``, the metrics keys and the handle's errors are
checked too. JAX is imported in a fixture.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import (decode_segment, forward, make_caches,
                                sample_logits)
from repro_torch.serving import EngineConfig, RequestTooLong, ServingEngine
from repro_torch.serving.api import GenerationRequest, SamplingParams

CFG = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                          dtype="float32")
DECODER = dict(mode="decoder", continuous=False, use_cache_pool=False,
               pad_buckets=(16, 32), max_new_tokens=4, max_batch=8)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_get_config
    from repro.models import init_params as jax_init_params
    from repro.serving import EngineConfig as JaxEngineConfig
    from repro.serving import ServingEngine as JaxServingEngine
    from repro.serving.api import SamplingParams as JaxSamplingParams
    jcfg = dataclasses.replace(jax_get_config("qwen2-0.5b", smoke=True),
                               dtype="float32")
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return dict(jax=jax, cfg=jcfg, params=params, Engine=JaxServingEngine,
                EngineConfig=JaxEngineConfig, Sampling=JaxSamplingParams)


@pytest.fixture(scope="module")
def params(jx):
    return to_torch(jx["jax"].tree.map(np.asarray, jx["params"]),
                    device="cpu")


def _engine(params, **kw):
    return ServingEngine(CFG, params, EngineConfig(**dict(DECODER, **kw)),
                         device="cpu")


def _prompts(n, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, int(rng.integers(lo, hi + 1)))
            for _ in range(n)]


def _serve(make, prompts, sampling):
    eng = make()
    try:
        handles = [eng.generate(p, s) for p, s in zip(prompts, sampling)]
        results = [h.result(timeout=300) for h in handles]
        return results, eng.metrics(), eng.window(), eng.window()
    finally:
        eng.close()


SAMPLING = [dict(), dict(temperature=0.8, top_k=50, seed=3),
            dict(temperature=1.0, seed=9), dict(max_new_tokens=2),
            dict(eos_id=None), dict(temperature=0.5, top_k=5, seed=1,
                                    max_new_tokens=3)]


def test_tokens_and_finish_reasons_equal_the_jax_engine(jx, params):
    """Greedy, sampled, budget-capped and eos-stopped rows in two buckets
    (a wave per bucket); the eos ids are tokens the JAX greedy streams
    reach."""
    prompts = _prompts(6, 3, 16, seed=1) + _prompts(6, 17, 30, seed=2)
    sampling = SAMPLING + SAMPLING
    jax_engine = lambda: jx["Engine"](jx["cfg"], jx["params"],  # noqa: E731
                                      jx["EngineConfig"](**DECODER))
    # first pass: greedy streams, to pick eos ids that the streams reach
    greedy, _, _, _ = _serve(jax_engine, prompts,
                             [jx["Sampling"]()] * len(prompts))
    for i, sp in enumerate(sampling):
        if "eos_id" in sp:
            sampling[i] = dict(eos_id=int(greedy[i].tokens[2]))
    want, jm, jw1, jw2 = _serve(
        jax_engine, prompts, [jx["Sampling"](**s) for s in sampling])
    before = (flash_attention.launches, decode_attention.launches)
    got, m, w1, w2 = _serve(lambda: _engine(params), prompts,
                            [SamplingParams(**s) for s in sampling])
    assert (flash_attention.launches, decode_attention.launches) == before
    reasons = []
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.finish_reason == w.finish_reason
        assert g.tokens.dtype == np.int32
        reasons.append(g.finish_reason)
    assert reasons.count("eos") == 2 and "length" in reasons
    assert [len(g.tokens) for g in got][3] == 2
    # the JAX engine's metrics keys, phase means included
    for a, b in zip((m, w1, w2), (jm, jw1, jw2)):
        assert set(a) == set(b)
    assert m["requests"] == w1["requests"] == 12 and w2["requests"] == 0
    assert m["prefill_mean_s"] == 0.0 and m["decode_mean_s"] > 0
    assert all(g.timing.total_s >= g.timing.decode_s > 0 for g in got)


def test_engine_equals_a_direct_prefill_and_decode_segment(params):
    """One padded batch, sampled and greedy rows: the engine's tokens are
    the direct prefill + first token + decode_segment tokens."""
    prompts = _prompts(5, 4, 14, seed=3)
    sampling = [SamplingParams(), SamplingParams(temperature=0.7, seed=4),
                SamplingParams(temperature=1.2, top_k=20, seed=5),
                SamplingParams(), SamplingParams(temperature=0.9, seed=6)]
    eng = _engine(params, batch_window_ms=200.0, max_batch=5)
    try:
        res = [h.result(timeout=300) for h in
               [eng.generate(p, s) for p, s in zip(prompts, sampling)]]
        assert eng.metrics()["batch_size_mean"] == 5.0
    finally:
        eng.close()
    B, bucket, T = 5, 16, DECODER["max_new_tokens"]
    toks = np.zeros((B, bucket), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    temp = torch.tensor([s.temperature for s in sampling])
    topk = torch.tensor([s.top_k or 0 for s in sampling], dtype=torch.int32)
    seed = torch.tensor([s.seed for s in sampling], dtype=torch.int32)
    caches = make_caches(CFG, B, bucket + T, dtype=torch.float32,
                         device="cpu")
    logits = forward(CFG, params, tokens=torch.from_numpy(toks),
                     caches=caches)
    first = sample_logits(logits[torch.arange(B), lens.long() - 1],
                          temperature=temp, top_k=topk, seed=seed,
                          positions=lens)[:, None]
    rest, _, _, _ = decode_segment(CFG, params, first, lens[:, None], caches,
                                   n_steps=T - 1, temperature=temp,
                                   top_k=topk, seed=seed)
    want = torch.cat([first, rest], 1).numpy()
    for i, r in enumerate(res):
        np.testing.assert_array_equal(r.tokens, want[i])


def test_submit_shim_and_both_scan_settings_agree(params):
    prompts = _prompts(4, 3, 12, seed=4)
    outs = {}
    for scan in (True, False):
        eng = _engine(params, use_scan_decode=scan)
        try:
            outs[scan] = [f.result(timeout=300)
                          for f in [eng.submit(p) for p in prompts]]
            if not scan:
                h = eng.generate(prompts[0], SamplingParams(temperature=0.5))
                with pytest.raises(ValueError, match="use_scan_decode"):
                    h.result(timeout=10)
        finally:
            eng.close()
    for a, b in zip(outs[True], outs[False]):
        assert isinstance(a, np.ndarray) and len(a) == 4
        np.testing.assert_array_equal(a, b)


def test_handle_errors_and_request_ids(params):
    eng = _engine(params)
    try:
        with pytest.raises(RequestTooLong):
            eng.generate(np.ones(33, np.int32)).result(timeout=10)
        with pytest.raises(ValueError, match="non-empty"):
            eng.generate(np.zeros(0, np.int32)).result(timeout=10)
        with pytest.raises(ValueError, match="exceeds"):
            eng.generate(np.ones(4, np.int32),
                         SamplingParams(max_new_tokens=5)).result(timeout=10)
        req = GenerationRequest(tokens=np.ones(5, np.int32),
                                request_id="r-1")
        h = eng.generate(req)
        r = h.result(timeout=300)
        assert r.request_id == "r-1" and list(h) == list(r.tokens)
    finally:
        eng.close()
    enc = _engine(params, mode="encoder")
    try:
        with pytest.raises(ValueError, match="mode='decoder'"):
            enc.generate(np.ones(3, np.int32))
    finally:
        enc.close()


def test_warmup_serves_each_bucket_and_discard_drops_it(params):
    eng = _engine(params)
    try:
        eng.warmup(batch_sizes=[2], buckets=[16, 32])
        m = eng.metrics()
        assert m["requests"] == 4 and "decode_mean_s" not in m
        eng.discard_samples()
        assert eng.metrics()["requests"] == 0
        assert eng.window()["requests"] == 0
    finally:
        eng.close()


@pytest.mark.parametrize("kw,exc,match", [
    (dict(prefill_chunk=8), NotImplementedError, "item 7"),
    (dict(prefix_cache=True, prefill_chunk=8), NotImplementedError,
     "item 8"),
    (dict(spec_decode=True), NotImplementedError, "item 10"),
    (dict(continuous=False, use_cache_pool=False, weight_quant="int4"),
     ValueError, "weight_quant must be None or 'int8'"),
    (dict(continuous=False, use_cache_pool=False, kv_quant="int4"),
     ValueError, "kv_quant must be one of"),
    (dict(continuous=False, use_cache_pool=False, prefix_cache=True),
     ValueError, "continuous decoder path"),
    (dict(continuous=False, use_cache_pool=False, spec_decode=True),
     ValueError, "continuous decoder path"),
])
def test_decoder_config_gates_raise(params, kw, exc, match):
    """The continuous path's features that are not ported name their
    ROADMAP item; the others are the JAX engine's own errors."""
    with pytest.raises(exc, match=match):
        ServingEngine(CFG, params, EngineConfig(mode="decoder", **kw),
                      device="cpu")


@pytest.mark.parametrize("kw,continuous", [
    (dict(), True),
    (dict(continuous=True, use_cache_pool=False), False),
    (dict(continuous=False, use_cache_pool=True), False),
])
def test_decoder_configs_serve(params, kw, continuous):
    """The three configurations that raised before the KV pool and the
    continuous scheduler were ported now serve: the default one through
    the continuous scheduler, the other two batch at a time (JAX's
    ``continuous_active``), with the same tokens."""
    prompts = _prompts(3, 3, 20, seed=8)
    eng = ServingEngine(CFG, params, EngineConfig(
        mode="decoder", pad_buckets=(16, 32), max_new_tokens=4,
        max_batch=4, **kw), device="cpu")
    ref = _engine(params)
    try:
        assert eng.continuous_active is continuous
        got = [h.result(timeout=300).tokens
               for h in [eng.generate(p) for p in prompts]]
        want = [h.result(timeout=300).tokens
                for h in [ref.generate(p) for p in prompts]]
    finally:
        eng.close()
        ref.close()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert ("jit_compiles" in eng.metrics()) is continuous


def test_jax_engine_rejects_the_same_features(jx):
    """The ValueErrors above are the JAX engine's own."""
    for kw, match in ((dict(prefix_cache=True), "continuous decoder path"),
                      (dict(spec_decode=True), "continuous decoder path"),
                      (dict(weight_quant="int4"),
                       "weight_quant must be None or 'int8'"),
                      (dict(kv_quant="int4"), "kv_quant must be one of")):
        with pytest.raises(ValueError, match=match):
            jx["Engine"](jx["cfg"], jx["params"], jx["EngineConfig"](
                mode="decoder", continuous=False, use_cache_pool=False,
                **kw))
