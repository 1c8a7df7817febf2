"""The PyTorch port's encoder-mode ServingEngine, on the CPU.

Results equal a direct forward of the same padded batch row; requests
longer than the largest bucket are rejected; admission bounds in-flight
work; ``metrics``/``window`` report the JAX engine's keys; ``close`` fails
what is still pending; asking for the card without CUDA raises.
"""
import dataclasses
from concurrent.futures import wait

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.gector import init_gector as jax_init_gector
from repro.core.tags import TagVocab as JaxTagVocab
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.core.gector import predict_tags, tag_head
from repro_torch.models import forward
from repro_torch.serving import EngineConfig, RequestTooLong, ServingEngine

CFG = dataclasses.replace(get_config("gector-base", smoke=True),
                          dtype="float32")
JCFG = dataclasses.replace(jax_get_config("gector-base", smoke=True),
                           dtype="float32")


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_gector(JCFG, jax.random.PRNGKey(0), JaxTagVocab(64))


@pytest.fixture(scope="module")
def params(jax_params):
    return to_torch(jax.tree.map(np.asarray, jax_params), device="cpu")


def _engine(params, head_fn=None, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("pad_buckets", (16, 32, 64))
    return ServingEngine(CFG, params, EngineConfig(mode="encoder", **kw),
                         head_fn=head_fn, device="cpu")


def _sentences(n, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, int(rng.integers(lo, hi + 1)))
            for _ in range(n)]


def _padded(sent, bucket):
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :len(sent)] = sent
    mask = np.zeros((1, bucket), bool)
    mask[0, :len(sent)] = True
    return toks, mask


def test_results_equal_a_direct_forward(params):
    eng = _engine(params)
    try:
        sents = _sentences(10, 3, 60)
        outs = [f.result(timeout=120) for f in
                [eng.submit(s) for s in sents]]
    finally:
        eng.close()
    for s, out in zip(sents, outs):
        bucket = out.shape[0]
        assert bucket in (16, 32, 64) and bucket >= len(s)
        toks, _ = _padded(s, bucket)
        with torch.inference_mode():
            want = forward(CFG, params["encoder"],
                           tokens=torch.from_numpy(toks), causal=False,
                           return_hidden=True)[0]
        # rows of a batch and a lone row round alike to within fp32 noise
        torch.testing.assert_close(out, want, atol=1e-5, rtol=0)


def test_tag_head_results_equal_predict_tags(params):
    eng = _engine(params, head_fn=tag_head)
    try:
        sents = _sentences(12, 3, 30, seed=1)
        outs = [f.result(timeout=120) for f in
                [eng.submit(s) for s in sents]]
        m = eng.metrics()
    finally:
        eng.close()
    assert m["requests"] == 12
    for s, out in zip(sents, outs):
        toks, mask = _padded(s, out.shape[0])
        np.testing.assert_array_equal(out.numpy(),
                                      predict_tags(CFG, params, toks,
                                                   mask)[0])


def test_request_too_long_is_rejected(params):
    eng = _engine(params)
    try:
        fut = eng.submit(np.ones(65, np.int32))
        with pytest.raises(RequestTooLong):
            fut.result(timeout=10)
        assert eng.submit(np.ones(64, np.int32)).result(
            timeout=120).shape[0] == 64
    finally:
        eng.close()


def test_admission_bounds_inflight(params):
    eng = _engine(params, max_inflight=2)
    try:
        futs = [eng.submit(s) for s in _sentences(8, 4, 12, seed=2)]
        done, _ = wait(futs, timeout=120)
        assert len(done) == 8 and all(f.exception() is None for f in futs)
        m = eng.metrics()
        assert m["requests"] == 8
        assert m["admission_peak_queue"] >= 1
        with eng._samples_lock:
            assert max(eng.batch_sizes) <= 2      # never more than admitted
    finally:
        eng.close()


def test_metrics_and_window_keys_match_the_jax_engine(params, jax_params):
    sents = _sentences(3, 4, 12, seed=3)
    views = {}
    for name, make in (
            ("jax", lambda: JaxServingEngine(
                JCFG, jax_params, JaxEngineConfig(mode="encoder",
                                                  max_batch=4,
                                                  max_inflight=4))),
            ("torch", lambda: _engine(params, max_batch=4,
                                      max_inflight=4))):
        eng = make()
        try:
            for s in sents:
                eng.submit(s).result(timeout=120)
            views[name] = (eng.metrics(), eng.window(), eng.window())
        finally:
            eng.close()
    for got, want in zip(views["torch"], views["jax"]):
        assert set(got) == set(want)
    m, w1, w2 = views["torch"]
    assert m["weight_bytes"] == views["jax"][0]["weight_bytes"]
    assert m["requests"] == w1["requests"] == 3
    assert w2["requests"] == 0 and w2["latency_p50_s"] is None


def test_warmup_and_discard_samples(params):
    eng = _engine(params)
    try:
        eng.warmup(batch_sizes=[1, 3], buckets=[16, 32])
        assert eng.metrics()["requests"] == 8
        eng.discard_samples()
        assert eng.metrics()["requests"] == 0
        assert eng.window()["requests"] == 0
    finally:
        eng.close()


def test_close_fails_pending_futures(params):
    eng = _engine(params, max_inflight=1)
    futs = [eng.submit(s) for s in _sentences(6, 20, 60, seed=4)]
    eng.close()
    done, _ = wait(futs, timeout=30)
    assert len(done) == 6
    failed = [f for f in futs if f.exception() is not None]
    assert failed                     # the parked ones at least
    assert all("closed" in str(f.exception()) for f in failed)
    late = eng.submit(np.ones(4, np.int32))
    with pytest.raises(RuntimeError, match="closed"):
        late.result(timeout=5)
    assert not eng._worker.is_alive()


def test_unported_modes_raise(params):
    """The continuous decoder serves; its chunked prefill (item 7) is not
    ported and raises naming the item. Quantization is ported and takes
    the JAX engine's errors: a bad weight_quant, and kv_quant outside
    decoder mode."""
    with pytest.raises(NotImplementedError, match="item 7"):
        ServingEngine(CFG, params, EngineConfig(mode="decoder",
                                                prefill_chunk=8),
                      device="cpu")
    for kw, match in ((dict(weight_quant="int4"), "weight_quant"),
                      (dict(kv_quant="int8"), "requires mode='decoder'")):
        with pytest.raises(ValueError, match=match):
            ServingEngine(CFG, params, EngineConfig(**kw), device="cpu")


@pytest.mark.skipif("torch.cuda.is_available()",
                    reason="a card is present: there is nothing to refuse")
def test_default_device_without_cuda_raises(params):
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(CFG, params, EngineConfig())
