"""The port's chunked prefill (``models.prefill_chunk``, the engine's chunk
program and the continuous scheduler's fills) against the JAX package's,
on the CPU, and the padding that keeps a row's bits off its batch.

The model core: a prompt run chunk by chunk through ``prefill_chunk``
gives JAX's logits and caches to 1e-4 (fp32, the Qwen2 and
RecurrentGemma smoke configs, chunks of 4 and 8, a ring shorter than the
chunk, an int8 KV cache whose int8 entries may differ by one step).
The engine: the continuous decoder with ``prefill_chunk=8`` serves
greedy, sampled, budget-capped and eos-stopped requests across two
buckets with the JAX engine's tokens, finish reasons and chunk counters,
in fp32, with int8 weights and KV, and on the hybrid; a long prompt's
chunks interleave with in-flight decode, and a fill cancelled mid-way
resolves as cancelled and leaks no slot. The repair: the encoder program
and the eager decoder pad a small batch to ``PREFILL_MIN_M`` rows of M
like the captured prefills, and no padding row writes a slot. JAX is
imported in a fixture.
"""
import dataclasses
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.models import init_params, make_caches, prefill_chunk
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.engine import _Request

BASE = dict(mode="decoder", max_batch=4, max_new_tokens=6,
            pad_buckets=(16, 32), decode_segment=2, prefill_chunk=8)
SAMPLING = [dict(), dict(temperature=0.8, top_k=20, seed=3),
            dict(max_new_tokens=3), dict(eos_id=None),
            dict(temperature=1.0, seed=9), dict()]


def _cfg(name):
    return dataclasses.replace(get_config(name, smoke=True), dtype="float32")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models import init_params as jax_init_params
    from repro.models import make_caches as jax_make_caches
    from repro.models.transformer import prefill_chunk as jax_prefill_chunk
    from repro.serving import EngineConfig as JaxEngineConfig
    from repro.serving import ServingEngine as JaxServingEngine
    from repro.serving.api import SamplingParams as JaxSamplingParams

    def model(name):
        jcfg = dataclasses.replace(jax_get_config(name, smoke=True),
                                   dtype="float32")
        p = jax_init_params(jcfg, jax.random.PRNGKey(0))
        return jcfg, p, to_torch(jax.tree.map(np.asarray, p), device="cpu")
    return dict(jnp=jnp, model=model, make_caches=jax_make_caches,
                prefill_chunk=jax_prefill_chunk, Engine=JaxServingEngine,
                EngineConfig=JaxEngineConfig, Sampling=JaxSamplingParams)


@pytest.fixture(scope="module")
def models(jx):
    return {name: jx["model"](name)
            for name in ("qwen2-0.5b", "recurrentgemma-9b")}


# --------------------------------------------------------- the model core
@pytest.mark.parametrize("name,C,L,kv_quant", [
    ("qwen2-0.5b", 4, 40, None), ("qwen2-0.5b", 8, 40, None),
    ("qwen2-0.5b", 8, 6, None), ("qwen2-0.5b", 8, 40, "int8"),
    ("recurrentgemma-9b", 8, 40, None),
], ids=["qwen2-C4", "qwen2-C8", "qwen2-C8-ring6", "qwen2-C8-int8kv",
        "hybrid-C8"])
def test_prefill_chunk_matches_jax(jx, models, name, C, L, kv_quant):
    """Two rows of 22 tokens, chunk by chunk (the last chunk padded), into
    caches of L slots: every chunk's logits and the final caches equal
    JAX's to 1e-4. With L = 6 < C each chunk keeps only its last 6
    positions, at their ring slots."""
    jcfg, jp, tp = models[name]
    cfg = _cfg(name)
    jnp = jx["jnp"]
    rng = np.random.default_rng(C + L)
    B, S = 2, 22
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    jc = jx["make_caches"](jcfg, B, L, dtype=jnp.float32, kv_quant=kv_quant)
    tc = make_caches(cfg, B, L, dtype=torch.float32, kv_quant=kv_quant,
                     device="cpu")
    for s0 in range(0, S, C):
        t = np.zeros((B, C), np.int32)
        t[:, :min(C, S - s0)] = toks[:, s0:s0 + C]
        pos = np.broadcast_to(s0 + np.arange(C, dtype=np.int32), (B, C))
        want, jc, _ = jx["prefill_chunk"](jcfg, jp, jnp.asarray(t),
                                          jnp.asarray(pos), jc)
        got = prefill_chunk(cfg, tp, torch.from_numpy(t).long(),
                            torch.from_numpy(pos.copy()), tc)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    for b in jc:
        for k in jc[b]:
            w, g = np.asarray(jc[b][k]), tc[b][k].numpy()
            if w.dtype == np.int8:        # rounding of K/V within 1e-6
                assert np.abs(w.astype(int) - g.astype(int)).max() <= 1
            elif w.dtype == np.int32:
                np.testing.assert_array_equal(g, w, err_msg=f"{b}/{k}")
            else:
                np.testing.assert_allclose(g, w, rtol=1e-4,
                                           atol=1e-4 * np.abs(w).max(),
                                           err_msg=f"{b}/{k}")


# -------------------------------------------------------------- the engine
def _prompts(cfg, n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1)))
            for _ in range(n)]


def _serve(eng, prompts, sampling, warm=False):
    """(results, the window after an optional ``warmup(sampled=True)``);
    closes the engine."""
    try:
        if warm:
            eng.warmup(sampled=True)
            eng.window()
        handles = [eng.generate(p, s) for p, s in zip(prompts, sampling)]
        return [h.result(timeout=300) for h in handles], eng.window()
    finally:
        eng.close()


@pytest.mark.parametrize("name,kw", [
    ("qwen2-0.5b", {}),
    ("qwen2-0.5b", dict(weight_quant="int8", kv_quant="int8")),
    ("recurrentgemma-9b", {}),
], ids=["fp32", "int8-w-kv", "hybrid"])
def test_chunked_engine_matches_jax(jx, models, name, kw):
    """Eight requests over both buckets, prompts of 3-30 tokens (those
    longer than 8 fill chunk by chunk): the port's tokens and finish
    reasons equal the JAX engine's at the same ``prefill_chunk``, and so
    do the chunk counters, overall and per lane (each fill counts once
    per chunk it runs, whatever else shares its turn). The port's
    measured window after ``warmup(sampled=True)`` builds nothing."""
    jcfg, jp, tp = models[name]
    cfg = _cfg(name)
    prompts = (_prompts(cfg, 3, 3, 16, seed=1)
               + _prompts(cfg, 5, 17, 30, seed=2))
    greedy, _ = _serve(ServingEngine(cfg, tp, EngineConfig(**BASE, **kw),
                                     device="cpu"),
                       prompts, [SamplingParams()] * len(prompts))
    sampling = [dict(SAMPLING[i % len(SAMPLING)]) for i in range(8)]
    for i, sp in enumerate(sampling):
        if "eos_id" in sp:
            sampling[i] = dict(eos_id=int(greedy[i].tokens[2]))
    got, win = _serve(ServingEngine(cfg, tp, EngineConfig(**BASE, **kw),
                                    device="cpu"),
                      prompts, [SamplingParams(**s) for s in sampling],
                      warm=True)
    want, jwin = _serve(jx["Engine"](jcfg, jp, jx["EngineConfig"](**BASE,
                                                                 **kw)),
                        prompts, [jx["Sampling"](**s) for s in sampling])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.finish_reason == w.finish_reason
    assert [r.finish_reason for r in got].count("eos") == 1
    n_chunks = sum(-(-len(p) // 8) for p in prompts if len(p) > 8)
    assert win["prefill_chunks"] == jwin["prefill_chunks"] == n_chunks
    for b in (16, 32):
        assert (win["lanes"][b]["prefill_chunks"]
                == jwin["lanes"][b]["prefill_chunks"])
    assert win["jit_compiles"] == 0


def _slow_chunks(eng, seconds):
    """Make each of the engine's chunk calls take ``seconds`` longer, so a
    test can act while a fill is under way."""
    call = eng._chunk_call

    def slow(*a, **k):
        out = call(*a, **k)
        time.sleep(seconds)
        return out
    eng._chunk_call = slow


def _qwen_engine(models, **kw):
    _, _, tp = models["qwen2-0.5b"]
    return ServingEngine(_cfg("qwen2-0.5b"), tp,
                         EngineConfig(**dict(BASE, **kw)), device="cpu")


def _prompt(n, seed=23):
    return np.random.default_rng(seed + n).integers(0, 512, n)


def test_chunked_prefill_interleaves_with_inflight_decode(models):
    """A long-prompt join does not stall the in-flight row for its whole
    prefill: its 8 chunks run between decode segments of the other lane,
    and both requests finish at their full length."""
    eng = _qwen_engine(models, max_new_tokens=24, prefill_chunk=4)
    try:
        eng.generate(_prompt(5)).result(timeout=300)
        h1 = eng.generate(_prompt(5))                 # bucket 16, decoding
        next(iter(h1))
        _slow_chunks(eng, 0.002)
        h2 = eng.generate(_prompt(30))                # 8 chunks of 4
        r1, r2 = h1.result(timeout=300), h2.result(timeout=300)
        assert len(r1.tokens) == 24 and len(r2.tokens) == 24
        m = eng.metrics()
        assert m["prefill_chunks"] >= 8 and m["lanes"][32]["joins"] >= 1
        assert m["lanes"][16]["decode_segments"] >= 2
    finally:
        eng.close()


def test_cancel_mid_chunked_prefill_resolves_cancelled(models):
    eng = _qwen_engine(models, max_new_tokens=24, prefill_chunk=4)
    try:
        eng.generate(_prompt(4)).result(timeout=300)
        _slow_chunks(eng, 0.02)
        blocker = eng.generate(_prompt(4))            # whole-prompt path
        h = eng.generate(_prompt(30))                 # only h chunks (8x4)
        deadline = time.time() + 60
        while eng.metrics()["prefill_chunks"] < 1:
            assert time.time() < deadline
            time.sleep(0.001)
        assert h.cancel()
        assert h.result(timeout=300).finish_reason == "cancelled"
        blocker.result(timeout=300)
        assert eng.metrics()["prefill_chunks"] < 8
        ok = eng.generate(_prompt(30)).result(timeout=300)
        assert len(ok.tokens) == 24                   # slots not leaked
        lane = eng._scheduler.lanes[32]
        assert all(r is None for r in eng._get_pool(32).request_of)
        assert all(r is None for r in lane.staging.request_of)
        assert not lane.fills
    finally:
        eng.close()


def test_prefill_chunk_ring_overflow_rejected_at_init(models):
    """A chunk whose round-up exceeds the slot's KV length would wrap the
    ring over the prompt's first K/V: refused, as in JAX."""
    with pytest.raises(ValueError, match="prefill_chunk"):
        _qwen_engine(models, pad_buckets=(32,), prefill_chunk=12,
                     max_new_tokens=2)
    with pytest.raises(ValueError, match="prefill_chunk"):
        _qwen_engine(models, prefill_chunk=0)
    _qwen_engine(models, pad_buckets=(32,), prefill_chunk=8,
                 max_new_tokens=2).close()


# ----------------------------------------- a row's bits and its batch
def _snapshot(caches):
    return {(b, k): x.clone() for b, blk in caches.items()
            for k, x in blk.items()}


def _fill_random(caches, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.inference_mode():      # a pool may be made in this mode
        for blk in caches.values():
            for x in blk.values():
                if x.is_floating_point():
                    x.copy_(torch.randn(x.shape, generator=g))


def _requests(prompts):
    return [_Request(np.asarray(p, np.int32), Future(), time.perf_counter())
            for p in prompts]


def test_encoder_rows_do_not_follow_their_batch():
    """The encoder program pads a batch of B rows to ``_prefill_rows(B,
    bucket)`` (M >= 128) with copies of its first row: batches of 1-3 at
    bucket 32 run as one program of 4 rows, 1 at bucket 64 as 2, and each
    request's result equals its row in the widest batch."""
    cfg = _cfg("gector-base")
    eng = ServingEngine(cfg, init_params(cfg, 0, device="cpu"),
                        EngineConfig(mode="encoder", max_batch=8,
                                     pad_buckets=(32, 64)), device="cpu")
    try:
        prompts = _prompts(cfg, 4, 8, 30, seed=5)
        wide = _requests(prompts)
        eng._serve_batch(wide)
        for n in (1, 2, 3):
            reqs = _requests(prompts[:n])
            eng._serve_batch(reqs)
            for r, w in zip(reqs, wide):
                assert torch.equal(r.future.result(), w.future.result())
        long = _requests(_prompts(cfg, 1, 40, 60, seed=6))
        eng._serve_batch(long)
        assert set(eng._graphs._graphs) == {("enc", 32, 4), ("enc", 64, 2)}
        assert long[0].future.result().shape[0] == 64
    finally:
        eng.close()


def test_eager_decoder_rows_do_not_follow_their_batch(models):
    """``use_scan_decode=False`` pads a batch the same way: its padding
    rows decode on copies of the first row's cache, so the pool's other
    slots keep their bytes, and each request's tokens equal its row in
    the widest batch."""
    _, _, tp = models["qwen2-0.5b"]
    cfg = _cfg("qwen2-0.5b")
    eng = ServingEngine(cfg, tp, EngineConfig(
        mode="decoder", continuous=False, use_scan_decode=False,
        pad_buckets=(32,), max_batch=8, max_new_tokens=4), device="cpu")
    try:
        prompts = _prompts(cfg, 4, 5, 30, seed=7)
        wide = _requests(prompts)
        eng._serve_batch(wide)
        pool = eng._get_pool(32)
        _fill_random(pool.caches, 0)
        before = _snapshot(pool.caches)
        reqs = _requests(prompts[:1])
        eng._serve_batch(reqs)
        np.testing.assert_array_equal(reqs[0].future.result(),
                                      wide[0].future.result())
        for (b, k), x in before.items():     # slot 0 reset, 1..7 untouched
            assert torch.equal(pool.caches[b][k][:, 1:], x[:, 1:]), (b, k)
    finally:
        eng.close()


def test_chunk_program_padding_writes_nothing_of_its_own(models):
    """At chunk 4 one fill runs as 32 rows (``_prefill_rows``, M = 128): the
    padding rows name the fill's staging slot and take its row, so only
    that slot changes, and its token equals the same fill's among three."""
    eng = _qwen_engine(models, pad_buckets=(32,), prefill_chunk=4)
    try:
        staging = eng._scheduler.lanes[32].get_staging(eng)
        _fill_random(staging.caches, 1)
        toks = np.arange(12, dtype=np.int64).reshape(3, 4)
        start = np.zeros(3, np.int32)
        nvalid = np.array([4, 3, 2], np.int32)
        before = _snapshot(staging.caches)
        one = eng._chunk_call("cont_chunk", 32, staging, staging, toks[:1],
                              start[:1], nvalid[:1], [2], [2])
        for (b, k), x in before.items():
            now = staging.caches[b][k]
            others = [0, 1, 3]
            assert torch.equal(now[:, others], x[:, others]), (b, k)
        for (b, k), x in before.items():
            staging.caches[b][k].copy_(x)
        three = eng._chunk_call("cont_chunk", 32, staging, staging, toks,
                                start, nvalid, [2, 0, 3], [2, 0, 3])
        assert one[0] == three[0]
        assert set(eng._graphs._graphs) == {("cont_chunk", 32, 32, 4, False)}
    finally:
        eng.close()
