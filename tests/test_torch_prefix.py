"""The port's prefix cache (``serving.kvcache``'s ``PrefixTrie``,
``PrefixStore``, ``_load_slots`` and ``_store_prefix``, and the
continuous scheduler's hit routing) against the JAX package's, on the
CPU.

The trie is a copy: the same random traffic (inserts after
``make_room``, lookups that take a reference, releases) gives the same
observations on both. The slot copies equal JAX's by ``==``, fp32 and
int8 KV with its scale planes, and so do a store's inserts and loads.
The engine (Qwen2 smoke, fp32, bucket 32, chunks of 8): requests that
share a system prompt, served one after another, come back with the
tokens of a cold engine and of the JAX engine, greedy and sampled, with
an fp32 and an int8 KV cache, and with JAX's hit, miss, insert,
eviction and byte counters; a byte budget of one entry evicts and stays
correct; a request cancelled while its suffix fills leaks no slot or
reference; configurations JAX refuses are refused. JAX is imported in a
fixture.
"""
import dataclasses
import random
import time

import numpy as np
import pytest
import torch

from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.serving import EngineConfig, ServingEngine, kvcache
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.kvcache import CachePool, PrefixStore, PrefixTrie

CFG = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                          dtype="float32")
BASE = dict(mode="decoder", max_batch=4, max_new_tokens=6,
            pad_buckets=(32,), decode_segment=2, prefill_chunk=8,
            prefix_cache=True)
COUNTERS = ("prefix_hits", "prefix_misses", "prefix_hit_tokens",
            "prefix_inserts", "prefix_evictions", "prefix_bytes")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models import init_params as jax_init_params
    from repro.serving import EngineConfig as JaxEngineConfig
    from repro.serving import ServingEngine as JaxServingEngine
    from repro.serving import kvcache as jkv
    from repro.serving.api import SamplingParams as JaxSamplingParams
    jcfg = dataclasses.replace(jax_get_config("qwen2-0.5b", smoke=True),
                               dtype="float32")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return dict(jnp=jnp, kv=jkv, cfg=jcfg, params=jp,
                tparams=to_torch(jax.tree.map(np.asarray, jp), device="cpu"),
                Engine=JaxServingEngine, EngineConfig=JaxEngineConfig,
                Sampling=JaxSamplingParams)


# ------------------------------------------------------------------ trie
CHUNK, ENTRY = 4, 100


def _simulate(trie_cls, seed, cap):
    """Random insert/lookup/release traffic against one trie, with the
    store's discipline (``make_room`` before every ``attach``): the
    observations of every step."""
    rng = random.Random(seed)
    trie = trie_cls(CHUNK, cap * ENTRY)
    held, log = [], []
    for step in range(60):
        op, fam, n = rng.random(), rng.randint(0, 2), rng.randint(1, 5)
        toks = [fam * 1000 + i for i in range(n * CHUNK)]
        if op < 0.5:
            log.append(("div", trie.divergence_chunks(toks)))
            if not trie.has_entry(toks, n):
                victims = trie.make_room(ENTRY, min_evict=step % 2)
                log.append(("room", None if victims is None else
                            [(v.slot, v.n_tokens) for v in victims]))
                if victims is not None:
                    trie.attach(toks, n, ENTRY, slot=step)
        elif op < 0.8:
            e = trie.lookup(toks + [7])
            log.append(("lookup", None if e is None else
                        (e.slot, e.n_tokens, e.refs, e.tick)))
            if e is not None:
                held.append(e)
        elif held:
            e = held.pop(rng.randrange(len(held)))
            trie.release(e)
            log.append(("release", e.slot, e.refs))
        log.append(("state", trie.bytes, sorted(
            (e.slot, e.n_tokens, e.refs, e.tick) for e in trie.entries)))
    return log


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("cap", [1, 2, 4])
def test_trie_equals_jax_under_random_traffic(jx, seed, cap):
    assert (_simulate(PrefixTrie, seed, cap)
            == _simulate(jx["kv"].PrefixTrie, seed, cap))


def test_trie_refuses_what_jax_refuses(jx):
    for cls in (PrefixTrie, jx["kv"].PrefixTrie):
        with pytest.raises(ValueError, match="chunk must be >= 1"):
            cls(0, 10)
        trie = cls(CHUNK, ENTRY)
        e = trie.attach(list(range(8)), 2, ENTRY, slot=0)
        with pytest.raises(RuntimeError, match="already stored"):
            trie.attach(list(range(8)), 2, ENTRY, slot=1)
        with pytest.raises(RuntimeError, match="without a matching"):
            trie.release(e)


# ------------------------------------------------------------ slot copies
def _random_pools(jx, kv_quant, seed):
    """(jax pool, port pool) of 4 slots of 24 positions with the same
    numpy-made contents."""
    jpool = jx["kv"].CachePool(jx["cfg"], 4, 24, dtype=jx["jnp"].float32,
                               kv_quant=kv_quant)
    tpool = CachePool(CFG, 4, 24, dtype=torch.float32, kv_quant=kv_quant,
                      device="cpu")
    rng = np.random.default_rng(seed)
    for b, blk in tpool.caches.items():
        for k, x in blk.items():
            dt = np.dtype(str(x.dtype).replace("torch.", ""))
            shape = tuple(x.shape)
            if dt == np.int8:
                arr = rng.integers(-127, 128, shape).astype(dt)
            elif dt == np.int32:
                arr = rng.integers(-1, 24, shape).astype(dt)
            else:
                arr = rng.standard_normal(shape).astype(dt)
            x.copy_(torch.from_numpy(arr))
            jpool.caches[b][k] = jx["jnp"].asarray(arr)
    return jpool, tpool


def _assert_same(jtree, ttree):
    assert set(jtree) == set(ttree)
    for b in jtree:
        assert set(jtree[b]) == set(ttree[b])
        for k in jtree[b]:
            np.testing.assert_array_equal(np.asarray(jtree[b][k]),
                                          ttree[b][k].numpy(),
                                          err_msg=f"{b}/{k}")


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["fp32", "int8"])
def test_slot_copies_equal_jax(jx, kv_quant):
    jnp, jkv = jx["jnp"], jx["kv"]
    jdst, tdst = _random_pools(jx, kv_quant, 0)
    jsrc, tsrc = _random_pools(jx, kv_quant, 1)

    def i32(*v):
        return jnp.asarray(v, jnp.int32)
    jc = jkv._load_slots(jdst.caches, jsrc.caches, i32(2, 0), i32(1, 3))
    tc = kvcache._load_slots(tdst.caches, tsrc.caches, torch.tensor([2, 0]),
                             torch.tensor([1, 3]))
    _assert_same(jc, tc)
    for n_tokens in (0, 5, 24):
        jc = jkv._store_prefix(jc, jsrc.caches, i32(1), i32(2),
                               jnp.asarray(n_tokens, jnp.int32))
        tc = kvcache._store_prefix(tc, tsrc.caches, torch.tensor([1]),
                                   torch.tensor([2]), n_tokens)
        _assert_same(jc, tc)


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["fp32", "int8"])
def test_store_inserts_and_loads_equal_jax(jx, kv_quant):
    """A store of 2 slots (its byte budget from the template, as JAX
    computes it): inserts at the divergence and full depths, an eviction
    when the slots run out, and a load into a lane pool, each equal to
    JAX's store."""
    jlane, tlane = _random_pools(jx, kv_quant, 2)
    jstore = jx["kv"].PrefixStore(jx["cfg"], 2, 24, CHUNK,
                                  dtype=jx["jnp"].float32, kv_quant=kv_quant)
    tstore = PrefixStore(CFG, 2, 24, CHUNK, dtype=torch.float32,
                         kv_quant=kv_quant, device="cpu")
    assert tstore.entry_bytes == jstore.entry_bytes
    a = list(range(14))
    b = a[:8] + [99] * 6
    c = [7] * 13
    for toks, matched, slot in ((a, 0, 0), (b, 0, 1), (c, 4, 2)):
        assert (tstore.insert(toks, matched, tlane, slot)
                == jstore.insert(toks, matched, jlane, slot))
        _assert_same(jstore.pool.caches, tstore.pool.caches)
        assert tstore.pool.lengths == jstore.pool.lengths
        assert tstore.bytes_used == jstore.bytes_used
    te, je = tstore.lookup(c + [1]), jstore.lookup(c + [1])
    assert (te.slot, te.n_tokens) == (je.slot, je.n_tokens)
    tstore.load_many([te], tlane, [3])
    jstore.load_many([je], jlane, [3])
    _assert_same(jlane.caches, tlane.caches)


# ---------------------------------------------------------------- engine
def _shared_prompts(n, sys_tokens=20, lo=2, hi=10, seed=17):
    """Prompts sharing one system prompt, with short unique suffixes."""
    rng = np.random.default_rng(seed)
    sysp = rng.integers(0, CFG.vocab_size, (sys_tokens,))
    return [np.concatenate([sysp, rng.integers(
        0, CFG.vocab_size, (int(rng.integers(lo, hi + 1)),))])
        for _ in range(n)]


def _port(jx, **kw):
    return ServingEngine(CFG, jx["tparams"],
                         EngineConfig(**dict(BASE, **kw)), device="cpu")


def _one_by_one(eng, prompts, sampling, warm=False):
    """Serve the prompts one after another (each a join of its own, so
    hits and inserts do not depend on timing); returns (results, lane 32
    counters of the window after an optional warmup, its compiles).
    Closes the engine."""
    try:
        if warm:
            eng.warmup(sampled=True)
        eng.window()
        out = [eng.generate(p, s).result(timeout=300)
               for p, s in zip(prompts, sampling)]
        w = eng.window()
        return out, w["lanes"][32], w["jit_compiles"]
    finally:
        eng.close()


def _sampling(i):
    return (dict(max_new_tokens=6, temperature=0.8, top_k=20, seed=11 + i)
            if i % 2 else {})


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["fp32", "int8kv"])
def test_warm_hits_match_cold_and_jax(jx, kv_quant):
    """The first prompt stores the system prompt's chunks; the others hit
    it (suffixes of 1-9 tokens past the stored 16 run as one chunk or
    start a fill at 16) and equal a cold engine's tokens and the JAX
    engine's, greedy and sampled; the counters equal JAX's and the
    measured window builds nothing."""
    prompts = _shared_prompts(6)
    prompts = [prompts[0]] + prompts
    sp = [_sampling(i) for i in range(len(prompts))]
    cold, _, _ = _one_by_one(_port(jx, prefix_cache=False,
                                   kv_quant=kv_quant),
                             prompts, [SamplingParams(**s) for s in sp])
    warm, lane, compiles = _one_by_one(
        _port(jx, kv_quant=kv_quant), prompts,
        [SamplingParams(**s) for s in sp], warm=True)
    want, jlane, _ = _one_by_one(
        jx["Engine"](jx["cfg"], jx["params"], jx["EngineConfig"](
            **BASE, kv_quant=kv_quant)),
        prompts, [jx["Sampling"](**s) for s in sp])
    for c, w, j in zip(cold, warm, want):
        np.testing.assert_array_equal(w.tokens, c.tokens)
        np.testing.assert_array_equal(w.tokens, j.tokens)
    assert {k: lane[k] for k in COUNTERS} == {k: jlane[k] for k in COUNTERS}
    assert lane["prefix_hits"] + lane["prefix_misses"] == len(prompts)
    assert lane["prefix_hits"] >= len(prompts) - 2
    assert lane["prefix_bytes"] > 0 and compiles == 0


def test_tiny_budget_evicts_and_stays_correct(jx):
    """A byte budget of exactly one entry evicts on every new prefix
    family; tokens equal a cold engine's and JAX's, counters JAX's."""
    store = kvcache.PrefixStore(CFG, 4, 38, 8, dtype=torch.float32,
                                device="cpu")
    rng = np.random.default_rng(5)
    fams = [rng.integers(0, CFG.vocab_size, (20,)) for _ in range(3)]
    prompts = [np.concatenate([f, rng.integers(0, CFG.vocab_size, (4,))])
               for f in fams for _ in range(2)]
    sp = [{}] * len(prompts)
    cold, _, _ = _one_by_one(_port(jx, prefix_cache=False), prompts,
                             [SamplingParams()] * len(prompts))
    got, lane, _ = _one_by_one(
        _port(jx, prefix_cache_bytes=store.entry_bytes), prompts,
        [SamplingParams()] * len(prompts))
    want, jlane, _ = _one_by_one(
        jx["Engine"](jx["cfg"], jx["params"], jx["EngineConfig"](
            **BASE, prefix_cache_bytes=store.entry_bytes)),
        prompts, [jx["Sampling"](**s) for s in sp])
    for c, g, w in zip(cold, got, want):
        np.testing.assert_array_equal(g.tokens, c.tokens)
        np.testing.assert_array_equal(g.tokens, w.tokens)
    assert {k: lane[k] for k in COUNTERS} == {k: jlane[k] for k in COUNTERS}
    assert lane["prefix_evictions"] >= 2
    assert lane["prefix_bytes"] <= store.entry_bytes


def test_cancel_mid_suffix_prefill_leaks_no_slot_or_ref(jx):
    """Cancel a request while its suffix (past a hit) fills chunk by
    chunk: its lane slot, staging slot and store reference are released
    and the store goes on serving hits. The first two prompts store the
    shared 16 tokens (the second at its divergence depth)."""
    prompts = _shared_prompts(4, sys_tokens=16, lo=12, hi=14)  # suffix > C
    eng = _port(jx, max_new_tokens=24, prefill_chunk=4)
    try:
        for p in prompts[:2]:
            eng.generate(p).result(timeout=300)
        call = eng._chunk_call

        def slow(*a, **k):                            # a fill under way
            out = call(*a, **k)
            time.sleep(0.02)
            return out
        eng._chunk_call = slow
        lane = eng._scheduler.lanes[32]
        h = eng.generate(prompts[2])                  # hit + chunked suffix
        deadline = time.time() + 60
        while not any(f.req.handle is h and f.filled > f.matched == 16
                      for f in list(lane.fills)):
            assert time.time() < deadline
            time.sleep(0.001)
        assert h.cancel()
        assert h.result(timeout=300).finish_reason == "cancelled"
        ok = eng.generate(prompts[3]).result(timeout=300)
        assert len(ok.tokens) == 24                   # slots not leaked
        store = eng._prefix_store(32)
        assert all(e.refs == 0 for e in store.trie.entries)
        assert all(r is None for r in eng._get_pool(32).request_of)
        assert all(r is None for r in lane.staging.request_of)
        assert eng.metrics()["lanes"][32]["prefix_hits"] == 2
    finally:
        eng.close()


def test_unsupported_configs_rejected_at_init(jx):
    for kw in (dict(continuous=False), dict(prefill_chunk=None)):
        with pytest.raises(ValueError, match="prefix_cache"):
            _port(jx, **kw)
    hybrid = get_config("recurrentgemma-9b", smoke=True)
    with pytest.raises(ValueError, match="prefix_cache"):
        ServingEngine(hybrid, jx["tparams"], EngineConfig(**BASE),
                      device="cpu")
