"""The port's ``CachePool`` and its helpers against the JAX package's, on
the CPU.

Both pools hold the same numpy-made contents (float leaves normal, int8
K/V and positions random integers) for the Qwen2 smoke config in fp32,
with an fp32 or int8 KV cache, and for the RecurrentGemma smoke config
(local-attention rings and ``{h, conv}`` recurrent states). Every helper
and pool method then runs on both, and the trees, views and bookkeeping
must be equal by ``==``. The compacted round trip (gather the live
slots, decode at the tier width, scatter back) must leave every other
slot bitwise as it was, as a property over slot masks; the fixed-width
form the captured segment uses must write the same bytes as
``scatter_back``. JAX is imported in a fixture.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.models import decode_segment
from repro_torch.serving import kvcache
from repro_torch.serving.kvcache import CachePool
from repro_torch.serving.scheduler import pick_tier, width_tiers

N_SLOTS, MAX_LEN = 4, 24
CASES = [("qwen2-0.5b", None), ("qwen2-0.5b", "int8"),
         ("recurrentgemma-9b", None)]
CASE_IDS = ["qwen2-fp32", "qwen2-int8", "hybrid-fp32"]


def _cfg(name):
    return dataclasses.replace(get_config(name, smoke=True), dtype="float32")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.serving import kvcache as jkv
    return dict(jax=jax, jnp=jnp, kv=jkv, get_config=jax_get_config)


def _random_like(rng, x):
    shape, dt = tuple(x.shape), np.dtype(str(x.dtype).replace("torch.", ""))
    if dt == np.int8:
        return rng.integers(-127, 128, shape).astype(np.int8)
    if dt == np.int32:
        return rng.integers(-1, MAX_LEN, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(dt)


def _pools(jx, name, kv_quant, seed=0):
    jcfg = dataclasses.replace(jx["get_config"](name, smoke=True),
                               dtype="float32")
    jpool = jx["kv"].CachePool(jcfg, N_SLOTS, MAX_LEN,
                               dtype=jx["jnp"].float32, kv_quant=kv_quant)
    tpool = CachePool(_cfg(name), N_SLOTS, MAX_LEN, dtype=torch.float32,
                      kv_quant=kv_quant, device="cpu")
    rng = np.random.default_rng(seed)
    for b, blk in tpool.caches.items():
        for k, x in blk.items():
            arr = _random_like(rng, x)
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


def _batch_like(rng, tree, n):
    """A numpy tree shaped like ``tree`` with ``n`` slots."""
    return {b: {k: _random_like(rng, x[:, :1].expand(
        x.shape[0], n, *x.shape[2:])) for k, x in blk.items()}
        for b, blk in tree.items()}


def _both(jx, np_tree):
    return (jx["jax"].tree.map(jx["jnp"].asarray, np_tree),
            to_torch(np_tree, device="cpu"))


@pytest.mark.parametrize("name,kv_quant", CASES, ids=CASE_IDS)
def test_module_helpers_equal_jax(jx, name, kv_quant):
    jkv = jx["kv"]
    jnp = jx["jnp"]
    jpool, tpool = _pools(jx, name, kv_quant)
    idx = [3, 1]
    jidx, tidx = jnp.asarray(idx, jnp.int32), torch.tensor(idx)
    jc = jkv._reset_slots(jpool.caches, jpool._template, jidx)
    tc = kvcache._reset_slots(tpool.caches, tpool._template, tidx)
    _assert_same(jc, tc)
    jc, jview = jkv._reset_and_view(jc, jpool._template,
                                    jnp.asarray([0, 2], jnp.int32))
    tc, tview = kvcache._reset_and_view(tc, tpool._template,
                                        torch.tensor([0, 2]))
    _assert_same(jc, tc)
    _assert_same(jview, tview)
    rng = np.random.default_rng(1)
    jb, tb = _both(jx, _batch_like(rng, tc, 2))
    jc = jkv._write_slots(jc, jb, jidx)
    tc = kvcache._write_slots(tc, tb, tidx)
    _assert_same(jc, tc)
    _assert_same(jkv._take_slots(jc, jnp.asarray([2, 0, 2], jnp.int32)),
                 kvcache._take_slots(tc, torch.tensor([2, 0, 2])))
    jc, jview = jkv._reset_and_view_run(jc, jpool._template, lo=1, n=2)
    tc, tview = kvcache._reset_and_view_run(tc, tpool._template, lo=1, n=2)
    _assert_same(jc, tc)
    _assert_same(jview, tview)
    # the compacted write-back: a 4-row view, its first 2 rows land
    jb, tb = _both(jx, _batch_like(rng, tc, 4))
    jc = jkv._scatter_prefix(jc, jb, jidx)
    tc = kvcache._scatter_prefix(tc, tb, tidx)
    _assert_same(jc, tc)


@pytest.mark.parametrize("name,kv_quant", CASES, ids=CASE_IDS)
def test_pool_methods_equal_jax(jx, name, kv_quant):
    jpool, tpool = _pools(jx, name, kv_quant, seed=2)
    rng = np.random.default_rng(3)
    for pool in (jpool, tpool):
        assert pool.assign_many(["a", "b"]) == [0, 1]
        assert pool.assign("c") == 2
    _assert_same(jpool.caches, tpool.caches)
    jpool.release(1)
    tpool.release(1)
    # a fragmented pool: slots 1 and 3 are free, no run of two
    js, jv = jpool.acquire(["d", "e"])
    ts, tv = tpool.acquire(["d", "e"])
    assert js == ts == [1, 3]
    _assert_same(jpool.caches, tpool.caches)
    _assert_same(jv, tv)
    jpool.release_many([0, 1])
    tpool.release_many([0, 1])
    assert jpool.free_slots == tpool.free_slots == 2
    for gather in (False, True):
        js, jv = jpool.acquire(["f", "g"], gather=gather)
        ts, tv = tpool.acquire(["f", "g"], gather=gather)
        assert js == ts == [0, 1]
        _assert_same(jpool.caches, tpool.caches)
        _assert_same(jv, tv)
        _assert_same(jpool.batch_view([0, 1], gather=gather),
                     tpool.batch_view([0, 1], gather=gather))
        jpool.release_many(js)
        tpool.release_many(ts)
    _assert_same(jpool.batch_view([3, 0]), tpool.batch_view([3, 0]))
    jidx, jv = jpool.compact_view([2, 0], 4)
    tidx, tv = tpool.compact_view([2, 0], 4)
    assert jidx == tidx == [2, 0, 2, 2]
    _assert_same(jv, tv)
    with pytest.raises(ValueError, match="do not fit"):
        tpool.compact_view([0, 1, 2], 2)
    jb, tb = _both(jx, _batch_like(rng, tpool.caches, 4))
    jpool.scatter_back([2, 0], jb, lengths=[5, 6])
    tpool.scatter_back([2, 0], tb, lengths=[5, 6])
    jb, tb = _both(jx, _batch_like(rng, tpool.caches, 2))
    jpool.write_back([1, 3], jb, lengths=[7, 8])
    tpool.write_back([1, 3], tb, lengths=[7, 8])
    _assert_same(jpool.caches, tpool.caches)
    assert jpool.lengths == tpool.lengths
    assert jpool.claim(["h"]) == tpool.claim(["h"])
    _assert_same(jpool.caches, tpool.caches)           # claim: no reset
    assert jpool.request_of == tpool.request_of
    with pytest.raises(RuntimeError, match="exhausted"):
        tpool.assign_many(list(range(N_SLOTS)))
    assert tpool.nbytes == sum(int(x.nbytes) for x in
                               jx["jax"].tree.leaves(jpool.caches))


@pytest.fixture(scope="module")
def qwen():
    from repro_torch.models import init_params
    cfg = _cfg("qwen2-0.5b")
    return cfg, init_params(cfg, 0, device="cpu")


@settings(deadline=None, max_examples=6)
@given(mask=st.integers(1, 2 ** N_SLOTS - 1), seed=st.integers(0, 50))
def test_compact_round_trip_leaves_other_slots_untouched(qwen, mask, seed):
    """Property: compact gather -> decode segment -> scatter back touches
    exactly the compacted slots; every other slot's bytes stay as they
    were, and the bookkeeping is undisturbed. The captured segment's
    fixed-width write (padding entries naming the first slot and taking
    the first row) writes the same bytes as ``scatter_back``."""
    cfg, params = qwen
    slots = [i for i in range(N_SLOTS) if mask >> i & 1]
    width = pick_tier(len(slots), width_tiers(N_SLOTS))
    pool = CachePool(cfg, N_SLOTS, MAX_LEN, dtype=torch.float32,
                     kv_quant="int8" if seed % 2 else None, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for _, blk in pool.caches.items():
        for k, x in blk.items():
            if x.is_floating_point():
                x.copy_(torch.randn(x.shape, generator=gen))
    before = {(b, k): x.clone() for b, blk in pool.caches.items()
              for k, x in blk.items()}
    lengths, owners = list(pool.lengths), list(pool.request_of)
    occ = len(slots)
    idx, view = pool.compact_view(slots, width)
    assert idx[:occ] == slots and len(idx) == width
    _, _, _, out = decode_segment(
        cfg, params, torch.zeros((width, 1), dtype=torch.int32),
        torch.full((width, 1), 3, dtype=torch.int32), view, n_steps=2,
        active=torch.arange(width) < occ,
        budget=torch.full((width,), 5, dtype=torch.int32))
    fixed = {b: {k: x.clone() for k, x in blk.items()}
             for b, blk in pool.caches.items()}
    rows = torch.tensor(list(range(occ)) + [0] * (width - occ))
    kvcache._scatter_prefix(fixed, out, torch.tensor(idx), rows)
    pool.scatter_back(slots, out)
    others = [i for i in range(N_SLOTS) if i not in slots]
    changed = False
    for (b, k), x in before.items():
        now = pool.caches[b][k]
        assert torch.equal(now[:, others], x[:, others])
        assert torch.equal(fixed[b][k], now)
        changed |= not torch.equal(now[:, slots], x[:, slots])
    assert changed                  # the live slots actually decoded
    assert pool.lengths == lengths and pool.request_of == owners
