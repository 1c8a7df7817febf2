"""The port's speculative decoding against the JAX package's, on the CPU.

K2 with a query axis: its plain version at S queries a row equals S
single-query calls bit for bit (n_split 1, 2, 3, 5; fp32 and bf16), JAX's
``naive_attention`` over the written-first ring and the Pallas K2 in
interpret mode query by query within 1e-5, and a trailing split of dead
tiles changes no bit. The model: ``attn_verify_chunk``, ``verify_chunk``
and ``spec_round`` against JAX's on bridged smoke weights (fp32 logits
within 1e-4; drafts, verify tokens, positions and lengths exactly; float
K/V within 1e-4 and int8 payloads within one step), and verify logits
equal to stepwise decode logits bit for bit, verify in the spec engine's
ring (``spec_k`` slots longer) at the plain ring's K2 partition. The
pool: ``_scatter_rollback`` against JAX's by ``==``, as a property. The
engine: the spec engine's streams equal the plain engine's over JAX's
matrix (plain, chunked, prefix cache, int8 W+KV, fixed width, multi
lane) and sampled, with a compile-clean window after ``warmup()``;
equal to the JAX spec engine's streams and ``spec_*`` counters; JAX's
configuration errors. The deploy lab's ``spec_decode_cells`` against
JAX's on the same records. JAX is imported in fixtures; the card case
skips without one.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain,
                                                  decode_splits,
                                                  live_tile_counts)
from repro_torch.launch import experiment
from repro_torch.models import (decode_step, forward, make_caches,
                                spec_round, verify_chunk)
from repro_torch.models import attention as ta
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving import kvcache
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.scheduler import pick_tier, width_tiers

requires_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                   reason="needs an NVIDIA GPU with CUDA")
ATOL = 1e-4
ATOL_K2 = 1e-5


def _cfg():
    return dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                               dtype="float32")


CFG = _cfg()
DRAFT_CFG = dataclasses.replace(CFG, name="qwen2-0.5b-smoke-draft",
                                n_layers=1, d_model=112, n_heads=7,
                                n_kv_heads=1, d_ff=256)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.kernels import decode_attention as jda
    from repro.models import attention as ja
    from repro.models import transformer as jt
    from repro.serving import EngineConfig as JaxEngineConfig
    from repro.serving import ServingEngine as JaxServingEngine
    from repro.serving import kvcache as jkv
    from repro.serving.api import SamplingParams as JaxSamplingParams
    jcfg = dataclasses.replace(jax_get_config("qwen2-0.5b", smoke=True),
                               dtype="float32")
    jdcfg = dataclasses.replace(jcfg, name="qwen2-0.5b-smoke-draft",
                                n_layers=1, d_model=112, n_heads=7,
                                n_kv_heads=1, d_ff=256)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    jdp = jt.init_params(jdcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(21)
    jp = jax.tree.map(np.asarray, jp)
    for name in ("bq", "bk", "bv"):       # non-zero biases, as JAX's tests
        a = jp["blocks"]["blk0"]["attn"]
        a[name] = (0.3 * rng.standard_normal(a[name].shape)).astype(
            np.float32)
    jdp = jax.tree.map(np.asarray, jdp)
    return dict(jax=jax, jnp=jnp, jda=jda, ja=ja, jt=jt, jkv=jkv,
                Engine=JaxServingEngine, EngineConfig=JaxEngineConfig,
                Sampling=JaxSamplingParams, cfg=jcfg, dcfg=jdcfg,
                get_config=jax_get_config,
                jp=jax.tree.map(jnp.asarray, jp),
                jdp=jax.tree.map(jnp.asarray, jdp),
                tp=to_torch(jp, device="cpu"),
                tdp=to_torch(jdp, device="cpu"))


# ------------------------------------------------------ K2 with S queries
def _ring(B, S, L, plain_len, seed, Hq=4, Hkv=2, D=32):
    """q (B, S, Hq, D), k/v (B, L, Hkv, D), q_pos (B, S), kv_pos (B, L) of
    a verify chunk right after its write: positions 0..n + S - 1 live,
    the headroom past ``plain_len`` holding positions past every query,
    the rest empty."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, L, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, L, Hkv, D)).astype(np.float32)
    kv_pos = np.full((B, L), -1, np.int32)
    q_pos = np.empty((B, S), np.int32)
    for b in range(B):
        n = int(rng.integers(1, plain_len - S))
        kv_pos[b, :n + S] = np.arange(n + S)
        q_pos[b] = n + np.arange(S)
    kv_pos[:, plain_len:] = np.arange(plain_len, L)
    return q, k, v, q_pos, kv_pos


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_split", [1, 2, 3, 5])
def test_k2s_plain_equals_single_query_calls(n_split, dtype):
    """Query (b, s) of the plain version at S = 4 is what a single-query
    call at q_pos[b, s] over the same ring computes, bit for bit, with
    the visits of each; the wrapper on a CPU tensor is the plain
    version."""
    q, k, v, q_pos, kv_pos = _t(*_ring(3, 4, 170, 166, seed=n_split))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    out, visits = decode_attention_plain(q, k, v, q_pos, kv_pos,
                                         n_split=n_split)
    ones = [decode_attention_plain(q[:, s:s + 1], k, v, q_pos[:, s], kv_pos,
                                   n_split=n_split) for s in range(4)]
    assert torch.equal(out, torch.cat([o for o, _ in ones], 1))
    assert torch.equal(visits.reshape(3, 4, 2),
                       torch.stack([vi.reshape(3, 2) for _, vi in ones], 1))
    assert (visits.numpy() == live_tile_counts(
        q_pos.numpy(), kv_pos.numpy(), n_kv_heads=2)).all()
    before = decode_attention.launches
    assert torch.equal(decode_attention(q, k, v, q_pos, kv_pos,
                                        n_split=n_split), out)
    assert decode_attention.launches == before


@pytest.mark.parametrize("n_split", [1, 2, 3])
def test_k2s_trailing_dead_split_changes_no_bit(n_split):
    """A ring ``spec_k`` slots longer than the plain one, cut at the plain
    ring's partition (``n_split`` runs of ``per_split`` tiles) plus the
    trailing splits that cover it, gives the plain ring's bits: the
    headroom's tiles are dead for every query (positions past them)."""
    plain_len, L = 96, 100            # 3 tiles of 32, then a 4th
    q, k, v, q_pos, kv_pos = _t(*_ring(2, 3, L, plain_len, seed=7))
    per = -(-3 // n_split)
    long_, vis = decode_attention_plain(q, k, v, q_pos, kv_pos,
                                        n_split=n_split, per_split=per)
    short, vis_s = decode_attention_plain(
        q, k[:, :plain_len], v[:, :plain_len], q_pos, kv_pos[:, :plain_len],
        n_split=n_split)
    assert torch.equal(long_, short) and torch.equal(vis, vis_s)
    # and through the ops entry point the model calls
    via = ops.gqa_decode(q, k, v, q_pos, kv_pos,
                         partition=ops.decode_partition(4, 2, plain_len))
    assert torch.equal(via, decode_attention_plain(
        q, k[:, :plain_len], v[:, :plain_len], q_pos, kv_pos[:, :plain_len],
        n_split=decode_splits(4, 2, plain_len)[0])[0])


def test_k2s_plain_matches_jax_naive_attention(jx):
    """Against JAX's ``naive_attention`` over the same written-first ring
    (the JAX verify chunk's attention), fp32, within 1e-5."""
    q, k, v, q_pos, kv_pos = _ring(2, 5, 100, 96, seed=3)
    out, _ = decode_attention_plain(*_t(q, k, v, q_pos, kv_pos), n_split=2)
    jnp = jx["jnp"]
    want = jx["ja"].naive_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(q_pos),
                                    jnp.asarray(kv_pos), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL_K2,
                               rtol=0)


def test_k2s_plain_matches_pallas_per_query(jx):
    """Each query of the chunk against the Pallas K2 (interpret mode, its
    16-slot tile) at that query's position, within 1e-5, with its visit
    counts."""
    B, S, L, Hkv = 2, 3, 64, 2
    q, k, v, q_pos, kv_pos = _ring(B, S, L, 60, seed=9, Hkv=Hkv)
    out, visits = decode_attention_plain(*_t(q, k, v, q_pos, kv_pos),
                                         bk=16)
    G = q.shape[2] // Hkv
    for s in range(S):
        jout, jvis = jx["jda"].decode_attention(
            q[:, s].reshape(B * Hkv, G, -1),
            k.transpose(0, 2, 1, 3).reshape(B * Hkv, L, -1),
            v.transpose(0, 2, 1, 3).reshape(B * Hkv, L, -1),
            np.repeat(q_pos[:, s], Hkv)[:, None],
            np.repeat(kv_pos, Hkv, axis=0), bk=16, interpret=True,
            return_visits=True)
        np.testing.assert_allclose(
            out[:, s].numpy().reshape(np.asarray(jout).shape),
            np.asarray(jout), atol=ATOL_K2, rtol=0)
        np.testing.assert_array_equal(
            visits.numpy().reshape(B, S, Hkv)[:, s].reshape(-1),
            np.asarray(jvis)[:, 0])


@requires_cuda
def test_k2s_cuda_kernel_matches_plain_and_single_query_launches():
    """On the card: the kernel at S = 5 against its plain version (bf16
    q, fp32 ring), and bit for bit against 5 single-query launches and
    against the plain-length ring."""
    q, k, v, q_pos, kv_pos = (t.cuda() for t in _t(*_ring(
        4, 5, 532, 528, seed=1, Hq=14, Hkv=2, D=64)))
    q = q.to(torch.bfloat16)
    part = dict(n_split=9, per_split=2)
    out = decode_attention(q, k, v, q_pos, kv_pos, **part)
    ref, _ = decode_attention_plain(q.float(), k.to(torch.bfloat16).float(),
                                    v.to(torch.bfloat16).float(), q_pos,
                                    kv_pos, **part)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)
    ones = torch.cat([decode_attention(q[:, s:s + 1], k, v, q_pos[:, s],
                                       kv_pos, **part) for s in range(5)], 1)
    short = decode_attention(q, k[:, :528].contiguous(),
                             v[:, :528].contiguous(), q_pos,
                             kv_pos[:, :528].contiguous(), **part)
    assert torch.equal(out, ones) and torch.equal(out, short)


# ------------------------------------------------------------- the model
def _caches_equal(tc, jc):
    for b in jc:
        for key in jc[b]:
            w, g = np.asarray(jc[b][key]), tc[b][key].numpy()
            if w.dtype == np.int8:        # rounding of K/V within 1e-6
                assert np.abs(w.astype(int) - g.astype(int)).max() <= 1
            elif w.dtype == np.int32:
                np.testing.assert_array_equal(g, w, err_msg=f"{b}/{key}")
            else:
                np.testing.assert_allclose(g, w, rtol=ATOL,
                                           atol=ATOL * np.abs(w).max(),
                                           err_msg=f"{b}/{key}")


def _filled(jx, draft, B, L, lens, kv_quant, seed):
    """JAX and port caches of L slots of the target (or the ``draft``),
    prefilled with the same prompts and cut at ``lens`` (the spec
    engine's install)."""
    jnp = jx["jnp"]
    cfg, jcfg, jparams, tparams = (
        (DRAFT_CFG, jx["dcfg"], jx["jdp"], jx["tdp"]) if draft else
        (CFG, jx["cfg"], jx["jp"], jx["tp"]))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, 16)).astype(np.int32)
    jc = jx["jt"].make_caches(jcfg, B, L, dtype=jnp.float32,
                              kv_quant=kv_quant)
    _, jc, _ = jx["jt"].forward(jcfg, jparams, tokens=jnp.asarray(toks),
                                caches=jc, mode="full")
    jc = jx["jkv"]._scatter_rollback(
        jc, jx["jax"].tree.map(jnp.copy, jc), jnp.arange(B, dtype=jnp.int32),
        jnp.asarray(lens))
    tc = make_caches(cfg, B, L, dtype=torch.float32, kv_quant=kv_quant,
                     device="cpu")
    forward(cfg, tparams, tokens=torch.from_numpy(toks).long(), caches=tc,
            return_hidden=True)
    kvcache._scatter_rollback(tc, kvcache._take_slots(tc, torch.arange(B)),
                              torch.arange(B), torch.from_numpy(lens))
    return jc, tc


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["fp32", "int8kv"])
def test_attn_verify_chunk_matches_jax(jx, kv_quant):
    """One layer's ``attn_verify_chunk`` (write first, then attend through
    K2's plain version) against JAX's: out within 1e-4, the written cache
    as ``_caches_equal`` holds it."""
    jnp = jx["jnp"]
    cfg = CFG
    rng = np.random.default_rng(4)
    B, S, L = 2, 3, 24
    lens = np.array([9, 13], np.int32)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = (lens[:, None] + np.arange(S, dtype=np.int32)).astype(np.int32)
    jc, tc = _filled(jx, False, B, L, lens, kv_quant, 5)
    jlayer = jx["jax"].tree.map(lambda t: t[0],
                                jx["jp"]["blocks"]["blk0"]["attn"])
    tlayer = {k: t[0] for k, t in jx["tp"]["blocks"]["blk0"]["attn"].items()}
    want, jcache = jx["ja"].attn_verify_chunk(
        jx["cfg"], jlayer, jnp.asarray(x), jnp.asarray(pos),
        jx["jax"].tree.map(lambda t: t[0], jc["blk0"]))
    tcache = {k: t[0] for k, t in tc["blk0"].items()}
    got, _ = ta.attn_verify_chunk(cfg, tlayer, torch.from_numpy(x),
                                  torch.from_numpy(pos), tcache)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=ATOL,
                               atol=ATOL * np.abs(want).max())
    _caches_equal({"blk0": {k: t[None] for k, t in tcache.items()}},
                  {"blk0": {k: np.asarray(t)[None]
                            for k, t in jcache.items()}})


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["fp32", "int8kv"])
def test_verify_chunk_matches_jax(jx, kv_quant):
    """``verify_chunk`` logits (fp32, within 1e-4) and caches against
    JAX's."""
    jnp = jx["jnp"]
    B, S, L = 2, 4, 26
    lens = np.array([7, 12], np.int32)
    jc, tc = _filled(jx, False, B, L, lens, kv_quant, 6)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, CFG.vocab_size, (B, S)).astype(np.int32)
    pos = (lens[:, None] + np.arange(S, dtype=np.int32)).astype(np.int32)
    want, jc, _ = jx["jt"].verify_chunk(jx["cfg"], jx["jp"],
                                        jnp.asarray(toks),
                                        jnp.asarray(pos), jc)
    got = verify_chunk(CFG, jx["tp"], torch.from_numpy(toks).long(),
                       torch.from_numpy(pos), tc)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=ATOL,
                               atol=ATOL * np.abs(want).max())
    _caches_equal(tc, jc)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["fp32", "int8kv"])
def test_spec_round_matches_jax(jx, kv_quant, sampled):
    """``spec_round`` (a separate draft model, k = 2) against JAX's: the
    drafts and the verify tokens exactly, both caches as
    ``_caches_equal`` holds them."""
    jnp = jx["jnp"]
    B, k, L = 3, 2, 30
    lens = np.array([5, 9, 14], np.int32)
    jc, tc = _filled(jx, False, B, L, lens, kv_quant, 8)
    jd, td = _filled(jx, True, B, L, lens, None, 8)
    tok = np.array([[3], [17], [40]], np.int32)
    pos = lens[:, None].copy()
    samp = {}
    if sampled:
        samp = dict(temperature=np.array([0.8, 0.0, 1.2], np.float32),
                    top_k=np.array([5, 0, 0], np.int32),
                    seed=np.array([1, 2, 3], np.int32))
    jdr, jver, jc, jd = jx["jt"].spec_round(
        jx["cfg"], jx["jp"], jx["dcfg"], jx["jdp"], jnp.asarray(tok),
        jnp.asarray(pos), jc, jd, k=k,
        **{n: jnp.asarray(a) for n, a in samp.items()})
    tdr, tver, tc, td = spec_round(
        CFG, jx["tp"], DRAFT_CFG, jx["tdp"], torch.from_numpy(tok),
        torch.from_numpy(pos), tc, td, k=k,
        **{n: torch.from_numpy(a) for n, a in samp.items()})
    np.testing.assert_array_equal(tdr.numpy(), np.asarray(jdr))
    np.testing.assert_array_equal(tver.numpy(), np.asarray(jver))
    _caches_equal(tc, jc)
    _caches_equal(td, jd)


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["fp32", "int8kv"])
@pytest.mark.parametrize("spec_k", [1, 2, 3])
def test_verify_equals_stepwise_decode(jx, spec_k, kv_quant):
    """Bucket 16 with 16 new tokens: the plain ring is 32 slots, one whole
    tile, and the spec ring's ``spec_k`` slots of headroom add a tile.
    Verify in the spec ring at the plain ring's partition
    (``ops.decode_partition`` at width 4) gives the logits of spec_k + 1
    decode steps in the plain ring bit for bit, over two rounds with a
    rollback between."""
    tp = jx["tp"]
    B, Lp = 3, 32
    Ls = Lp + spec_k
    rng = np.random.default_rng(spec_k)
    lens = np.array([4, 9, 15], np.int32)
    toks = torch.from_numpy(rng.integers(0, CFG.vocab_size, (B, 16)))
    plain = make_caches(CFG, B, Lp, dtype=torch.float32, kv_quant=kv_quant,
                        device="cpu")
    spec = make_caches(CFG, B, Ls, dtype=torch.float32, kv_quant=kv_quant,
                       device="cpu")
    forward(CFG, tp, tokens=toks, caches=plain, return_hidden=True)
    forward(CFG, tp, tokens=toks, caches=spec, return_hidden=True)
    kvcache._scatter_rollback(spec, kvcache._take_slots(
        spec, torch.arange(B)), torch.arange(B), torch.from_numpy(lens))
    cpos = lens.copy()
    for _ in range(2):
        chunk = torch.from_numpy(rng.integers(0, CFG.vocab_size,
                                              (B, spec_k + 1)))
        pos = torch.from_numpy(cpos[:, None] + np.arange(
            spec_k + 1, dtype=np.int32))
        want = torch.cat([decode_step(CFG, tp, chunk[:, s:s + 1],
                                      pos[:, s:s + 1], plain,
                                      decode_width=4)
                          for s in range(spec_k + 1)], 1)
        got = verify_chunk(CFG, tp, chunk, pos, spec,
                           partition=ops.decode_partition(
                               4, CFG.n_kv_heads, Lp))
        assert torch.equal(got, want)
        cpos = cpos + rng.integers(1, spec_k + 2, B).astype(np.int32)
        kvcache._scatter_rollback(spec, kvcache._take_slots(
            spec, torch.arange(B)), torch.arange(B), torch.from_numpy(cpos))


# ------------------------------------------------------------- the pool
@settings(deadline=None, max_examples=6)
@given(mask=st.integers(1, 2 ** 4 - 1), seed=st.integers(0, 50),
       base_bound=st.integers(0, 5))
def test_scatter_rollback_matches_jax(jx, mask, seed, base_bound):
    """Property (JAX's ``tests/test_spec_decode.py``): a compacted view's
    live rows rolled back per row into the pool, through
    ``CachePool.scatter_rollback``, leave the pool equal to JAX's by
    ``==`` (the other slots untouched, positions at or past each row's
    boundary the sentinel, ``len`` clamped, payloads copied), float and
    int8 KV."""
    jnp, jax = jx["jnp"], jx["jax"]
    slots = [i for i in range(4) if mask >> i & 1]
    occ = len(slots)
    width = pick_tier(occ, width_tiers(4))
    bnds = [(base_bound + j) % 6 for j in range(occ)]
    for kv_quant in (None, "int8"):
        rng = np.random.default_rng(seed)
        jpool = jx["jkv"].CachePool(jx["cfg"], 4, 12, dtype=jnp.float32,
                                    kv_quant=kv_quant)
        tpool = kvcache.CachePool(CFG, 4, 12, dtype=torch.float32,
                                  kv_quant=kv_quant, device="cpu")

        def fill(tree, n):
            out = {}
            for b, blk in tree.items():
                out[b] = {}
                for key, x in blk.items():
                    shape = (x.shape[0], n, *x.shape[2:])
                    if key == "pos":
                        a = rng.integers(-1, 12, shape)
                    elif key == "len":
                        a = rng.integers(0, 12, shape)
                    elif x.dtype in (torch.int8, jnp.int8):
                        a = rng.integers(-127, 128, shape)
                    else:
                        a = rng.standard_normal(shape)
                    out[b][key] = a.astype(np.asarray(x).dtype
                                           if not torch.is_tensor(x) else
                                           x.numpy().dtype)
            return out
        home = fill(tpool.caches, 4)
        view = fill(tpool.caches, width)
        jpool.caches = jax.tree.map(jnp.asarray, home)
        tpool.caches = to_torch(home, device="cpu")
        jpool.scatter_rollback(slots, jax.tree.map(jnp.asarray, view), bnds)
        tpool.scatter_rollback(slots, to_torch(view, device="cpu"), bnds)
        for b in home:
            for key in home[b]:
                assert (tpool.caches[b][key].numpy()
                        == np.asarray(jpool.caches[b][key])).all(), \
                    (kv_quant, b, key)


# ------------------------------------------------------------- the engine
BASE = dict(mode="decoder", max_batch=2, max_new_tokens=4,
            pad_buckets=(16, 32), decode_segment=2)
MATRIX = [
    ("plain", {}),
    ("chunked", dict(prefill_chunk=8)),
    ("prefix_cache", dict(prefill_chunk=8, prefix_cache=True)),
    ("quant", dict(kv_quant="int8", weight_quant="int8")),
    ("segment_fixed", dict(segment_width="fixed")),
    ("multi_lane", dict(multi_lane=True)),
]


def _traffic(seed=23):
    """JAX's four prompts over both buckets: [1] shares a 10-token
    prefix with [0], [3] spans several chunks, [2] has a budget of 2."""
    rng = np.random.RandomState(seed)
    p0 = rng.randint(0, CFG.vocab_size, (14,))
    prompts = [p0, np.concatenate([p0[:10], rng.randint(0, CFG.vocab_size,
                                                        (4,))]),
               rng.randint(0, CFG.vocab_size, (9,)),
               rng.randint(0, CFG.vocab_size, (27,))]
    return prompts, [{}, {}, dict(max_new_tokens=2), {}]


def _serve(eng, prompts, sampling, Sampling, sequential):
    if sequential:
        return [np.asarray(eng.generate(p, Sampling(**s)).result(
            timeout=300).tokens) for p, s in zip(prompts, sampling)]
    hs = [eng.generate(p, Sampling(**s)) for p, s in zip(prompts, sampling)]
    return [np.asarray(h.result(timeout=300).tokens) for h in hs]


def _port(jx, spec, **kw):
    ec = EngineConfig(**dict(BASE, **(dict(spec_decode=True, spec_k=2)
                                      if spec else {}), **kw))
    return ServingEngine(CFG, jx["tp"], ec, device="cpu",
                         draft=(DRAFT_CFG, jx["tdp"]) if spec else None)


@pytest.mark.parametrize("name,feat", MATRIX, ids=[m[0] for m in MATRIX])
def test_spec_engine_equals_plain_engine(jx, name, feat):
    """The spec engine's streams are the plain engine's under every
    stacked feature of JAX's matrix, and its window after ``warmup()``
    builds no program."""
    prompts, sampling = _traffic()
    sequential = name == "prefix_cache"
    base = _port(jx, False, **feat)
    try:
        want = _serve(base, prompts, sampling, SamplingParams, sequential)
    finally:
        base.close()
    eng = _port(jx, True, **feat)
    try:
        eng.warmup()
        eng.window()
        got = _serve(eng, prompts, sampling, SamplingParams, sequential)
        w = eng.window()
    finally:
        eng.close()
    assert w["jit_compiles"] == 0
    lanes = w["lanes"].values()
    assert sum(s["spec_rounds"] for s in lanes) >= 1
    assert sum(s["spec_proposed"] for s in lanes) > 0
    if sequential:
        assert sum(s["prefix_hits"] for s in lanes) >= 1
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(a, b, err_msg=f"{name} {i}")
        assert len(b) == (sampling[i].get("max_new_tokens") or 4)


@pytest.mark.parametrize("sampled", [False, True], ids=["plain", "sampled"])
def test_spec_engine_matches_jax_spec_engine(jx, sampled):
    """The port's spec engine and JAX's on the same bridged weights and
    traffic: equal streams, equal ``spec_rounds``/``spec_proposed``/
    ``spec_accepted`` per lane; sampled, also equal to the port's plain
    engine."""
    prompts, sampling = _traffic()
    if sampled:
        sampling = [dict(temperature=0.8, top_k=16, seed=9), {},
                    dict(temperature=1.1, seed=4, max_new_tokens=2), {}]
    jeng = jx["Engine"](jx["cfg"], jx["jp"], jx["EngineConfig"](
        **BASE, spec_decode=True, spec_k=2), draft=(jx["dcfg"], jx["jdp"]))
    try:
        want = _serve(jeng, prompts, sampling, jx["Sampling"], False)
        jl = jeng.metrics()["lanes"]
    finally:
        jeng.close()
    eng = _port(jx, True)
    try:
        got = _serve(eng, prompts, sampling, SamplingParams, False)
        tl = eng.metrics()["lanes"]
    finally:
        eng.close()
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    keys = ("spec_rounds", "spec_proposed", "spec_accepted")
    assert {b: {k: tl[b][k] for k in keys} for b in tl} == \
        {b: {k: jl[b][k] for k in keys} for b in jl}
    if sampled:
        plain = _port(jx, False)
        try:
            ref = _serve(plain, prompts, sampling, SamplingParams, False)
        finally:
            plain.close()
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["no_draft", "spec_k", "not_continuous",
                                  "vocab", "target_pattern",
                                  "draft_pattern"])
def test_spec_engine_config_errors_are_jax_errors(jx, case):
    """JAX's validation: a missing draft, spec_k < 1, the batch-at-a-time
    path, a draft of another vocabulary, a target or draft that is not
    pure global attention. The port raises the ValueError JAX raises,
    with JAX's message."""
    hyb = dataclasses.replace(get_config("recurrentgemma-9b", smoke=True),
                              dtype="float32")
    jhyb = dataclasses.replace(jx["get_config"]("recurrentgemma-9b",
                                                smoke=True), dtype="float32")
    kw, draft, cfg = dict(spec_decode=True), (DRAFT_CFG, jx["tdp"]), CFG
    jdraft, jcfg = (jx["dcfg"], jx["jdp"]), jx["cfg"]
    if case == "no_draft":
        draft = jdraft = None
    elif case == "spec_k":
        kw["spec_k"] = 0
    elif case == "not_continuous":
        kw["continuous"] = False
    elif case == "vocab":
        draft = (dataclasses.replace(DRAFT_CFG, vocab_size=77), jx["tdp"])
        jdraft = (dataclasses.replace(jx["dcfg"], vocab_size=77), jx["jdp"])
    elif case == "target_pattern":
        cfg, jcfg = hyb, jhyb
    else:
        draft, jdraft = (hyb, jx["tdp"]), (jhyb, jx["jdp"])
    with pytest.raises(ValueError) as want:
        jx["Engine"](jcfg, jx["jp"], jx["EngineConfig"](**BASE, **kw),
                     draft=jdraft)
    with pytest.raises(ValueError) as got:
        ServingEngine(cfg, jx["tp"], EngineConfig(**BASE, **kw),
                      device="cpu", draft=draft)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ the lab
def test_spec_decode_cells_match_jax(jx):
    """The lab's ``spec_decode_cells`` against JAX's pricer on the same
    records: two profiles, the A/B pair each, and a record of another
    scenario, which both skip."""
    from repro.launch import experiment as jexp

    def rec(name, machine, rps, tps, prop, acc):
        return {"scenario": {"name": name},
                "profile": {"provider": "AWS", "machine": machine,
                            "hourly_cost_usd": 0.5 + len(machine)},
                "cells": [{"requests_per_s": rps, "tokens_per_s": tps}],
                "engine_window": {"lanes": {
                    16: {"spec_proposed": prop, "spec_accepted": acc},
                    32: {"spec_proposed": 2 * prop,
                         "spec_accepted": acc // 2}}}}
    records = [rec("staggered_spec", "C", 3.0, 40.0, 0, 0),
               rec("staggered_spec_sd", "C", 2.5, 33.0, 40, 9),
               rec("staggered_spec", "G", 5.0, 70.0, 0, 0),
               rec("staggered_spec_sd", "G", 6.0, 81.0, 12, 7),
               rec("staggered_quant", "G", 1.0, 1.0, 0, 0)]
    got = experiment.spec_decode_cells(records)
    assert got == jexp.spec_decode_cells(records)
    assert [c["profile"] for c in got] == ["AWS/C", "AWS/G"]
