"""The port's decoder path (Qwen2) and K2 against the JAX package.

K2's plain version is held against the Pallas kernel in interpret mode
and the jnp oracle on the same numpy inputs, in fp32 (atol 2e-5: the two
sum in different orders), with visit counts equal to the Pallas kernel's
and to ``live_tile_counts``. The Qwen2 smoke model (fp32, weights
initialized in JAX, biases made non-zero, bridged through numpy) is held
against JAX layer by layer: rope, ``attn_decode`` with its returned cache,
``forward`` logits in full and decode mode (atol 1e-4), ``decode_segment``
tokens and state, ``decode_loop``, ``sample_logits`` and the threefry bits
(exact). The
cases marked ``requires_cuda`` launch the CUDA kernel and skip on a host
without a card; they need no JAX, which is imported in a fixture.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (BLOCK_K, decode_attention,
                                                  decode_attention_plain,
                                                  decode_splits,
                                                  live_tile_counts)
from repro_torch.models import (decode_loop, decode_segment, forward,
                                init_params, make_caches, sample_logits)
from repro_torch.models import attention as ta
from repro_torch.models import layers as tl
from repro_torch.models import threefry

requires_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                   reason="needs an NVIDIA GPU with CUDA")
ATOL_K2 = 2e-5
ATOL = 1e-4
CFG = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                          dtype="float32")

# K2 settings: (B, L, Hq, Hkv, D, kv_pos pattern, options).
# Patterns: "full" 0..L-1, "prefix" a short live prefix then empty slots,
# "ring" a wrapped ring (positions above L), "holes" empty slots (-1)
# scattered through live ones. The query sits at the newest position.
K2_CASES = {
    "full": (2, 64, 4, 2, 32, "full", {}),
    "short_prefix": (2, 128, 4, 2, 32, "prefix", {}),
    "wrapped_ring": (2, 64, 4, 2, 32, "ring", {}),
    "empty_slots": (2, 64, 4, 2, 32, "holes", {}),
    "window": (2, 128, 4, 2, 32, "ring", dict(window=40)),
    "softcap": (1, 64, 4, 2, 32, "full", dict(softcap=5.0)),
    "g1": (2, 48, 2, 2, 16, "full", {}),
    "g7": (2, 64, 14, 2, 64, "prefix", {}),
    "g7_window": (1, 96, 14, 2, 64, "ring", dict(window=20, softcap=30.0)),
}

# Split-KV settings, same layout: "dead_split" leaves the later splits with
# no live tile; "g16_d256" is the hybrid's G = 16 query heads over one kv
# head of 256.
SPLIT_CASES = {
    "dead_split": (2, 128, 4, 2, 32, "prefix", {}),
    "wrapped_ring": (2, 96, 4, 2, 32, "ring", {}),
    "window": (2, 128, 4, 2, 32, "ring", dict(window=40)),
    "softcap": (1, 96, 4, 2, 32, "full", dict(softcap=5.0)),
    "g16_d256": (2, 64, 16, 1, 256, "ring", {}),
}
SPLITS = (1, 2, 3, 5)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.kernels import decode_attention as jda
    from repro.kernels import ref
    from repro.models import attention as ja
    from repro.models import layers as jl
    from repro.models import transformer as jt
    jcfg = dataclasses.replace(jax_get_config("qwen2-0.5b", smoke=True),
                               dtype="float32")
    return dict(jax=jax, jnp=jnp, jda=jda, ref=ref, ja=ja, jl=jl, jt=jt,
                cfg=jcfg, get_config=jax_get_config)


@pytest.fixture(scope="module")
def weights(jx):
    """JAX-initialized smoke weights with random (non-zero) QKV biases, as
    (jax tree, torch tree)."""
    jax, jnp = jx["jax"], jx["jnp"]
    jp = jax.tree.map(np.asarray, jx["jt"].init_params(
        jx["cfg"], jax.random.PRNGKey(0)))
    rng = np.random.default_rng(11)
    attn = jp["blocks"]["blk0"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name] = (0.3 * rng.standard_normal(attn[name].shape)
                      ).astype(np.float32)
    return jax.tree.map(jnp.asarray, jp), to_torch(jp, device="cpu")


def _kv_pos(pattern, B, L, seed=0):
    rng = np.random.default_rng(seed)
    pos = np.empty((B, L), np.int32)
    q_pos = np.empty(B, np.int32)
    for b in range(B):
        if pattern == "full":
            n = L
            pos[b] = np.arange(L)
        elif pattern == "prefix":
            n = int(rng.integers(1, L // 3))
            pos[b] = np.where(np.arange(L) < n, np.arange(L), -1)
        elif pattern == "ring":            # positions L + s wrapped at % L
            n = L + int(rng.integers(1, L))
            p = np.arange(n)
            pos[b, p[-L:] % L] = p[-L:]
        else:                              # holes
            n = L
            pos[b] = np.arange(L)
            pos[b, rng.choice(L - 1, L // 4, replace=False)] = -1
        q_pos[b] = n - 1
    return q_pos, pos


def _k2_inputs(case, seed=0, D=None):
    B, L, Hq, Hkv, case_d, pattern, kw = {**K2_CASES, **SPLIT_CASES}[case]
    D = D or case_d
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, L, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, L, Hkv, D)).astype(np.float32)
    q_pos, kv_pos = _kv_pos(pattern, B, L, seed)
    return q, k, v, q_pos, kv_pos, kw


def _tensors(*xs):
    return [torch.from_numpy(x) for x in xs]


def _pallas_layout(q, k, v, q_pos, kv_pos):
    """(B, 1, Hq, D) etc. -> the TPU kernel's (B*Hkv, G, D) etc."""
    B, _, Hq, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    return (q[:, 0].reshape(B * Hkv, G, D),
            k.transpose(0, 2, 1, 3).reshape(B * Hkv, L, D),
            v.transpose(0, 2, 1, 3).reshape(B * Hkv, L, D),
            np.repeat(q_pos, Hkv)[:, None], np.repeat(kv_pos, Hkv, axis=0))


# ------------------------------------------------------------------ K2
@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_plain_matches_pallas_kernel(case, jx):
    q, k, v, q_pos, kv_pos, kw = _k2_inputs(case)
    out, visits = decode_attention_plain(*_tensors(q, k, v, q_pos, kv_pos),
                                         bk=16, **kw)
    jq, jk, jv, jqp, jkvp = _pallas_layout(q, k, v, q_pos, kv_pos)
    jout, jvis = jx["jda"].decode_attention(jq, jk, jv, jqp, jkvp, bk=16,
                                            interpret=True,
                                            return_visits=True, **kw)
    B, _, Hq, D = q.shape
    np.testing.assert_allclose(out.numpy().reshape(-1, Hq // k.shape[2], D),
                               np.asarray(jout), atol=ATOL_K2, rtol=0)
    np.testing.assert_array_equal(visits.numpy(), np.asarray(jvis)[:, 0])
    np.testing.assert_array_equal(
        visits.numpy(), live_tile_counts(q_pos, kv_pos, bk=16,
                                         window=kw.get("window"),
                                         n_kv_heads=k.shape[2]))


@pytest.mark.parametrize("case", sorted(K2_CASES) + ["ragged"])
def test_k2_plain_matches_reference(case, jx):
    """At the kernel's own tile (32) and, for "ragged", an L that is no
    multiple of it (the Pallas kernel needs whole tiles; the oracle does
    not)."""
    if case == "ragged":
        q, k, v, q_pos, kv_pos, kw = _k2_inputs("wrapped_ring", seed=3)
        k, v, kv_pos = k[:, :53], v[:, :53], kv_pos[:, :53]
        q_pos = np.maximum(q_pos, kv_pos.max(1))
    else:
        q, k, v, q_pos, kv_pos, kw = _k2_inputs(case, seed=1)
    out, visits = decode_attention(*_tensors(q, k, v, q_pos, kv_pos),
                                   return_visits=True, **kw)
    jq, jk, jv, jqp, jkvp = _pallas_layout(q, k, v, q_pos, kv_pos)
    want = jx["ref"].decode_attention_ref(jq, jk, jv, jqp[:, 0], jkvp,
                                          window=kw.get("window"),
                                          softcap=kw.get("softcap"))
    np.testing.assert_allclose(out.numpy().reshape(np.asarray(want).shape),
                               np.asarray(want), atol=ATOL_K2, rtol=0)
    np.testing.assert_array_equal(
        visits.numpy(), live_tile_counts(q_pos, kv_pos, bk=BLOCK_K,
                                         window=kw.get("window"),
                                         n_kv_heads=k.shape[2]))


_PALLAS_SPLIT = {}


@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_k2_split_plain_matches_pallas_kernel(case, n_split, jx):
    """The per-split partials and their fold against the single-pass
    Pallas kernel (interpret mode, the same 16-slot tile); the visits
    equal its counts for every split count."""
    q, k, v, q_pos, kv_pos, kw = _k2_inputs(case, seed=4)
    out, visits = decode_attention_plain(*_tensors(q, k, v, q_pos, kv_pos),
                                         bk=16, n_split=n_split, **kw)
    if case not in _PALLAS_SPLIT:
        jq, jk, jv, jqp, jkvp = _pallas_layout(q, k, v, q_pos, kv_pos)
        jout, jvis = jx["jda"].decode_attention(
            jq, jk, jv, jqp, jkvp, bk=16, interpret=True,
            return_visits=True, **kw)
        _PALLAS_SPLIT[case] = np.asarray(jout), np.asarray(jvis)[:, 0]
    jout, jvis = _PALLAS_SPLIT[case]
    np.testing.assert_allclose(out.numpy().reshape(jout.shape), jout,
                               atol=ATOL_K2, rtol=0)
    np.testing.assert_array_equal(visits.numpy(), jvis)
    np.testing.assert_array_equal(
        visits.numpy(), live_tile_counts(q_pos, kv_pos, bk=16,
                                         window=kw.get("window"),
                                         n_kv_heads=k.shape[2]))


@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("case", sorted(SPLIT_CASES) + ["ragged"])
def test_k2_split_plain_matches_reference(case, n_split, jx):
    """At the kernel's tile of 32, against the jnp oracle; "ragged" has an
    L of 53, no multiple of the tile."""
    if case == "ragged":
        q, k, v, q_pos, kv_pos, kw = _k2_inputs("wrapped_ring", seed=5)
        k, v, kv_pos = k[:, :53], v[:, :53], kv_pos[:, :53]
        q_pos = np.maximum(q_pos, kv_pos.max(1))
    else:
        q, k, v, q_pos, kv_pos, kw = _k2_inputs(case, seed=6)
    out, visits = decode_attention_plain(*_tensors(q, k, v, q_pos, kv_pos),
                                         n_split=n_split, **kw)
    jq, jk, jv, jqp, jkvp = _pallas_layout(q, k, v, q_pos, kv_pos)
    want = jx["ref"].decode_attention_ref(jq, jk, jv, jqp[:, 0], jkvp,
                                          window=kw.get("window"),
                                          softcap=kw.get("softcap"))
    np.testing.assert_allclose(out.numpy().reshape(np.asarray(want).shape),
                               np.asarray(want), atol=ATOL_K2, rtol=0)
    np.testing.assert_array_equal(
        visits.numpy(), live_tile_counts(q_pos, kv_pos, bk=BLOCK_K,
                                         window=kw.get("window"),
                                         n_kv_heads=k.shape[2]))


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_k2_split_counts_keep_visits_and_empty_rows(case):
    """Every split count visits the same tiles; a split past the last
    tile is empty; a row with no live slot gives the single pass's
    result (zeros) exactly, whatever the split count."""
    q, k, v, q_pos, kv_pos, kw = _k2_inputs(case, seed=7)
    kv_pos[0] = -1                              # row 0: no live slot
    args = _tensors(q, k, v, q_pos, kv_pos)
    one, one_visits = decode_attention_plain(*args, n_split=1, **kw)
    n_tiles = -(-k.shape[1] // BLOCK_K)
    assert not one[0].any()
    for n_split in range(2, n_tiles + 3):
        out, visits = decode_attention_plain(*args, n_split=n_split, **kw)
        assert torch.equal(visits, one_visits)
        assert torch.equal(out[0], one[0])
        torch.testing.assert_close(out, one, atol=ATOL_K2, rtol=0)
    with pytest.raises(ValueError, match="n_split"):
        decode_attention_plain(*args, n_split=0)


def test_k2_split_count_is_a_function_of_shapes():
    """``decode_splits`` sees (B, Hkv, L) only, never gives more splits
    than tiles or an empty split, and aims at two blocks per SM: equal
    runs of tiles may round that down, but never below half of it; the
    CPU wrapper runs the plain version at that count."""
    assert decode_splits(32, 2, 144) == (5, 1)      # Qwen2 decode
    assert decode_splits(32, 1, 144) == (5, 1)      # the hybrid's
    assert decode_splits(1, 2, 4096) == (128, 1)
    assert decode_splits(32, 2, 4096) == (5, 26)
    for B in (1, 3, 16, 32, 200):
        for Hkv in (1, 2, 8):
            for L in (1, 31, 32, 33, 144, 528, 4096):
                n, per = decode_splits(B, Hkv, L)
                n_tiles = -(-L // BLOCK_K)
                assert 1 <= n <= n_tiles and per >= 1
                assert (n - 1) * per < n_tiles <= n * per
                assert 2 * B * Hkv * n >= min(264, B * Hkv * n_tiles)
    q, k, v, q_pos, kv_pos, kw = _k2_inputs("wrapped_ring", seed=8)
    args = _tensors(q, k, v, q_pos, kv_pos)
    n = decode_splits(q.shape[0], k.shape[2], k.shape[1])[0]
    assert n > 1
    assert torch.equal(decode_attention(*args),
                       decode_attention_plain(*args, n_split=n)[0])
    assert torch.equal(decode_attention(*args, n_split=1),
                       decode_attention_plain(*args)[0])


def test_gqa_decode_width_fixes_the_split_count():
    """``ops.gqa_decode(..., width=)`` runs K2 at ``decode_splits(width,
    Hkv, L)`` splits whatever B is; without ``width`` the count follows B
    (at L = 528 and two kv heads: 17 splits at B = 1, 5 at B = 32). On
    the card that keeps a row's bits alone or in a batch
    (``test_k2_cuda_rows_are_bit_equal_across_batch_widths``)."""
    B, L, Hq, Hkv, D = 8, 528, 4, 2, 64
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, 1, Hq, D), (B, L, Hkv, D), (B, L, Hkv, D)))
    q_pos = torch.from_numpy(rng.integers(300, L, B).astype(np.int32))
    kv_pos = torch.arange(L, dtype=torch.int32).expand(B, L).contiguous()
    assert decode_splits(1, Hkv, L)[0] == 17
    assert decode_splits(32, Hkv, L)[0] == 5
    full = ops.gqa_decode(q, k, v, q_pos, kv_pos, width=32)
    assert torch.equal(full, decode_attention_plain(
        q, k, v, q_pos, kv_pos, n_split=5)[0])
    for b in (1, 2, 4):
        got = ops.gqa_decode(q[:b], k[:b], v[:b], q_pos[:b], kv_pos[:b],
                             width=32)
        assert torch.equal(got, decode_attention_plain(
            q[:b], k[:b], v[:b], q_pos[:b], kv_pos[:b], n_split=5)[0])
    assert torch.equal(ops.gqa_decode(q[:1], k[:1], v[:1], q_pos[:1],
                                      kv_pos[:1]),
                       decode_attention_plain(q[:1], k[:1], v[:1],
                                              q_pos[:1], kv_pos[:1],
                                              n_split=17)[0])


def test_k2_visits_skip_dead_tiles():
    """A short request in a long ring pays for its live tiles only; a
    window bounds the sweep whatever the ring's length (the JAX test
    test_decode_attention_early_out, at the port's tile of 32)."""
    L = 256
    q, k, v = _tensors(*(np.random.default_rng(0).standard_normal(s)
                         .astype(np.float32)
                         for s in ((1, 1, 4, 32), (1, L, 2, 32),
                                   (1, L, 2, 32))))
    for valid, window, want in [(17, None, 1), (120, None, 4),
                                (256, None, 8), (120, 40, 2)]:
        kv_pos = torch.where(torch.arange(L) < valid, torch.arange(L),
                             -1).to(torch.int32)[None]
        q_pos = torch.tensor([valid - 1], dtype=torch.int32)
        _, visits = decode_attention(q, k, v, q_pos, kv_pos, window=window,
                                     return_visits=True)
        assert visits.tolist() == [want, want]


def test_k2_cpu_wrapper_runs_plain_version_without_launching():
    q, k, v, q_pos, kv_pos, kw = _k2_inputs("g7")
    args = _tensors(q, k, v, q_pos, kv_pos)
    before = decode_attention.launches
    assert torch.equal(decode_attention(*args), decode_attention_plain(
        *args)[0])
    assert torch.equal(ops.gqa_decode(*args), decode_attention_plain(
        *args, bk=ops.attn_block_sizes("decode", 1)[1])[0])
    assert decode_attention.launches == before
    assert ops.attn_block_sizes("decode", 1) == (1, BLOCK_K)


def test_k2_bf16_query_rounds_an_fp32_cache_on_load():
    """An fp32 cache under a bf16 q reads as the cache cast to bf16 (the
    model's _cache_read_kv), with no copy of the cache."""
    q, k, v, q_pos, kv_pos, _ = _k2_inputs("g7_window")
    q, k, v, q_pos, kv_pos = _tensors(q, k, v, q_pos, kv_pos)
    qb = q.to(torch.bfloat16)
    got = decode_attention_plain(qb, k, v, q_pos, kv_pos)[0]
    want = decode_attention_plain(qb, k.to(torch.bfloat16),
                                  v.to(torch.bfloat16), q_pos, kv_pos)[0]
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_k2_bad_inputs_raise():
    q, k, v, q_pos, kv_pos, _ = _k2_inputs("full")
    q, k, v, q_pos, kv_pos = _tensors(q, k, v, q_pos, kv_pos)
    with pytest.raises(ValueError, match="multiple"):
        decode_attention(q[:, :, :3], k, v, q_pos, kv_pos)
    with pytest.raises(ValueError, match="q must be"):
        decode_attention(q[:, 0], k, v, q_pos, kv_pos)
    # two queries a row (a verify chunk) need a position each
    with pytest.raises(ValueError, match="q_pos"):
        decode_attention(q.expand(-1, 2, -1, -1), k, v, q_pos, kv_pos)
    with pytest.raises(ValueError, match="kv_pos"):
        decode_attention(q, k, v, q_pos, kv_pos[:, :5])
    with pytest.raises(ValueError, match="window"):
        decode_attention(q, k, v, q_pos, kv_pos, window=0)
    with pytest.raises(ValueError, match="softcap"):
        decode_attention(q, k, v, q_pos, kv_pos, softcap=-1.0)


# -------------------------------------------------------- model layers
def test_apply_rope_matches_jax(jx):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 600, (2, 9)).astype(np.int32)
    want = jx["jl"].apply_rope(jx["jnp"].asarray(x), jx["jnp"].asarray(pos),
                               1e6)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def _one_layer(tree):
    return {k: (_one_layer(v) if isinstance(v, dict) else v[0])
            for k, v in tree.items()}


def _cache(L, B, seed, wrap):
    """A filled fp32 cache as numpy: k/v random, pos a row-wise ring."""
    rng = np.random.default_rng(seed)
    shape = (B, L, CFG.n_kv_heads, CFG.head_dim_)
    pos = np.full((B, L), -1, np.int32)
    lens = np.empty(B, np.int32)
    for b in range(B):
        n = L + 5 + b if wrap else 7 + 3 * b
        p = np.arange(n)[-L:]
        pos[b, p % L] = p
        lens[b] = n
    return {"k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32),
            "pos": pos, "len": lens}


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("plain_attention", [False, True])
def test_attn_decode_matches_jax(jx, weights, wrap, plain_attention):
    jp, tp = weights
    jnp = jx["jnp"]
    B, L = 3, 24
    c = _cache(L, B, seed=4, wrap=wrap)
    x = np.random.default_rng(5).standard_normal(
        (B, 1, CFG.d_model)).astype(np.float32)
    positions = c["len"][:, None].copy()
    jout, jcache = jx["ja"].attn_decode(
        jx["cfg"], _one_layer(jp["blocks"]["blk0"]["attn"]), jnp.asarray(x),
        jnp.asarray(positions), {k: jnp.asarray(a) for k, a in c.items()})
    tcache = {k: torch.from_numpy(a.copy()) for k, a in c.items()}
    tout, ret = ta.attn_decode(CFG, _one_layer(tp["blocks"]["blk0"]["attn"]),
                               torch.from_numpy(x),
                               torch.from_numpy(positions), tcache,
                               plain_attention=plain_attention)
    assert ret is tcache                         # written in place
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    for key in ("pos", "len"):
        np.testing.assert_array_equal(tcache[key].numpy(),
                                      np.asarray(jcache[key]))
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=2e-5,
                                   rtol=0)


@pytest.mark.parametrize("S,L", [(10, 16), (20, 16)])
def test_attn_apply_fills_the_cache_like_jax(jx, weights, S, L):
    """Prefill's cache fill, including the S >= L branch that keeps the
    last L positions in slots 0..L-1."""
    jp, tp = weights
    jnp = jx["jnp"]
    B = 2
    x = np.random.default_rng(6).standard_normal(
        (B, S, CFG.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    empty = {k: np.asarray(a) for k, a in jx["ja"].make_cache(
        jx["cfg"], B, L, dtype=jnp.float32).items()}
    jout, jcache = jx["ja"].attn_apply(
        jx["cfg"], _one_layer(jp["blocks"]["blk0"]["attn"]), jnp.asarray(x),
        jnp.asarray(pos), cache={k: jnp.asarray(a) for k, a in empty.items()})
    tcache = ta.make_cache(CFG, B, L, dtype=torch.float32, device="cpu")
    tout, _ = ta.attn_apply(CFG, _one_layer(tp["blocks"]["blk0"]["attn"]),
                            torch.from_numpy(x), torch.from_numpy(pos),
                            causal=True, cache=tcache)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    for key in ("pos", "len"):
        np.testing.assert_array_equal(tcache[key].numpy(),
                                      np.asarray(jcache[key]))
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=2e-5,
                                   rtol=0)


def _prompts(B, S, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (B, S))


def test_forward_logits_match_jax_in_full_and_decode_mode(jx, weights):
    jp, tp = weights
    jnp, jt = jx["jnp"], jx["jt"]
    B, S, L, steps = 2, 12, 20, 4
    toks = _prompts(B, S, seed=7)
    jc = jt.make_caches(jx["cfg"], B, L, dtype=jnp.float32)
    jlog, jc, _ = jt.forward(jx["cfg"], jp, tokens=jnp.asarray(toks),
                             caches=jc, mode="full")
    tc = make_caches(CFG, B, L, dtype=torch.float32, device="cpu")
    tlog = forward(CFG, tp, tokens=torch.from_numpy(toks), caches=tc,
                   mode="full")
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=0)
    nxt = np.random.default_rng(8).integers(0, CFG.vocab_size, (B, steps))
    for t in range(steps):
        pos = np.full((B, 1), S + t, np.int32)
        jlog, jc, _ = jt.forward(jx["cfg"], jp,
                                 tokens=jnp.asarray(nxt[:, t:t + 1]),
                                 positions=jnp.asarray(pos), caches=jc,
                                 mode="decode")
        tlog = forward(CFG, tp, tokens=torch.from_numpy(nxt[:, t:t + 1]),
                       positions=torch.from_numpy(pos), caches=tc,
                       mode="decode")
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tc["blk0"]["pos"].numpy(),
                                  np.asarray(jc["blk0"]["pos"]))
    np.testing.assert_array_equal(tc["blk0"]["len"].numpy(),
                                  np.asarray(jc["blk0"]["len"]))


def test_decode_at_a_padded_width_matches_jax(jx, weights):
    """Decode steps at a ``decode_width`` above B, as the continuous
    engine runs its narrow tiers: the hidden states carry zero rows past
    the batch through every row-wise product, and the batch rows' logits
    and caches still match JAX's decode (1e-4; positions exactly)."""
    jp, tp = weights
    jnp, jt = jx["jnp"], jx["jt"]
    B, S, L, steps = 2, 9, 16, 4
    toks = _prompts(B, S, seed=17)
    jc = jt.make_caches(jx["cfg"], B, L, dtype=jnp.float32)
    _, jc, _ = jt.forward(jx["cfg"], jp, tokens=jnp.asarray(toks),
                          caches=jc, mode="full")
    tc = make_caches(CFG, B, L, dtype=torch.float32, device="cpu")
    forward(CFG, tp, tokens=torch.from_numpy(toks), caches=tc, mode="full")
    nxt = np.random.default_rng(18).integers(0, CFG.vocab_size, (B, steps))
    for t in range(steps):
        pos = np.full((B, 1), S + t, np.int32)
        jlog, jc, _ = jt.forward(jx["cfg"], jp,
                                 tokens=jnp.asarray(nxt[:, t:t + 1]),
                                 positions=jnp.asarray(pos), caches=jc,
                                 mode="decode")
        tlog = forward(CFG, tp, tokens=torch.from_numpy(nxt[:, t:t + 1]),
                       positions=torch.from_numpy(pos), caches=tc,
                       mode="decode", decode_width=5)
        assert tlog.shape[0] == B
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=ATOL, rtol=0)
    for key in ("pos", "len"):
        np.testing.assert_array_equal(tc["blk0"][key].numpy(),
                                      np.asarray(jc["blk0"][key]))
    np.testing.assert_allclose(tc["blk0"]["k"].numpy(),
                               np.asarray(jc["blk0"]["k"]), atol=1e-5,
                               rtol=0)


def _sampling(B, seed):
    rng = np.random.default_rng(seed)
    temp = np.where(rng.random(B) < 0.5, 0.0, rng.uniform(0.5, 1.5, B))
    return (temp.astype(np.float32),
            rng.integers(0, 40, B).astype(np.int32),
            rng.integers(0, 1000, B).astype(np.int32))


@pytest.mark.parametrize("sampled", [False, True])
def test_decode_segment_matches_jax(jx, weights, sampled):
    """Tokens, emits and state identical under active, budget and eos_id,
    greedy and sampled, after a prefill of the same prompts."""
    jp, tp = weights
    jnp, jt = jx["jnp"], jx["jt"]
    B, S, n = 4, 10, 6
    toks = _prompts(B, S, seed=9)
    jc = jt.make_caches(jx["cfg"], B, S + n + 1, dtype=jnp.float32)
    jlog, jc, _ = jt.forward(jx["cfg"], jp, tokens=jnp.asarray(toks),
                             caches=jc, mode="full")
    first = np.asarray(jlog[:, -1].argmax(-1)).astype(np.int32)[:, None]
    pos = np.full((B, 1), S, np.int32)
    active = np.array([True, True, False, True])
    budget = np.array([6, 2, 6, 6], np.int32)
    eos = np.full(B, -1, np.int32)
    greedy_free = jt.decode_segment(jx["cfg"], jp, jnp.asarray(first),
                                    jnp.asarray(pos), jc, n_steps=2)[0]
    eos[3] = int(np.asarray(greedy_free)[3, 1])    # reached at step 2
    if sampled:
        temp, topk, seed = _sampling(B, seed=10)
        jkw = dict(temperature=jnp.asarray(temp), top_k=jnp.asarray(topk),
                   seed=jnp.asarray(seed))
        tkw = dict(temperature=torch.from_numpy(temp),
                   top_k=torch.from_numpy(topk), seed=torch.from_numpy(seed))
        eos[3] = -1                                # sampled stream differs
    else:
        jkw, tkw = {}, {}
    jtoks, jem, jstate, jc = jt.decode_segment(
        jx["cfg"], jp, jnp.asarray(first), jnp.asarray(pos), jc, n_steps=n,
        active=jnp.asarray(active), budget=jnp.asarray(budget),
        eos_id=jnp.asarray(eos), **jkw)
    tc = make_caches(CFG, B, S + n + 1, dtype=torch.float32, device="cpu")
    forward(CFG, tp, tokens=torch.from_numpy(toks), caches=tc, mode="full")
    ttoks, tem, tstate, tc2 = decode_segment(
        CFG, tp, torch.from_numpy(first), torch.from_numpy(pos), tc,
        n_steps=n, active=torch.from_numpy(active),
        budget=torch.from_numpy(budget), eos_id=torch.from_numpy(eos), **tkw)
    assert tc2 is tc
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    emitted = tem.numpy()
    np.testing.assert_array_equal(ttoks.numpy()[emitted],
                                  np.asarray(jtoks)[emitted])
    for key in ("tok", "pos", "active", "budget", "eos_hit"):
        np.testing.assert_array_equal(tstate[key].numpy(),
                                      np.asarray(jstate[key]), err_msg=key)
    np.testing.assert_array_equal(tc["blk0"]["pos"].numpy(),
                                  np.asarray(jc["blk0"]["pos"]))
    if not sampled:
        assert tstate["eos_hit"].tolist() == [False, False, False, True]


def test_decode_loop_matches_jax(jx, weights):
    """Greedy, always active: the same tokens and cache as JAX's."""
    jp, tp = weights
    jnp, jt = jx["jnp"], jx["jt"]
    B, S, n = 3, 7, 5
    toks = _prompts(B, S, seed=15)
    jc = jt.make_caches(jx["cfg"], B, S + n + 1, dtype=jnp.float32)
    jlog, jc, _ = jt.forward(jx["cfg"], jp, tokens=jnp.asarray(toks),
                             caches=jc, mode="full")
    first = np.asarray(jlog[:, -1].argmax(-1)).astype(np.int32)[:, None]
    pos = np.full((B, 1), S, np.int32)
    jout, jc = jt.decode_loop(jx["cfg"], jp, jnp.asarray(first),
                              jnp.asarray(pos), jc, n_steps=n)
    tc = make_caches(CFG, B, S + n + 1, dtype=torch.float32, device="cpu")
    forward(CFG, tp, tokens=torch.from_numpy(toks), caches=tc, mode="full")
    tout, tc2 = decode_loop(CFG, tp, torch.from_numpy(first),
                            torch.from_numpy(pos), tc, n_steps=n)
    assert tc2 is tc and tout.dtype == torch.int32
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    for key in ("pos", "len"):
        np.testing.assert_array_equal(tc["blk0"][key].numpy(),
                                      np.asarray(jc["blk0"][key]))


# ------------------------------------------------------------ sampling
def test_threefry_bits_equal_jax(jx):
    jax = jx["jax"]
    base = jax.random.PRNGKey(0x5EED)
    assert threefry.prng_key(0x5EED, "cpu").tolist() == \
        np.asarray(jax.random.key_data(base)).tolist()
    seeds = np.array([0, 1, 7, 12345, 2 ** 31 - 1, -3], np.int32)
    pos = np.array([5, 0, 100, 3, 77, 2 ** 20], np.int32)
    jkeys = jax.vmap(lambda s, p: jax.random.fold_in(
        jax.random.fold_in(base, s), p))(seeds, pos)
    tkeys = threefry.fold_in(threefry.fold_in(threefry.prng_key(0x5EED,
                                                                "cpu"),
                                              torch.from_numpy(seeds)),
                             torch.from_numpy(pos))
    np.testing.assert_array_equal(tkeys.numpy(),
                                  np.asarray(jkeys).astype(np.int64))
    V = 3001
    jbits = jax.vmap(lambda k: jax.random.bits(k, (V,)))(jkeys)
    np.testing.assert_array_equal(threefry.random_bits(tkeys, V).numpy(),
                                  np.asarray(jbits).astype(np.int64))
    jg = jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(jkeys)
    # the same uniforms; log may differ by an ulp, most near u = 1
    np.testing.assert_allclose(threefry.gumbel(tkeys, V).numpy(),
                               np.asarray(jg), rtol=1e-5, atol=2e-4)


def test_sample_logits_matches_jax(jx):
    jnp, jt = jx["jnp"], jx["jt"]
    B, V = 64, 512
    rng = np.random.default_rng(12)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    logits[:, 500:] = np.finfo(np.float32).min      # padded vocab ids
    logits[0, [3, 9]] = 50.0                         # a tie: first wins
    temp, topk, seed = _sampling(B, seed=13)
    pos = rng.integers(0, 4096, B).astype(np.int32)
    want_g = jt.sample_logits(jnp.asarray(logits))
    got_g = sample_logits(torch.from_numpy(logits))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    assert got_g[0].item() == 3 and got_g.dtype == torch.int32
    want = jt.sample_logits(jnp.asarray(logits),
                            temperature=jnp.asarray(temp),
                            top_k=jnp.asarray(topk), seed=jnp.asarray(seed),
                            positions=jnp.asarray(pos))
    got = sample_logits(torch.from_numpy(logits),
                        temperature=torch.from_numpy(temp),
                        top_k=torch.from_numpy(topk),
                        seed=torch.from_numpy(seed),
                        positions=torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != got_g.numpy()).any()       # rows did sample


# ------------------------------------------------------- params, gates
def _layout(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{p}": x for p, x in _layout(v).items()})
        else:
            out[k] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


def test_qwen2_params_have_the_jax_layout(jx):
    """The port's init and the bridged JAX tree have the same leaves:
    bq/bk/bv biases, the fused gate|up w_in, no lm_head (tied)."""
    jax = jx["jax"]
    jp = jax.tree.map(np.asarray, jx["jt"].init_params(
        jx["get_config"]("qwen2-0.5b", smoke=True), jax.random.PRNGKey(0)))
    p = init_params(get_config("qwen2-0.5b", smoke=True), 0, device="cpu")
    assert _layout(p) == _layout(jp) == _layout(to_torch(jp, device="cpu"))
    assert "lm_head" not in p and "bq" in p["blocks"]["blk0"]["attn"]
    assert not p["blocks"]["blk0"]["attn"]["bq"].any()   # zero, as in JAX


def test_decoder_gates_raise(weights):
    _, tp = weights
    tok = torch.zeros((1, 1), dtype=torch.long)
    caches = make_caches(CFG, 1, 8, dtype=torch.float32, device="cpu")
    # chunk mode is ported (tests/test_torch_chunked.py holds it against
    # JAX); so is verify, which gives a decode step's logits
    # (tests/test_torch_spec.py holds it against JAX)
    out = forward(CFG, tp, tokens=tok, positions=tok.int(), caches=caches,
                  mode="chunk")
    assert tuple(out.shape[:2]) == (1, 1) and torch.isfinite(out).all()
    assert caches["blk0"]["len"].tolist() == [[1]] * CFG.n_periods
    step = make_caches(CFG, 1, 8, dtype=torch.float32, device="cpu")
    forward(CFG, tp, tokens=tok, positions=tok.int(), caches=step,
            mode="chunk")
    nxt = torch.ones((1, 1), dtype=torch.long)
    ver = forward(CFG, tp, tokens=nxt, positions=nxt.int(), caches=caches,
                  mode="verify")
    dec = forward(CFG, tp, tokens=nxt, positions=nxt.int(), caches=step,
                  mode="decode")
    assert torch.equal(ver, dec)
    assert caches["blk0"]["len"].tolist() == [[2]] * CFG.n_periods
    with pytest.raises(ValueError, match="needs caches"):
        forward(CFG, tp, tokens=tok, mode="decode")
    q8 = ta.make_cache(CFG, 1, 8, quantized=True, device="cpu")
    assert q8["k"].dtype == q8["v"].dtype == torch.int8
    for key in ("k_scale", "v_scale"):
        assert q8[key].dtype == torch.float32 and not q8[key].any()
        assert tuple(q8[key].shape) == (1, 8, CFG.n_kv_heads)
    fused = dataclasses.replace(CFG, n_heads=32, n_kv_heads=16, head_dim=16)
    out = forward(fused, init_params(fused, 0, device="cpu"), tokens=tok)
    assert tuple(out.shape[:2]) == (1, 1) and torch.isfinite(out).all()
    with pytest.raises(NotImplementedError, match="naive_attention"):
        ops.attn_block_sizes("chunk", 16)


# ---------------------------------------------------------- on the card
@requires_cuda
@pytest.mark.parametrize("q_dtype,kv_dtype,tol", [
    (torch.float32, torch.float32, 1e-4),
    (torch.bfloat16, torch.bfloat16, 2e-2),
    (torch.bfloat16, torch.float32, 2e-2)])
@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_cuda_kernel_matches_plain(case, q_dtype, kv_dtype, tol):
    torch.backends.cuda.matmul.allow_tf32 = False
    for D in (64, 128, 160):
        q, k, v, q_pos, kv_pos, kw = _k2_inputs(case, D=D)
        qq, kk, vv, qp, kvp = (t.cuda() for t in _tensors(q, k, v, q_pos,
                                                          kv_pos))
        qq, kk, vv = qq.to(q_dtype), kk.to(kv_dtype), vv.to(kv_dtype)
        before = decode_attention.launches
        out, visits = decode_attention(qq, kk, vv, qp, kvp,
                                       return_visits=True, **kw)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 1
        n_split = decode_splits(q.shape[0], k.shape[2], k.shape[1])[0]
        ref, ref_visits = decode_attention_plain(
            qq.float(), kk.to(q_dtype).float(), vv.to(q_dtype).float(), qp,
            kvp, n_split=n_split, **kw)
        torch.testing.assert_close(out.float(), ref, atol=tol,
                                   rtol=0 if q_dtype == torch.float32
                                   else tol)
        assert torch.equal(visits, ref_visits)


@requires_cuda
@pytest.mark.parametrize("q_dtype,kv_dtype,tol", [
    (torch.float32, torch.float32, 1e-4),
    (torch.bfloat16, torch.bfloat16, 2e-2),
    (torch.bfloat16, torch.float32, 2e-2)])
@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("case", sorted(SPLIT_CASES) + ["ragged"])
def test_k2_cuda_kernel_matches_plain_at_split_counts(case, n_split,
                                                      q_dtype, kv_dtype,
                                                      tol):
    """The split pass and the merge against the plain version at the same
    split count (empty trailing splits included), visits exact."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if case == "ragged":
        q, k, v, q_pos, kv_pos, kw = _k2_inputs("wrapped_ring", seed=5,
                                                D=64)
        k, v, kv_pos = k[:, :53], v[:, :53], kv_pos[:, :53]
        q_pos = np.maximum(q_pos, kv_pos.max(1))
    else:                  # at a head dim the kernel is built for
        D = max(64, SPLIT_CASES[case][4])
        q, k, v, q_pos, kv_pos, kw = _k2_inputs(case, seed=9, D=D)
    qq, kk, vv, qp, kvp = (t.cuda() for t in _tensors(q, k, v, q_pos,
                                                      kv_pos))
    qq, kk, vv = qq.to(q_dtype), kk.to(kv_dtype), vv.to(kv_dtype)
    kk, vv = kk.contiguous(), vv.contiguous()
    before = decode_attention.launches
    out, visits = decode_attention(qq, kk, vv, qp, kvp, n_split=n_split,
                                   return_visits=True, **kw)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    ref, ref_visits = decode_attention_plain(
        qq.float(), kk.to(q_dtype).float(), vv.to(q_dtype).float(), qp, kvp,
        n_split=n_split, **kw)
    torch.testing.assert_close(out.float(), ref, atol=tol,
                               rtol=0 if q_dtype == torch.float32 else tol)
    assert torch.equal(visits, ref_visits)


@requires_cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32)])
def test_k2_cuda_rows_are_bit_equal_across_batch_widths(q_dtype, kv_dtype):
    """At one split count each (row, kv head, split) is a block of its
    own: a row's output has the same bits alone, in a few rows or in 32
    (Qwen2's decode shape at L = 528, at the split count of 32 rows)."""
    B, L, Hq, Hkv, D = 32, 528, 14, 2, 64
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .cuda() for s in ((B, 1, Hq, D), (B, L, Hkv, D),
                                 (B, L, Hkv, D)))
    q, k, v = q.to(q_dtype), k.to(kv_dtype), v.to(kv_dtype)
    q_pos = torch.from_numpy(rng.integers(300, L, B).astype(np.int32)).cuda()
    kv_pos = torch.arange(L, dtype=torch.int32,
                          device="cuda").expand(B, L).contiguous()
    full = ops.gqa_decode(q, k, v, q_pos, kv_pos, width=B)
    for b in (1, 2, 4, 8, 16):
        got = ops.gqa_decode(q[:b], k[:b], v[:b], q_pos[:b], kv_pos[:b],
                             width=B)
        assert torch.equal(got, full[:b])


@requires_cuda
def test_k2_cuda_kernel_rejects_what_it_was_not_built_for():
    q, k, v, q_pos, kv_pos, _ = _k2_inputs("g7")
    q, k, v, q_pos, kv_pos = (t.cuda() for t in _tensors(q, k, v, q_pos,
                                                         kv_pos))
    with pytest.raises(ValueError, match="per kv head"):
        decode_attention(q.repeat(1, 1, 3, 1)[:, :, :34], k, v, q_pos,
                         kv_pos)
    with pytest.raises(TypeError):
        decode_attention(q.half(), k, v, q_pos, kv_pos)
    with pytest.raises(TypeError, match="int32"):
        decode_attention(q, k, v, q_pos, kv_pos.long())
    with pytest.raises(ValueError, match="head dim"):
        decode_attention(q[..., :32], k[..., :32], v[..., :32], q_pos,
                         kv_pos)


@requires_cuda
@pytest.mark.parametrize("sampled", [False, True])
def test_decode_segment_on_cuda_never_waits_for_the_card(sampled):
    """The decode loop launches K2 once per layer and step and makes no
    host sync (CUDA sync debug mode "error" raises on one). The smoke
    config widened to Qwen2's head dim of 64, which the kernels take."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                              d_model=896)
    params = init_params(cfg, 0, device="cuda")
    B, S, n = 3, 9, 5
    toks = torch.from_numpy(_prompts(B, S, seed=14)).cuda()
    caches = make_caches(cfg, B, S + n + 1, dtype=torch.float32,
                         device="cuda")
    first = forward(cfg, params, tokens=toks, caches=caches)[:, -1].argmax(
        -1).to(torch.int32)[:, None]
    pos = torch.full((B, 1), S, dtype=torch.int32, device="cuda")
    kw = {}
    if sampled:
        kw = dict(temperature=torch.full((B,), 0.8, device="cuda"),
                  top_k=torch.full((B,), 20, dtype=torch.int32,
                                   device="cuda"),
                  seed=torch.arange(B, dtype=torch.int32, device="cuda"))
    before = decode_attention.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, emits, _, _ = decode_segment(cfg, params, first, pos, caches,
                                          n_steps=n, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert decode_attention.launches == before + cfg.n_layers * n
    assert emits.all() and ((out >= 0) & (out < cfg.vocab_size)).all()
