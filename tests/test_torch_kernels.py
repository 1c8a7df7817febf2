"""K1 (flash attention) of the PyTorch port against the JAX package.

On the CPU the port's wrapper runs the plain PyTorch version of the
kernel; it is held against the JAX Pallas kernel (interpret mode) and the
jnp oracle on the same numpy inputs, in fp32 (atol 2e-5: the two sum in
different orders). The visit counts and ``live_block_counts`` are held
against JAX's. The cases marked ``requires_cuda`` launch the CUDA kernel
and skip on a host without a card; they need no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (BLOCK_K, BLOCK_Q, TILES,
                                                 flash_attention,
                                                 flash_attention_plain,
                                                 kernel_tiles,
                                                 live_block_counts)

requires_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                   reason="needs an NVIDIA GPU with CUDA")
ATOL = 2e-5

# (B, Sq, Skv, Hq, Hkv, D, options); JAX wants Sq, Skv multiples of 16
CASES = {
    "causal": (2, 64, 64, 4, 4, 32, dict(causal=True)),
    "window": (1, 64, 64, 2, 2, 32, dict(causal=True, window=24)),
    "softcap": (1, 64, 64, 2, 2, 32, dict(causal=False, softcap=30.0)),
    "gqa": (2, 48, 48, 6, 2, 16, dict(causal=True)),
    "kv_len": (2, 64, 64, 4, 4, 16, dict(causal=False, kv_len=40)),
    "mixed": (1, 32, 64, 6, 2, 16, dict(causal=False, window=16,
                                        kv_len=50, softcap=20.0)),
    # rows >= 107 see no key: they average v over the masked columns of
    # the tiles they visit, as the TPU kernel does (the oracle differs)
    "masked_rows": (1, 160, 160, 2, 2, 16, dict(causal=True, window=8,
                                                kv_len=100)),
}

# At the bf16 kernel's kv tile of 64 (the Pallas kernel wants S a multiple
# of its tiles): (B, Sq, Skv, Hq, Hkv, D, options)
CASES_BK64 = {
    "causal": (1, 128, 128, 4, 2, 32, dict(causal=True)),
    "window": (1, 192, 192, 2, 2, 16, dict(causal=True, window=70)),
    "softcap_kv_len": (1, 64, 128, 2, 1, 32, dict(causal=False, softcap=20.0,
                                                  kv_len=100)),
    "masked_rows": (1, 192, 192, 2, 2, 16, dict(causal=True, window=8,
                                                kv_len=100)),
}


@pytest.fixture(scope="module")
def jax_k1():
    pytest.importorskip("jax")
    from repro.kernels import flash_attention as jfa
    from repro.kernels import ref
    return jfa, ref


def _inputs(B, Sq, Skv, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32))


def _bh(x):
    """(B, S, H, D) -> the JAX kernel's (B*H, S, D)."""
    return x.transpose(0, 2, 1, 3).reshape(-1, x.shape[1], x.shape[3])


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_kernel(case, jax_k1):
    jfa, _ = jax_k1
    B, Sq, Skv, Hq, Hkv, D, kw = CASES[case]
    q, k, v = _inputs(B, Sq, Skv, Hq, Hkv, D)
    out, visits = flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        bq=16, bk=16, **kw)
    jout, jvis = jfa.flash_attention(_bh(q), _bh(k), _bh(v), bq=16, bk=16,
                                     interpret=True, return_visits=True,
                                     **kw)
    np.testing.assert_allclose(_bh(out.numpy()), np.asarray(jout),
                               atol=ATOL, rtol=0)
    np.testing.assert_array_equal(visits.numpy(), np.asarray(jvis))


@pytest.mark.parametrize("bq", [32, 64])
@pytest.mark.parametrize("case", sorted(CASES_BK64))
def test_plain_at_the_bf16_kv_tile_matches_pallas_kernel(case, bq, jax_k1):
    """The bf16 kernel's kv tile of 64 rows against the Pallas kernel at
    the same tiles; visits against it and ``live_block_counts``."""
    jfa, _ = jax_k1
    B, Sq, Skv, Hq, Hkv, D, kw = CASES_BK64[case]
    q, k, v = _inputs(B, Sq, Skv, Hq, Hkv, D, seed=2)
    out, visits = flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        bq=bq, bk=64, **kw)
    G = Hq // Hkv
    kr, vr = (np.repeat(x, G, axis=2) for x in (k, v))
    jout, jvis = jfa.flash_attention(_bh(q), _bh(kr), _bh(vr), bq=bq, bk=64,
                                     interpret=True, return_visits=True,
                                     **kw)
    np.testing.assert_allclose(_bh(out.numpy()), np.asarray(jout),
                               atol=ATOL, rtol=0)
    np.testing.assert_array_equal(visits.numpy(), np.asarray(jvis))
    want = live_block_counts(Sq, Skv, causal=kw["causal"],
                             window=kw.get("window"), bq=bq, bk=64,
                             kv_len=kw.get("kv_len"))
    assert visits.tolist() == [want] * (B * Hq)


def test_default_kv_tile_follows_the_dtype():
    """Without ``bk`` the wrapper and the plain version take the kernel's
    tile for q's dtype and head dim: 64 rows in bf16 (32 at head dim
    256), 32 in fp32."""
    for dtype, D, bk in ((torch.bfloat16, 64, 64), (torch.bfloat16, 256, 32),
                         (torch.float32, 64, 32), (torch.float32, 256, 32)):
        assert kernel_tiles(dtype, D)[1] == bk
        q, k, v = (torch.from_numpy(x).to(dtype)
                   for x in _inputs(1, 160, 160, 2, 1, D, seed=3))
        for fn in (flash_attention, flash_attention_plain):
            res = fn(q, k, v, causal=True, bq=32, **(
                dict(return_visits=True) if fn is flash_attention else {}))
            out, visits = res
            want = live_block_counts(160, 160, causal=True, window=None,
                                     bq=32, bk=bk)
            assert out.dtype == dtype
            assert visits.tolist() == [want] * 2
        ref, _ = flash_attention_plain(q, k, v, causal=True, bq=32, bk=bk)
        assert torch.equal(out, ref)


@pytest.mark.parametrize("case", sorted(set(CASES) - {"masked_rows"}))
def test_plain_matches_reference(case, jax_k1):
    """The jnp oracle has no kv_len: it sees the kv columns cut at kv_len
    (no row of these cases is fully masked, where the two differ)."""
    _, ref = jax_k1
    B, Sq, Skv, Hq, Hkv, D, kw = CASES[case]
    q, k, v = _inputs(B, Sq, Skv, Hq, Hkv, D, seed=1)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), bq=32, bk=BLOCK_K, **kw)
    n = kw.get("kv_len", Skv)
    want = ref.flash_attention_ref(
        _bh(q), _bh(k[:, :n]), _bh(v[:, :n]), causal=kw["causal"],
        window=kw.get("window"), softcap=kw.get("softcap"))
    np.testing.assert_allclose(_bh(out.numpy()), np.asarray(want),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("window", [None, 1, 20, 64])
def test_live_block_counts_match_jax(causal, window, jax_k1):
    jfa, _ = jax_k1
    for sq in (32, 64, 192):
        for skv in (32, 128, 256):
            for bq in (16, 32, 64):
                for bk in (16, 32, 64):
                    for kv_len in (None, skv - 7, skv // 2 + 1):
                        if sq % bq:
                            continue
                        kw = dict(causal=causal, window=window, bq=bq,
                                  bk=bk, kv_len=kv_len)
                        assert live_block_counts(sq, skv, **kw) == \
                            jfa.live_block_counts(sq, skv, **kw), kw


def test_visits_count_the_live_tiles_on_ragged_shapes():
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 100, 77, 4, 2, 16))
    for kw in (dict(causal=True), dict(causal=False, kv_len=70),
               dict(causal=True, window=30)):
        _, visits = flash_attention(q, k, v, bq=32, bk=16,
                                    return_visits=True, **kw)
        want = live_block_counts(100, 77, bq=32, bk=16,
                                 window=kw.get("window"),
                                 causal=kw["causal"],
                                 kv_len=kw.get("kv_len"))
        assert visits.shape == (8, 4)
        assert (visits == torch.tensor(want, dtype=torch.int32)).all()


def test_cpu_wrapper_runs_plain_version_without_launching():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 64, 64, 4, 4, 64))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=False)
    plain, _ = flash_attention_plain(q, k, v, causal=False)
    assert torch.equal(out, plain)
    via_ops = ops.mha_prefill(q, k, v, causal=False, kv_len=64)
    bq, bk = ops.attn_block_sizes("prefill", 64, bh=4)
    assert torch.equal(via_ops, flash_attention_plain(
        q, k, v, causal=False, kv_len=64, bq=bq, bk=bk)[0])
    assert flash_attention.launches == before


def test_block_sizes_are_built_tiles():
    for sq in (1, 32, 33, 128, 512):
        for bh in (1, 12, 384):
            bq, bk = ops.attn_block_sizes("prefill", sq, bh=bh)
            assert bq in BLOCK_Q and bk == BLOCK_K
    assert ops.attn_block_sizes("prefill", 128, bh=384) == (64, 32)
    assert ops.attn_block_sizes("prefill", 128, bh=12) == (32, 32)
    assert ops.attn_block_sizes("decode", 1) == (1, 32)
    with pytest.raises(NotImplementedError, match="naive_attention"):
        ops.attn_block_sizes("chunk", 16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [64, 128, 160, 256])
def test_block_sizes_are_built_tiles_at_every_head_dim(head_dim, dtype):
    """``attn_block_sizes`` returns only tiles the kernel is built for:
    bq from its q tiles, bk its one kv tile for (dtype, head dim)."""
    bqs, bk = TILES[(dtype, head_dim)]
    seen = set()
    for sq in (1, 16, 32, 33, 64, 128, 512, 2048):
        for bh in (1, 12, 64, 384, 512, 4096):
            got = ops.attn_block_sizes("prefill", sq, bh=bh,
                                       head_dim=head_dim, dtype=dtype)
            assert got[0] in bqs and got[1] == bk
            seen.add(got)
    assert seen == {(bq, bk) for bq in bqs}
    want_bk = {torch.float32: 32, torch.bfloat16: 32 if head_dim == 256
               else 64}[dtype]
    assert bk == want_bk


def test_bad_inputs_raise():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 32, 32, 3, 2, 16))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 32, 32, 4, 2, 16))
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention(q, k, v, kv_len=33)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)


# ---------------------------------------------------------- on the card
@requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain(case, dtype, tol):
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Sq, Skv, Hq, Hkv, _, kw = CASES[case]
    for D, bq in ((64, 32), (128, 64)):
        q, k, v = (torch.from_numpy(x).cuda().to(dtype)
                   for x in _inputs(B, Sq, Skv, Hq, Hkv, D))
        before = flash_attention.launches
        out, visits = flash_attention(q, k, v, bq=bq, return_visits=True,
                                      **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        ref, ref_visits = flash_attention_plain(
            q.float(), k.float(), v.float(), bq=bq,
            bk=kernel_tiles(dtype, D)[1], **kw)
        torch.testing.assert_close(out.float(), ref, atol=tol,
                                   rtol=0 if dtype == torch.float32 else tol)
        assert torch.equal(visits, ref_visits)


@requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("head_dim", [64, 128, 160, 256])
@pytest.mark.parametrize("case", sorted(CASES) + sorted(
    f"bk64_{c}" for c in CASES_BK64))
def test_cuda_kernel_matches_plain_at_every_built_tile(case, head_dim,
                                                       dtype, tol):
    """Every q tile the kernel is built for at (dtype, head dim), at its
    kv tile, against the plain version at the same tiles; visits exact."""
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Sq, Skv, Hq, Hkv, _, kw = (CASES_BK64[case[5:]]
                                  if case.startswith("bk64_")
                                  else CASES[case])
    bqs, bk = TILES[(dtype, head_dim)]
    q, k, v = (torch.from_numpy(x).cuda().to(dtype)
               for x in _inputs(B, Sq, Skv, Hq, Hkv, head_dim, seed=4))
    for bq in bqs:
        out, visits = flash_attention(q, k, v, bq=bq, return_visits=True,
                                      **kw)
        torch.cuda.synchronize()
        ref, ref_visits = flash_attention_plain(q.float(), k.float(),
                                                v.float(), bq=bq, bk=bk,
                                                **kw)
        torch.testing.assert_close(out.float(), ref, atol=tol,
                                   rtol=0 if dtype == torch.float32 else tol)
        assert torch.equal(visits, ref_visits)


@requires_cuda
def test_cuda_kernel_rejects_what_it_was_not_built_for():
    q, k, v = (torch.from_numpy(x).cuda() for x in _inputs(1, 32, 32, 2, 2,
                                                            64))
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="tiles"):
        flash_attention(q, k, v, bq=16)
    q2, k2, v2 = (torch.from_numpy(x).cuda() for x in _inputs(1, 32, 32, 2,
                                                               2, 32))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q2, k2, v2)
