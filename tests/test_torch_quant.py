"""The port's int8 serving (slice 3) against the JAX package, on the CPU.

The same numpy inputs go through ``repro.quant`` and ``repro_torch.quant``:
the policy, ``quantize_leaf``, ``quantize_kv`` and ``quantize_params`` on
the GECToR and Qwen2 smoke trees give bit-identical int8 payloads and fp32
scales, and round-trip within scale/2. ``ops.matmul_q8`` (K3's plain
version on a CPU tensor) is held against ``ref.int8_matmul_ref`` and the
Pallas ``int8_matmul`` in interpret mode, ``ops.matmul`` (K4's) against
the JAX ``ops.matmul`` in interpret mode and ``qeinsum`` against JAX's,
all within 1e-5 (fp32; the sums run in other orders). The int8 KV cache
keeps JAX's layout and the prefill fill writes its scale planes. At the
smoke configs in fp32, the int8 GECToR forward, Qwen2's int8 prefill and
``decode_segment`` over an int8 cache, and both engines with
``weight_quant``/``kv_quant`` match JAX: logits within 1e-4, tags, tokens
and finish reasons identical, ``weight_bytes`` equal. ``matmul_plan`` is
pinned here: the same plan at every decode width, 2 x 132 blocks at
Qwen2's w_in and w_down, every tile within a block's shared memory, the
masked path for unaligned rows; ``qeinsum`` keeps its bf16 bits. The
cases marked ``requires_cuda`` hold K3 and K4 against their plain
versions on the card (and rows bit-equal across widths, two launches
bit-equal, every int8 value converted exactly) and skip here; they need
no JAX, which is imported in a fixture.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.core import gector as tg
from repro_torch.core.tags import KEEP
from repro_torch.kernels import ops
from repro_torch.kernels.int8_matmul import (SMEM_LIMIT, SPLIT_ROWS,
                                             TILES, Plan, cache_matmul,
                                             cache_matmul_plain, int8_matmul,
                                             int8_matmul_plain, launch_plan,
                                             matmul_plan, plan_blocks,
                                             smem_bytes)
from repro_torch.models import attention as ta
from repro_torch.models import decode_segment, forward, make_caches
from repro_torch.quant import (default_policy, dequantize_kv,
                               dequantize_leaf, dequantize_params,
                               is_quantized, params_bytes, qeinsum,
                               quantize_kv, quantize_leaf, quantize_params,
                               quantized_leaf_count, validate_kv_quant)
from repro_torch.quant import policy as tpol
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.api import SamplingParams

requires_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                   reason="needs an NVIDIA GPU with CUDA")
ATOL = 1e-4                   # logits, port vs JAX (fp32)
MM_TOL = 1e-5                 # matmuls, port vs JAX (fp32, other sum order)
GCFG = dataclasses.replace(get_config("gector-base", smoke=True),
                           dtype="float32")
QCFG = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                           dtype="float32")
DECODER = dict(mode="decoder", continuous=False, use_cache_pool=False,
               pad_buckets=(16, 32), max_new_tokens=4, max_batch=8)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import quant as jq
    from repro.configs import get_config as jax_get_config
    from repro.core import gector as jg
    from repro.core.tags import TagVocab
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.int8_matmul import int8_matmul as jint8
    from repro.models import attention as ja
    from repro.models import transformer as jt
    from repro.quant import policy as jpol
    from repro.serving import EngineConfig as JaxEngineConfig
    from repro.serving import ServingEngine as JaxServingEngine
    from repro.serving.api import SamplingParams as JaxSamplingParams
    gcfg = dataclasses.replace(jax_get_config("gector-base", smoke=True),
                               dtype="float32")
    qcfg = dataclasses.replace(jax_get_config("qwen2-0.5b", smoke=True),
                               dtype="float32")
    return dict(jax=jax, jnp=jnp, jq=jq, jg=jg, TagVocab=TagVocab,
                jops=jops, jref=jref, jint8=jint8, ja=ja, jt=jt, jpol=jpol,
                gcfg=gcfg, qcfg=qcfg, Engine=JaxServingEngine,
                EngineConfig=JaxEngineConfig, Sampling=JaxSamplingParams)


def _np_tree(jx, tree):
    return jx["jax"].tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def gector(jx):
    """GECToR smoke weights from JAX, as (jax tree, torch tree)."""
    jp = jx["jg"].init_gector(jx["gcfg"], jx["jax"].random.PRNGKey(0),
                              jx["TagVocab"](64))
    return jp, to_torch(_np_tree(jx, jp), device="cpu")


@pytest.fixture(scope="module")
def qwen2(jx):
    """Qwen2 smoke weights from JAX with non-zero QKV biases, as (jax
    tree, torch tree)."""
    jp = _np_tree(jx, jx["jt"].init_params(jx["qcfg"],
                                           jx["jax"].random.PRNGKey(0)))
    rng = np.random.default_rng(11)
    attn = jp["blocks"]["blk0"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name] = (0.3 * rng.standard_normal(attn[name].shape)
                      ).astype(np.float32)
    return jx["jax"].tree.map(jx["jnp"].asarray, jp), to_torch(jp,
                                                              device="cpu")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _bits(t):
    """A tensor's bits as numpy, bf16 kept as its uint16 pattern."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------- policy
@pytest.mark.parametrize("name", sorted(tpol._LEAF_SPECS) + ["w", "norm"])
def test_policy_n_contract_matches_jax(jx, name):
    parents = sorted(tpol._PARENTS) + [None, "experts", "shared", "blk0"]
    theirs, ours = jx["jpol"].default_policy(), default_policy()
    for parent in parents:
        assert ours.n_contract(parent, name) == \
            theirs.n_contract(parent, name), (parent, name)
    assert tpol.LAYER_CLASSES == jx["jpol"].LAYER_CLASSES


# ---------------------------------------------------------- quantization
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("nc", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_leaf_equals_jax(jx, dtype, nc, stacked):
    """qw and scale bit for bit, an all-zero output channel included;
    the round trip stays within scale/2."""
    jnp = jx["jnp"]
    shape = ((3,) if stacked else ()) + (6, 5, 4, 7)[:nc + 1] + (9,)
    w = np.random.default_rng(nc).standard_normal(shape).astype(np.float32)
    w[..., 2] = 0.0                                   # a zero channel
    jw = jnp.asarray(w).astype(dtype)
    tw = to_torch(np.asarray(jw), device="cpu")
    nb = int(stacked)
    want = jx["jq"].quantize_leaf(jw, nc, n_batch=nb)
    got = quantize_leaf(tw, nc, n_batch=nb)
    assert is_quantized(got) and got["qw"].dtype == torch.int8
    assert got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["qw"].numpy(), np.asarray(want["qw"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    assert (got["qw"][..., 2] == 0).all() and (got["scale"][..., 2] == 0).all()
    back = dequantize_leaf(got, torch.float32, n_batch=nb)
    sb = got["scale"]
    for ax in range(nb, nb + nc):
        sb = sb.unsqueeze(ax)
    # scale/2, with room for the float rounding of w/scale at a tie
    assert ((back - tw.float()).abs() <= sb / 2 * 1.001 + 1e-12).all()
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jx["jq"].dequantize_leaf(
            want, jnp.float32, n_batch=nb)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_equals_jax(jx, dtype):
    jnp = jx["jnp"]
    x = 3.0 * np.random.default_rng(4).standard_normal(
        (3, 5, 2, 16)).astype(np.float32)
    x[1, 2, 0] = 0.0                                  # an empty slot
    jxa = jnp.asarray(x).astype(dtype)
    tx = to_torch(np.asarray(jxa), device="cpu")
    jqk, jsk = jx["jq"].quantize_kv(jxa)
    q, s = quantize_kv(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == (3, 5, 2)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqk))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jsk))
    assert (q[1, 2, 0] == 0).all() and s[1, 2, 0] == 0
    back = dequantize_kv(q, s, tx.dtype)
    np.testing.assert_array_equal(
        _bits(back), _jbits(jx["jq"].dequantize_kv(jqk, jsk, jxa.dtype)))
    err = (dequantize_kv(q, s, torch.float32) - tx.float()).abs()
    assert (err <= s[..., None] / 2 * 1.001 + 1e-12).all()
    validate_kv_quant(None)
    validate_kv_quant("int8")
    with pytest.raises(ValueError, match="kv_quant"):
        validate_kv_quant("fp8")


@pytest.mark.parametrize("model", ["gector", "qwen2"])
def test_quantize_params_equals_jax(jx, gector, qwen2, model):
    """quantize_params(to_torch(p)) == to_torch(jax quantize_params(p)),
    leaf for leaf and bit for bit; counts, bytes and the round trip."""
    jp, tp = gector if model == "gector" else qwen2
    want = _flat(to_torch(_np_tree(jx, jx["jq"].quantize_params(jp)),
                          device="cpu"))
    qp = quantize_params(tp)
    got = _flat(qp)
    assert sorted(got) == sorted(want)
    for key in got:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(_bits(got[key]), _bits(want[key]),
                                      err_msg=key)
    n = quantized_leaf_count(qp)
    assert n == jx["jq"].quantized_leaf_count(jx["jq"].quantize_params(jp))
    assert n == 6                      # wq wk wv wo + the two MLP leaves
    assert params_bytes(qp) == jx["jq"].params_bytes(
        jx["jq"].quantize_params(jp)) < params_bytes(tp)
    back = _flat(dequantize_params(qp))
    for key, w in _flat(tp).items():
        if key + "/scale" in got:
            bound = got[key + "/scale"].max() / 2 * 1.001 + 1e-12
            assert (back[key] - w.float()).abs().max() <= bound, key
        else:
            assert back[key] is w, key


# -------------------------------------------------------------- matmuls
def _mm_inputs(M, K, N, seed=0, zero_col=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    qw = rng.integers(-127, 128, (K, N)).astype(np.int8)
    scale = rng.uniform(1e-3, 2e-2, N).astype(np.float32) / math.sqrt(K)
    if zero_col is not None:
        qw[:, zero_col] = 0
    return x, qw, scale


@pytest.mark.parametrize("M,K,N", [(1, 7, 3), (33, 72, 40), (64, 256, 128),
                                   (5, 300, 17)])
def test_matmul_q8_plain_matches_ref(jx, M, K, N):
    x, qw, scale = _mm_inputs(M, K, N, seed=M, zero_col=N - 1)
    before = int8_matmul.launches
    got = ops.matmul_q8(*map(torch.from_numpy, (x, qw, scale)))
    assert int8_matmul.launches == before            # the CPU runs plain
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    want = np.asarray(jx["jref"].int8_matmul_ref(x, qw, scale))
    np.testing.assert_allclose(got.numpy(), want, rtol=MM_TOL, atol=MM_TOL)
    assert (got[:, -1] == 0).all()
    np.testing.assert_array_equal(
        got.numpy(), ops.matmul_q8(*map(torch.from_numpy, (x, qw, scale)),
                                   plain=True).numpy())


def test_matmul_q8_plain_matches_the_pallas_kernel(jx):
    """At block multiples, where the Pallas kernel needs no padding."""
    x, qw, scale = _mm_inputs(32, 256, 256, seed=5)
    want = jx["jint8"](x, qw, scale, bm=16, bn=128, bk=128, interpret=True)
    got = ops.matmul_q8(*map(torch.from_numpy, (x, qw, scale)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MM_TOL,
                               atol=MM_TOL)
    bx = torch.from_numpy(x).bfloat16()
    out = int8_matmul(bx, torch.from_numpy(qw), torch.from_numpy(scale))
    assert out.dtype == torch.bfloat16                # x's type, as JAX's


def test_ops_matmul_matches_jax(jx):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 5, 40)).astype(np.float32)
    w = (0.2 * rng.standard_normal((40, 24))).astype(np.float32)
    before = cache_matmul.launches
    got = ops.matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert cache_matmul.launches == before
    want = jx["jops"].matmul(x, w)                    # Pallas, interpret
    assert tuple(got.shape) == (2, 5, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MM_TOL,
                               atol=MM_TOL)
    np.testing.assert_allclose(
        cache_matmul_plain(torch.from_numpy(x[0]), torch.from_numpy(w)),
        np.asarray(jx["jref"].matmul_ref(x[0], w)), rtol=MM_TOL,
        atol=MM_TOL)


@pytest.mark.parametrize("eq,xshape,wshape,nc", [
    ("bsd,dhk->bshk", (2, 5, 16), (16, 2, 8), 1),      # wq / wk / wv
    ("bshk,hkd->bsd", (2, 5, 2, 8), (2, 8, 16), 2),    # wo
    ("bsd,dcf->bscf", (2, 5, 16), (16, 2, 24), 1),     # fused gate|up
    ("bsd,df->bsf", (2, 5, 16), (16, 24), 1),          # w_up
    ("bsf,fd->bsd", (2, 5, 24), (24, 16), 1),          # w_down
])
def test_qeinsum_matches_jax(jx, eq, xshape, wshape, nc):
    """A quantized leaf collapses to one matmul_q8 and equals JAX's
    qeinsum; a float weight takes exactly torch.einsum."""
    rng = np.random.default_rng(len(eq))
    x = rng.standard_normal(xshape).astype(np.float32)
    w = (0.1 * rng.standard_normal(wshape)).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    assert torch.equal(qeinsum(eq, tx, tw), torch.einsum(eq, tx, tw))
    jleaf = jx["jq"].quantize_leaf(jx["jnp"].asarray(w), nc)
    leaf = quantize_leaf(tw, nc)
    got = qeinsum(eq, tx, leaf)
    want = np.asarray(jx["jq"].qeinsum(eq, x, jleaf))
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=MM_TOL, atol=MM_TOL)
    assert torch.equal(got, qeinsum(eq, tx, leaf, plain_matmul=True))


def test_smem_budget_and_tiles():
    """The masked tiles keep to 48 KB of static shared memory; the wgmma
    and split tiles fit a block's 232,448 bytes (they raise their
    dynamic limit once); ``matmul_plan`` picks the split path at decode
    M and the wgmma tiles by how well they fill the card."""
    for tile in TILES["masked"]:
        for dtype in (torch.float32, torch.bfloat16):
            assert smem_bytes("masked", tile, dtype=dtype) <= 48 * 1024
    for path in ("wgmma", "split"):
        for tile in TILES[path]:
            for w_dtype in (torch.int8, torch.bfloat16):
                assert 48 * 1024 < smem_bytes(path, tile, w_dtype) \
                    <= SMEM_LIMIT
    assert smem_bytes("masked", (256, 256, 256), dtype=torch.float32) > \
        SMEM_LIMIT
    assert matmul_plan(32, 896, 4864).path == \
        matmul_plan(1, 128, 896).path == "split"
    assert matmul_plan(4096, 896, 896) == \
        Plan("wgmma", TILES["wgmma"][0], 1, 896)
    # 192 tiles of 128 x 128 would leave 60 SMs with two: 128 x 192
    assert matmul_plan(4096, 768, 768).tile == TILES["wgmma"][1]
    assert matmul_plan(4096, 128, 896).tile == TILES["wgmma"][2]
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="must be"):
        int8_matmul(x, torch.zeros(9, 3, dtype=torch.int8), torch.ones(3))
    with pytest.raises(ValueError, match="scale"):
        int8_matmul(x, torch.zeros(8, 3, dtype=torch.int8), torch.ones(4))


# (K, N) of one layer's projections in qeinsum's view
QWEN2_KN = [(896, 896), (896, 128), (896, 9728), (4864, 896)]
GECTOR_KN = [(768, 768), (768, 3072), (3072, 768)]


@pytest.mark.parametrize("K,N", QWEN2_KN + GECTOR_KN + [(1000, 256)])
def test_matmul_plan_is_the_same_at_every_decode_width(K, N):
    """At decode M the plan, splits included, comes from (N, K) alone,
    so a row's sum runs in one order at every batch width; the splits
    cover K in whole 128-row stages, the last one possibly short."""
    plans = {matmul_plan(M, N, K) for M in range(1, 33)}
    assert len(plans) == 1
    (p,) = plans
    assert p.path == "split" and p.kslab % p.tile[2] == 0
    assert (p.splits - 1) * p.kslab < K <= p.splits * p.kslab


@pytest.mark.parametrize("K,N", [(896, 9728), (4864, 896)])
def test_matmul_plan_streams_w_in_and_w_down_on_264_blocks(K, N):
    """Qwen2-0.5B's w_in and w_down at a decode step: at least two blocks
    per SM of the 132 stream the weight."""
    for M in (1, 32):
        assert plan_blocks(M, N, matmul_plan(M, N, K)) >= 2 * 132


@pytest.mark.parametrize("M", [1, 16, 32, 64, 4096])
@pytest.mark.parametrize("K,N", QWEN2_KN + GECTOR_KN)
def test_every_planned_tile_fits_shared_memory(M, K, N):
    p = matmul_plan(M, N, K)
    rows = [r for r in SPLIT_ROWS if r >= M][:1] if p.path == "split" \
        else [p.tile[0]]
    for w_dtype in (torch.int8, torch.bfloat16):
        for r in rows:
            assert smem_bytes(p.path, (r,) + tuple(p.tile[1:]), w_dtype) \
                <= SMEM_LIMIT
    lp = launch_plan(torch.zeros(M, K), torch.zeros(K, N), p)
    assert lp.path == "masked" and lp.tile in TILES["masked"]
    assert smem_bytes("masked", lp.tile, dtype=torch.float32) <= 48 * 1024


def test_launch_plan_takes_the_masked_path_where_rows_do_not_align():
    p = matmul_plan(32, 96, 256)
    x = torch.zeros(32, 256, dtype=torch.bfloat16)
    qw = torch.zeros(256, 96, dtype=torch.int8)
    assert launch_plan(x, qw, p) == p
    assert launch_plan(x.float(), qw, p) == \
        Plan("masked", TILES["masked"][1], 1, 256)
    wide = torch.zeros(32, 259, dtype=torch.bfloat16)[:, :256]
    assert launch_plan(wide, qw, p).path == "masked"     # odd row stride
    assert launch_plan(x, torch.zeros(256, 104, dtype=torch.int8)[:, :96],
                       p).path == "masked"                # 104-byte rows
    big = matmul_plan(4096, 768, 768)
    assert launch_plan(torch.zeros(4096, 768), torch.zeros(768, 768),
                       big).tile == TILES["masked"][0]


@pytest.mark.parametrize("eq,xshape,wshape,nc", [
    ("bsd,dhk->bshk", (2, 5, 16), (16, 2, 8), 1),
    ("bshk,hkd->bsd", (2, 5, 2, 8), (2, 8, 16), 2),
    ("bsf,fd->bsd", (2, 5, 24), (24, 16), 1),
])
def test_qeinsum_int8_leaf_keeps_its_bf16_bits(eq, xshape, wshape, nc):
    """bf16 x with an int8 leaf: ``matmul_q8`` returns x's type and
    ``qeinsum`` takes it as it is, the same bits as the former fp32 round
    trip (the plain output upcast, then cast back)."""
    rng = np.random.default_rng(len(eq) + nc)
    x = torch.from_numpy(rng.standard_normal(xshape).astype(np.float32))
    x = x.bfloat16()
    leaf = quantize_leaf(torch.from_numpy(
        (0.1 * rng.standard_normal(wshape)).astype(np.float32)), nc)
    got = qeinsum(eq, x, leaf)
    K = math.prod(wshape[:nc])
    N = math.prod(wshape[nc:])
    lead = xshape[:len(xshape) - nc]
    mm = ops.matmul_q8(x.reshape(-1, K), leaf["qw"].reshape(K, N),
                       leaf["scale"].reshape(N))
    assert mm.dtype == torch.bfloat16
    before = int8_matmul_plain(x.reshape(-1, K), leaf["qw"].reshape(K, N),
                               leaf["scale"].reshape(N)).float().to(x.dtype)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == lead + tuple(wshape[nc:])
    assert torch.equal(got.reshape(-1, N), before)
    assert torch.equal(mm, before)


# ---------------------------------------------------------------- caches
def test_make_caches_kv_quant_layout_matches_jax(jx):
    jnp = jx["jnp"]
    for kv_quant in (None, "int8"):
        want = jx["jt"].make_caches(jx["qcfg"], 2, 24, dtype=jnp.float32,
                                    kv_quant=kv_quant)["blk0"]
        got = make_caches(QCFG, 2, 24, dtype=torch.float32,
                          kv_quant=kv_quant, device="cpu")["blk0"]
        assert sorted(got) == sorted(want)
        for key, t in got.items():
            assert tuple(t.shape) == want[key].shape, key
            assert str(t.dtype)[6:] == str(want[key].dtype), key
            np.testing.assert_array_equal(t.numpy(), np.asarray(want[key]))
    assert "k_scale" not in make_caches(QCFG, 2, 24, device="cpu")["blk0"]


def _one_layer(tree):
    return {k: (_one_layer(v) if isinstance(v, dict) else v[0])
            for k, v in tree.items()}


@pytest.mark.parametrize("S,L", [(10, 16), (20, 16)])
def test_prefill_fills_the_int8_cache_like_jax(jx, qwen2, S, L):
    """The fill loops over the int8 payload's keys, so the scale planes
    are written too, in the S >= L branch as well."""
    jp, tp = qwen2
    jnp, B = jx["jnp"], 2
    x = np.random.default_rng(6).standard_normal(
        (B, S, QCFG.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jcache = jx["ja"].make_cache(jx["qcfg"], B, L, dtype=jnp.float32,
                                 quantized=True)
    jattn = jx["jq"].quantize_params(jp)["blocks"]["blk0"]["attn"]
    jout, jcache = jx["ja"].attn_apply(
        jx["qcfg"], _one_layer(jattn), jnp.asarray(x), jnp.asarray(pos),
        cache=jcache)
    tcache = ta.make_cache(QCFG, B, L, dtype=torch.float32, quantized=True,
                           device="cpu")
    tattn = quantize_params(tp)["blocks"]["blk0"]["attn"]
    tout, _ = ta.attn_apply(QCFG, _one_layer(tattn), torch.from_numpy(x),
                            torch.from_numpy(pos), causal=True, cache=tcache)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    n = min(S, L)
    for key in ("pos", "len"):
        np.testing.assert_array_equal(tcache[key].numpy(),
                                      np.asarray(jcache[key]))
    for key in ("k", "v"):
        sc = tcache[f"{key}_scale"]
        assert (sc[:, :n] > 0).all() and (sc[:, n:] == 0).all()
        np.testing.assert_allclose(sc.numpy(),
                                   np.asarray(jcache[f"{key}_scale"]),
                                   rtol=1e-5, atol=0)
        # payloads: equal but where k/v sit within float noise of a
        # rounding boundary (the projections sum in another order)
        diff = np.abs(tcache[key].numpy().astype(np.int32)
                      - np.asarray(jcache[key]).astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.99


# ---------------------------------------------------------------- models
def test_gector_int8_forward_matches_jax(jx, gector):
    jp, tp = gector
    toks = np.random.default_rng(0).integers(0, GCFG.vocab_size, (3, 40))
    mask = np.ones((3, 40), bool)
    mask[1, 25:] = False
    jq = jx["jq"].quantize_params(jp)
    tq = quantize_params(tp)
    jt_, jd = jx["jg"].gector_forward(jx["gcfg"], jq, jx["jnp"].asarray(toks))
    tt, td = tg.gector_forward(GCFG, tq, torch.from_numpy(toks))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt_), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(
        tg.predict_tags(GCFG, tq, toks, mask),
        jx["jg"].predict_tags(jx["gcfg"], jq, toks, mask))
    assert not np.array_equal(tt.numpy(), tg.gector_forward(
        GCFG, tp, torch.from_numpy(toks))[0].numpy())   # int8 took effect


@pytest.mark.parametrize("sampled", [False, True])
def test_qwen2_int8_weights_and_kv_match_jax(jx, qwen2, sampled):
    """Prefill logits, then decode_segment over int8 caches: the same
    tokens, emissions and state as JAX, caches within float noise."""
    jp, tp = qwen2
    jnp, jt = jx["jnp"], jx["jt"]
    jq, tq = jx["jq"].quantize_params(jp), quantize_params(tp)
    B, S, n = 4, 10, 6
    toks = np.random.default_rng(9).integers(0, QCFG.vocab_size, (B, S))
    jc = jt.make_caches(jx["qcfg"], B, S + n + 1, dtype=jnp.float32,
                        kv_quant="int8")
    jlog, jc, _ = jt.forward(jx["qcfg"], jq, tokens=jnp.asarray(toks),
                             caches=jc, mode="full")
    tc = make_caches(QCFG, B, S + n + 1, dtype=torch.float32,
                     kv_quant="int8", device="cpu")
    tlog = forward(QCFG, tq, tokens=torch.from_numpy(toks), caches=tc,
                   mode="full")
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=0)
    first = np.asarray(jlog[:, -1].argmax(-1)).astype(np.int32)[:, None]
    pos = np.full((B, 1), S, np.int32)
    budget = np.array([6, 2, 6, 6], np.int32)
    if sampled:
        temp = np.array([0.0, 0.8, 1.0, 0.5], np.float32)
        topk = np.array([0, 50, 0, 5], np.int32)
        seed = np.array([1, 2, 3, 4], np.int32)
        jkw = dict(temperature=jnp.asarray(temp), top_k=jnp.asarray(topk),
                   seed=jnp.asarray(seed))
        tkw = dict(temperature=torch.from_numpy(temp),
                   top_k=torch.from_numpy(topk), seed=torch.from_numpy(seed))
    else:
        jkw, tkw = {}, {}
    jtoks, jem, jstate, jc = jt.decode_segment(
        jx["qcfg"], jq, jnp.asarray(first), jnp.asarray(pos), jc, n_steps=n,
        budget=jnp.asarray(budget), **jkw)
    ttoks, tem, tstate, _ = decode_segment(
        QCFG, tq, torch.from_numpy(first), torch.from_numpy(pos), tc,
        n_steps=n, budget=torch.from_numpy(budget), **tkw)
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    for key in ("tok", "pos", "active", "budget"):
        np.testing.assert_array_equal(tstate[key].numpy(),
                                      np.asarray(jstate[key]), err_msg=key)
    for key in ("pos", "len"):
        np.testing.assert_array_equal(tc["blk0"][key].numpy(),
                                      np.asarray(jc["blk0"][key]))
    np.testing.assert_allclose(tc["blk0"]["k_scale"].numpy(),
                               np.asarray(jc["blk0"]["k_scale"]), rtol=1e-5,
                               atol=0)
    # one more decode step's logits, read through the int8 ring
    tok = np.array(jstate["tok"])
    spos = np.array(jstate["pos"])
    jl, _, _ = jt.forward(jx["qcfg"], jq, tokens=jnp.asarray(tok),
                          positions=jnp.asarray(spos), caches=jc,
                          mode="decode")
    tl = forward(QCFG, tq, tokens=torch.from_numpy(tok),
                 positions=torch.from_numpy(spos), caches=tc, mode="decode")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


# --------------------------------------------------------------- engines
def _serve(eng, submit, items):
    try:
        futs = [submit(eng, it) for it in items]
        return [f.result(timeout=300) for f in futs], eng.metrics()
    finally:
        eng.close()


def test_encoder_engine_int8_tags_equal_the_jax_engine(jx, gector):
    jp, tp = gector
    jnp = jx["jnp"]

    def jax_tags(params, hid, mask):
        logits = hid.astype(jnp.float32) @ params["label_head"]["w"]
        return jnp.where(mask, jnp.argmax(logits, -1), KEEP)

    rng = np.random.default_rng(2)
    sents = [rng.integers(0, GCFG.vocab_size, int(rng.integers(3, 17)))
             for _ in range(6)]
    kw = dict(mode="encoder", weight_quant="int8", max_batch=8,
              pad_buckets=(16, 32))
    want, jm = _serve(
        jx["Engine"](jx["gcfg"], jp, jx["EngineConfig"](**kw),
                     head_fn=jax_tags),
        lambda e, s: e.submit(s), sents)
    got, m = _serve(ServingEngine(GCFG, tp, EngineConfig(**kw),
                                  head_fn=tg.tag_head, device="cpu"),
                    lambda e, s: e.submit(s), sents)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert m["weight_bytes"] == jm["weight_bytes"]
    assert m["weight_bytes"] == params_bytes(quantize_params(tp))


def test_decoder_engine_int8_tokens_equal_the_jax_engine(jx, qwen2):
    """Greedy, sampled, budget-capped and eos-stopped rows with int8
    weights and an int8 KV cache; the eos id is a token the JAX greedy
    stream reaches."""
    jp, tp = qwen2
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, QCFG.vocab_size, int(rng.integers(3, 17)))
               for _ in range(5)]
    kw = dict(DECODER, weight_quant="int8", kv_quant="int8")
    jax_engine = lambda: jx["Engine"](jx["qcfg"], jp,  # noqa: E731
                                      jx["EngineConfig"](**kw))
    gen = lambda e, ps: e.generate(*ps)  # noqa: E731
    greedy, _ = _serve(jax_engine(), gen,
                       [(p, jx["Sampling"]()) for p in prompts])
    sampling = [dict(), dict(temperature=0.8, top_k=50, seed=3),
                dict(temperature=1.0, seed=9), dict(max_new_tokens=2),
                dict(eos_id=int(greedy[4].tokens[1]))]
    want, jm = _serve(jax_engine(), gen,
                      [(p, jx["Sampling"](**s))
                       for p, s in zip(prompts, sampling)])
    got, m = _serve(ServingEngine(QCFG, tp, EngineConfig(**kw),
                                  device="cpu"), gen,
                    [(p, SamplingParams(**s))
                     for p, s in zip(prompts, sampling)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.finish_reason == w.finish_reason
    assert [g.finish_reason for g in got][3:] == ["length", "eos"]
    assert m["weight_bytes"] == jm["weight_bytes"] < params_bytes(tp)


def test_default_engine_keeps_the_callers_float_leaves(qwen2):
    _, tp = qwen2
    eng = ServingEngine(QCFG, tp, EngineConfig(**DECODER), device="cpu")
    try:
        assert quantized_leaf_count(eng.params) == 0
        got, want = _flat(eng.params), _flat(tp)
        assert all(got[k] is want[k] for k in want)
        assert eng.metrics()["weight_bytes"] == params_bytes(tp)
    finally:
        eng.close()
    caches = make_caches(QCFG, 2, 8, dtype=torch.float32,
                         kv_quant=eng.ec.kv_quant, device="cpu")
    assert "k_scale" not in caches["blk0"]
    assert caches["blk0"]["k"].dtype == torch.float32


# ------------------------------------------------------ on the card only
K3_CARD_SHAPES = [  # (M, K, N): the main paths' (K, N) and ragged edges
    (1, 896, 896), (32, 896, 128), (32, 896, 9728), (32, 4864, 896),
    (4096, 768, 768), (4096, 3072, 768), (33, 72, 40), (5, 300, 17)]


@requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("M,K,N", K3_CARD_SHAPES)
def test_k3_k4_cuda_kernels_match_plain(M, K, N, dtype, tol):
    """Tolerances relative to the output's scale: fp32 1e-4 (TF32 off,
    another sum order), bf16 2e-2 (one bf16 rounding of the output)."""
    x, qw, scale = _mm_inputs(M, K, N, seed=K, zero_col=N // 2)
    tx = torch.from_numpy(x).cuda().to(dtype)
    tq, ts = torch.from_numpy(qw).cuda(), torch.from_numpy(scale).cuda()
    before = (int8_matmul.launches, cache_matmul.launches)
    got = ops.matmul_q8(tx, tq, ts)
    w = (tq.float() * ts).to(dtype)
    got4 = ops.matmul(tx, w)
    torch.cuda.synchronize()
    assert (int8_matmul.launches, cache_matmul.launches) == \
        (before[0] + 1, before[1] + 1)
    for out, ref in ((got, int8_matmul_plain(tx.float(), tq, ts)),
                     (got4.float(), cache_matmul_plain(tx.float(), w))):
        ref = ref.float()
        err = (out - ref).abs().max().item()
        assert err <= tol * max(ref.abs().max().item(), 1e-30), err
    assert (got[:, N // 2] == 0).all()


@requires_cuda
def test_k3_k4_cuda_kernels_reject_what_they_do_not_take():
    x = torch.zeros(4, 8, device="cuda")
    qw = torch.zeros(8, 3, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="stride"):
        int8_matmul(x.t().contiguous().t(), qw, torch.ones(3, device="cuda"))
    with pytest.raises(TypeError, match="int8"):
        int8_matmul(x, qw.float(), torch.ones(3, device="cuda"))
    with pytest.raises(ValueError, match="tile"):
        int8_matmul(x, qw, torch.ones(3, device="cuda"),
                    plan=Plan("wgmma", (64, 64, 32), 1, 8))
    with pytest.raises(ValueError, match="split plan"):
        int8_matmul(x, qw, torch.ones(3, device="cuda"),
                    plan=Plan("split", TILES["split"][0], 2, 128))
    with pytest.raises(TypeError, match="x's type"):
        cache_matmul(x, qw)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        int8_matmul(x.half(), qw, torch.ones(3, device="cuda"))


@requires_cuda
@pytest.mark.parametrize("pad", [8, 3])
def test_k3_cuda_reads_x_through_its_row_stride(pad):
    """x as a column slice of a wider tensor: an aligned row stride takes
    the 16-byte loads of the plan's path (here split), an odd one the
    element-wise masked path; either equals a contiguous x on the same
    path, bit for bit."""
    M, K, N = 40, 256, 96
    x, qw, scale = _mm_inputs(M, K, N, seed=pad)
    wide = torch.zeros(M, K + pad, dtype=torch.bfloat16, device="cuda")
    wide[:, :K] = torch.from_numpy(x).cuda().bfloat16()
    tx = wide[:, :K]
    tq, ts = torch.from_numpy(qw).cuda(), torch.from_numpy(scale).cuda()
    taken = launch_plan(tx, tq, matmul_plan(M, N, K))
    assert taken.path == ("split" if pad == 8 else "masked")
    got = ops.matmul_q8(tx, tq, ts)
    want = int8_matmul(tx.contiguous(), tq, ts, plan=taken)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _card_inputs(M, K, N, seed):
    x, qw, scale = _mm_inputs(M, K, N, seed=seed, zero_col=N // 2)
    tx = torch.from_numpy(x).cuda().bfloat16()
    tq, ts = torch.from_numpy(qw).cuda(), torch.from_numpy(scale).cuda()
    return tx, tq, ts, (tq.float() * ts).bfloat16()


@requires_cuda
@pytest.mark.parametrize("K,N", QWEN2_KN)
def test_k3_k4_cuda_rows_are_bit_equal_at_every_decode_width(K, N):
    """The split path's plan does not depend on M, so rows 0..m-1 of a
    product of m rows are the same bits as in the product of 32."""
    tx, tq, ts, w = _card_inputs(32, K, N, seed=N)
    full3, full4 = int8_matmul(tx, tq, ts), cache_matmul(tx, w)
    for m in (1, 2, 4, 8, 16):
        assert torch.equal(int8_matmul(tx[:m], tq, ts), full3[:m]), m
        assert torch.equal(cache_matmul(tx[:m], w), full4[:m]), m


@requires_cuda
@pytest.mark.parametrize("M,K,N", [(32, 4864, 896), (32, 896, 9728),
                                   (4096, 768, 768), (4096, 896, 128)])
def test_k3_k4_cuda_are_deterministic(M, K, N):
    """Two launches give the same bits: the splits' partials are added
    in split order, with no float atomics."""
    tx, tq, ts, w = _card_inputs(M, K, N, seed=M + K)
    assert torch.equal(int8_matmul(tx, tq, ts), int8_matmul(tx, tq, ts))
    assert torch.equal(cache_matmul(tx, w), cache_matmul(tx, w))


@requires_cuda
@pytest.mark.parametrize("M,K,N", [(32, 1000, 256), (7, 4864, 896),
                                   (64, 2056, 48)])
def test_k3_k4_cuda_split_with_a_ragged_last_slab(M, K, N):
    """K not a multiple of the split slab: the last split's rows past K
    are zero-filled, and the sum matches the plain version (bf16
    tolerance, relative to the output's scale)."""
    p = matmul_plan(M, N, K)
    assert p.path == "split" and p.splits > 1 and K % p.kslab
    tx, tq, ts, w = _card_inputs(M, K, N, seed=K)
    for out, ref in ((int8_matmul(tx, tq, ts),
                      int8_matmul_plain(tx.float(), tq, ts)),
                     (cache_matmul(tx, w), cache_matmul_plain(tx.float(), w))):
        err = (out.float() - ref).abs().max().item()
        assert err <= 2e-2 * ref.abs().max().item(), err
    assert (int8_matmul(tx, tq, ts)[:, N // 2] == 0).all()


@requires_cuda
@pytest.mark.parametrize("M", [64, 256])
def test_k3_cuda_converts_every_int8_value_exactly(M):
    """x the identity (M rows, K = M), qw holding every int8 value, scale
    1: each output is one weight, converted to bf16 with no error, on the
    split path (M = 64) and the wgmma path (M = 256)."""
    K, N = M, 256
    k = torch.arange(K)[:, None]
    n = torch.arange(N)[None, :]
    qw = ((k * 37 + n) % 256 - 128).to(torch.int8).cuda()
    x = torch.eye(M, K, dtype=torch.bfloat16, device="cuda")
    out = int8_matmul(x, qw, torch.ones(N, device="cuda"))
    assert matmul_plan(M, N, K).path == ("split" if M <= 64 else "wgmma")
    assert torch.equal(out, qw.bfloat16())


@requires_cuda
def test_smem_bytes_match_the_cuda_source():
    from repro_torch.kernels.int8_matmul import _lib
    lib, code = _lib(), {"masked": 0, "wgmma": 1, "split": 2}
    for path, tiles in TILES.items():
        for tile in tiles:
            rows = SPLIT_ROWS if path == "split" else (tile[0],)
            for r in rows:
                t = (r,) + tuple(tile[1:])
                for w_dtype in (torch.int8, torch.bfloat16):
                    got = lib.int8_matmul_smem(code[path], *t, 1,
                                               int(w_dtype == torch.int8))
                    assert got == smem_bytes(path, t, w_dtype), (path, t)


@requires_cuda
def test_int8_decode_segment_on_cuda_never_waits_for_the_card():
    """int8 weights and an int8 KV cache on the card: K3 six times per
    layer and step, K2 once, no host sync (sync debug mode "error"), and
    logits within bf16 noise of the plain path. The smoke config widened
    to Qwen2's head dim of 64, which the kernels take."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                              d_model=896)
    params = quantize_params(init_params(cfg, 0, device="cuda"))
    B, S, n = 3, 9, 5
    toks = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab_size, (B, S))).cuda()
    logits = {}
    for plain in (False, True):
        caches = make_caches(cfg, B, S + n + 1, dtype=torch.float32,
                             kv_quant="int8", device="cuda")
        logits[plain] = forward(cfg, params, tokens=toks, caches=caches,
                                plain_attention=plain, plain_matmul=plain)
    diff = (logits[False] - logits[True]).abs().max().item()
    assert diff <= 5e-2 * logits[True].abs().max().item()
    first = logits[False][:, -1].argmax(-1).to(torch.int32)[:, None]
    pos = torch.full((B, 1), S, dtype=torch.int32, device="cuda")
    before = (decode_attention.launches, int8_matmul.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, emits, _, _ = decode_segment(cfg, params, first, pos, caches,
                                          n_steps=n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (decode_attention.launches, int8_matmul.launches) == \
        (before[0] + cfg.n_layers * n, before[1] + 6 * cfg.n_layers * n)
    assert emits.all() and ((out >= 0) & (out < cfg.vocab_size)).all()
