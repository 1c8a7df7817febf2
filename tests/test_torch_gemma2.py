"""gemma2-27b in the port against the JAX package, on the CPU.

The smoke config (one (attn_local, attn_global) period, window 64,
attention softcap 50, final softcap 30, post-norms, GeGLU, tied
embeddings scaled by sqrt(d_model), long-context cap 128; fp32, weights
initialized in JAX and bridged through numpy) is held against JAX: the
configs field for field, ``forward`` logits, a 100-token prompt past the
window, a prefill and 8 greedy decode steps, ``prefill_chunk`` at C = 4
(logits within 1e-4, tokens, positions and lengths exactly), the
continuous engine against the JAX continuous engine, greedy and sampled,
whole and at ``prefill_chunk=8``. The fused ``wqkv`` layout (gemma2's
own at 16 kv heads; the smoke's 4 kv heads take the split one) is held
on a 32/16-head variant of the smoke config, and ``long_ctx`` by the
caches' shapes and a decode past the cap. JAX is imported in a fixture.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.models import forward, make_caches, prefill_chunk
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.api import SamplingParams

NAME = "gemma2-27b"
SMOKE = get_config(NAME, smoke=True)
CFG = dataclasses.replace(SMOKE, dtype="float32")
# gemma2's fused layout at smoke width: 16 kv heads, two queries each
FUSED = dataclasses.replace(CFG, n_heads=32, n_kv_heads=16, head_dim=16)
BASE = dict(mode="decoder", max_batch=4, max_new_tokens=6,
            pad_buckets=(16, 32), decode_segment=2)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models import transformer as jt
    from repro.serving import EngineConfig as JaxEngineConfig
    from repro.serving import ServingEngine as JaxServingEngine
    from repro.serving.api import SamplingParams as JaxSamplingParams
    jcfg = dataclasses.replace(jax_get_config(NAME, smoke=True),
                               dtype="float32")

    def model(cfg):
        p = jt.init_params(cfg, jax.random.PRNGKey(0))
        return p, to_torch(jax.tree.map(np.asarray, p), device="cpu")
    jfused = dataclasses.replace(jcfg, n_heads=32, n_kv_heads=16,
                                 head_dim=16)
    # jitted once a config: the steps' eager dispatch dominated the tests
    jit = dict(
        prefill=jax.jit(jt.prefill, static_argnums=0,
                        static_argnames=("long_ctx",)),
        decode_step=jax.jit(jt.decode_step, static_argnums=0,
                            static_argnames=("long_ctx",)),
        prefill_chunk=jax.jit(jt.prefill_chunk, static_argnums=0,
                              static_argnames=("long_ctx",)))
    return dict(jax=jax, jnp=jnp, jt=jt, jit=jit, get_config=jax_get_config,
                cfg=jcfg, model=model(jcfg), jfused=jfused,
                fused=model(jfused), Engine=JaxServingEngine,
                EngineConfig=JaxEngineConfig, Sampling=JaxSamplingParams)


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max(), err_msg=what)


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (B, S))


# ---------------------------------------------------------------- model
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_equals_jax(jx, smoke):
    """Every field JAX's config has, equal; the port's ``embed_scale`` on,
    as JAX scales gemma by its name. The full config's 16 kv heads take
    the fused layout, the smoke's 4 do not."""
    port = dataclasses.asdict(get_config(NAME, smoke=smoke))
    want = dataclasses.asdict(jx["get_config"](NAME, smoke=smoke))
    assert port.pop("embed_scale") is True
    assert port == want
    assert get_config(NAME, smoke=smoke).fused_qkv is not smoke


@pytest.mark.parametrize("S", [24, 100], ids=["short", "past-window"])
def test_forward_logits_match_jax(jx, S):
    """Whole prompts, the 100-token one past the local window of 64."""
    jp, tp = jx["model"]
    toks = _tokens(2, S, S)
    want, _, _ = jx["jt"].forward(jx["cfg"], jp,
                                  tokens=jx["jnp"].asarray(toks))
    got = forward(CFG, tp, tokens=torch.from_numpy(toks))
    _close(got.numpy(), want)
    assert {"post_norm1", "post_norm2"} <= set(tp["blocks"]["blk1"])
    assert "lm_head" not in tp


def _prefill_decode(jx, cfg, jcfg, jp, tp, *, S, L, steps=8, seed=2,
                    long_ctx=False, decode_width=None):
    """Prefill S tokens into caches of L slots, then greedy decode steps
    (at ``decode_width``, see ``forward``): every logit within 1e-4 of
    JAX's, the tokens and the caches' positions and lengths exactly.
    Returns the port's caches."""
    jnp, jt = jx["jnp"], jx["jt"]
    B = 2
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    jc = jt.make_caches(jcfg, B, L, dtype=jnp.float32, long_ctx=long_ctx)
    tc = make_caches(cfg, B, L, dtype=torch.float32, device="cpu",
                     long_ctx=long_ctx)
    want, jc, _ = jx["jit"]["prefill"](jcfg, jp, jnp.asarray(toks), jc,
                                       long_ctx=long_ctx)
    got = forward(cfg, tp, tokens=torch.from_numpy(toks), caches=tc,
                  long_ctx=long_ctx)
    _close(got.numpy(), want, "prefill")
    jtok = np.asarray(want[:, -1]).argmax(-1)[:, None].astype(np.int32)
    ttok = torch.from_numpy(jtok.copy())
    for t in range(steps):
        pos = np.full((B, 1), S + t, np.int32)
        want, jc, _ = jx["jit"]["decode_step"](
            jcfg, jp, jnp.asarray(jtok), jnp.asarray(pos), jc,
            long_ctx=long_ctx)
        got = forward(cfg, tp, tokens=ttok, positions=torch.from_numpy(pos),
                      caches=tc, mode="decode", long_ctx=long_ctx,
                      decode_width=decode_width)
        assert got.shape[0] == B
        _close(got.numpy(), want, f"step {t}")
        jtok = np.asarray(want[:, -1]).argmax(-1)[:, None].astype(np.int32)
        ttok = got[:, -1].argmax(-1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), jtok)
    for b in jc:
        for k in ("pos", "len"):
            np.testing.assert_array_equal(tc[b][k].numpy(),
                                          np.asarray(jc[b][k]))
    return tc


@pytest.mark.parametrize("S,L", [(12, 32), (100, 120)],
                         ids=["short", "past-window"])
def test_prefill_and_greedy_decode_match_jax(jx, S, L):
    """The local layer's ring holds min(L, 64) slots: past the window the
    prefill keeps the last 64 positions and decode wraps the ring."""
    jp, tp = jx["model"]
    tc = _prefill_decode(jx, CFG, jx["cfg"], jp, tp, S=S, L=L)
    assert tc["blk0"]["k"].shape[2] == min(L, 64)
    assert tc["blk1"]["k"].shape[2] == L


def test_prefill_chunk_matches_jax(jx):
    """Two rows of 22 tokens, chunks of 4 (the last padded), into caches
    of 40 slots: every chunk's logits and the final caches equal JAX's."""
    jnp, jt = jx["jnp"], jx["jt"]
    jp, tp = jx["model"]
    B, S, C, L = 2, 22, 4, 40
    toks = _tokens(B, S, 4)
    jc = jt.make_caches(jx["cfg"], B, L, dtype=jnp.float32)
    tc = make_caches(CFG, B, L, dtype=torch.float32, device="cpu")
    for s0 in range(0, S, C):
        t = np.zeros((B, C), np.int32)
        t[:, :min(C, S - s0)] = toks[:, s0:s0 + C]
        pos = np.broadcast_to(s0 + np.arange(C, dtype=np.int32), (B, C))
        want, jc, _ = jx["jit"]["prefill_chunk"](
            jx["cfg"], jp, jnp.asarray(t), jnp.asarray(pos), jc)
        got = prefill_chunk(CFG, tp, torch.from_numpy(t).long(),
                            torch.from_numpy(pos.copy()), tc)
        _close(got.numpy(), want, f"chunk at {s0}")
    for b in jc:
        for k in jc[b]:
            w = np.asarray(jc[b][k])
            if w.dtype == np.int32:
                np.testing.assert_array_equal(tc[b][k].numpy(), w)
            else:
                _close(tc[b][k].numpy(), w, f"{b}/{k}")


@pytest.mark.parametrize("layout", ["split", "fused"])
def test_decode_at_a_padded_width_matches_jax(jx, layout):
    """Greedy decode steps at a ``decode_width`` of 5 over B = 2, as the
    continuous engine runs its narrow tiers: zero rows ride through the
    projections, post-norms and MLP, and the batch rows still match JAX's
    decode, on the smoke's split q/k/v and on the fused ``wqkv``."""
    if layout == "split":
        jp, tp = jx["model"]
        _prefill_decode(jx, CFG, jx["cfg"], jp, tp, S=12, L=32, steps=4,
                        decode_width=5)
    else:
        jp, tp = jx["fused"]
        _prefill_decode(jx, FUSED, jx["jfused"], jp, tp, S=12, L=24,
                        steps=4, decode_width=5)


# ------------------------------------------------------------ fused qkv
def test_fused_layout_matches_jax(jx):
    """32 query heads over 16 kv heads take one ``wqkv`` (d, 16, 4, hd)
    in both packages: the port draws it, bridges JAX's, and its forward
    and decode steps equal JAX's."""
    from repro_torch.models import init_params
    assert FUSED.fused_qkv
    own = init_params(FUSED, 0, device="cpu")["blocks"]["blk0"]["attn"]
    assert set(own) == {"wqkv", "wo"}
    assert tuple(own["wqkv"].shape) == (1, 256, 16, 4, 16)
    jp, tp = jx["fused"]
    assert tuple(tp["blocks"]["blk1"]["attn"]["wqkv"].shape) == \
        (1, 256, 16, 4, 16)
    _prefill_decode(jx, FUSED, jx["jfused"], jp, tp, S=12, L=24, steps=4)


# ------------------------------------------------------------- long_ctx
@pytest.mark.parametrize("long_ctx", [False, True])
def test_long_ctx_caches_match_jax(jx, long_ctx):
    """Every leaf's shape equal JAX's, of ``make_caches`` and of a
    ``CachePool``'s slots: the local ring at the window, the global ring
    at max_len, or at the cap of 128 with ``long_ctx``."""
    from repro.serving.kvcache import CachePool as JaxCachePool
    from repro_torch.serving.kvcache import CachePool

    def shapes(tree):
        return {b: {k: tuple(v.shape) for k, v in blk.items()}
                for b, blk in tree.items()}
    jc = jx["jt"].make_caches(jx["cfg"], 3, 300, long_ctx=long_ctx,
                              kv_quant="int8")
    tc = make_caches(CFG, 3, 300, long_ctx=long_ctx, kv_quant="int8",
                     device="cpu")
    assert shapes(tc) == shapes(jc)
    assert tc["blk0"]["k"].shape[2] == 64
    assert tc["blk1"]["k"].shape[2] == (128 if long_ctx else 300)
    pool = CachePool(CFG, 2, 300, long_ctx=long_ctx, device="cpu")
    jpool = JaxCachePool(jx["cfg"], 2, 300, long_ctx=long_ctx)
    assert shapes(pool.caches) == shapes(jpool.caches)
    assert pool.nbytes > 0


def test_decode_past_the_long_ctx_cap_matches_jax(jx):
    """A 140-token prompt into caches of 300 slots under ``long_ctx``: the
    global layer keeps a ring of 128 and attends within 128 positions,
    through the prefill and 8 decode steps past the cap."""
    jp, tp = jx["model"]
    tc = _prefill_decode(jx, CFG, jx["cfg"], jp, tp, S=140, L=300,
                         long_ctx=True, seed=9)
    assert tc["blk1"]["k"].shape[2] == 128
    assert int(tc["blk1"]["pos"].max()) == 147


# --------------------------------------------------------------- engine
def _prompts(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, int(rng.integers(lo, hi + 1)))
            for _ in range(n)]


@pytest.mark.parametrize("kw", [{}, dict(prefill_chunk=8)],
                         ids=["whole", "chunked"])
def test_engine_matches_jax(jx, kw):
    """The continuous decoder, greedy and sampled requests over both
    buckets: tokens and finish reasons equal the JAX engine's."""
    jp, tp = jx["model"]
    ec = dict(BASE, **kw)
    prompts = _prompts(4, 3, 16, 6) + _prompts(4, 17, 30, 7)
    sp = [dict(temperature=0.8, top_k=20, seed=7 + i) if i % 2 else {}
          for i in range(len(prompts))]

    def serve(eng, sampling):
        try:
            handles = [eng.generate(p, s) for p, s in zip(prompts, sampling)]
            return [h.result(timeout=300) for h in handles]
        finally:
            eng.close()
    got = serve(ServingEngine(CFG, tp, EngineConfig(**ec), device="cpu"),
                [SamplingParams(**s) for s in sp])
    want = serve(jx["Engine"](jx["cfg"], jp, jx["EngineConfig"](**ec)),
                 [jx["Sampling"](**s) for s in sp])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.finish_reason == w.finish_reason


def test_int8_and_spec_stay_refused():
    """int8 serving of the local rings is item 15's, and speculative
    decoding and the prefix cache need a pure global-attention pattern,
    as in JAX."""
    tp = {"embed": {}}
    with pytest.raises(NotImplementedError, match="item 15"):
        ServingEngine(CFG, tp, EngineConfig(**BASE, weight_quant="int8"),
                      device="cpu")
    with pytest.raises(ValueError, match="pure global-attention"):
        ServingEngine(CFG, tp, EngineConfig(**BASE, prefill_chunk=8,
                                            prefix_cache=True),
                      device="cpu")


def test_padding_rows_leave_the_batch_rows_as_they_were(jx):
    """A decode step and a verify chunk whose hidden states carry padding
    rows past the batch (what ``forward`` feeds them at a
    ``decode_width`` above B): the batch rows' outputs and caches equal
    the unpadded call's, on the fused layout's attention."""
    from repro_torch.models import attention as ta
    from repro_torch.models.layers import rope_angles
    _, tp = jx["fused"]
    p = {k: t[0] for k, t in tp["blocks"]["blk1"]["attn"].items()}
    rng = np.random.default_rng(5)
    B, W, L = 2, 5, 16
    x = torch.from_numpy(rng.standard_normal((B, 3, FUSED.d_model)).astype(
        np.float32))
    pos = torch.tensor([[4, 5, 6], [7, 8, 9]], dtype=torch.int32)
    outs = []
    for rows in (B, W):
        c = make_caches(FUSED, B, L, dtype=torch.float32, device="cpu")
        c = {k: t[0] for k, t in c["blk1"].items()}
        ta.attn_prefill_chunk(FUSED, p, x, pos, c)
        step = ta.pad_rows(x[:, :1], rows)
        p1 = pos[:, :1] + 3
        a, _ = ta.attn_decode(FUSED, p, step, p1, c,
                              rope=rope_angles(p1, 16, 1e4))
        v, _ = ta.attn_verify_chunk(FUSED, p, ta.pad_rows(x[:, 1:], rows),
                                    pos[:, 1:] + 4, c)
        assert a.shape[0] == v.shape[0] == rows
        outs.append((a[:B], v[:B], c))
    for got, want in zip(outs[1][:2], outs[0][:2]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for k in outs[0][2]:
        torch.testing.assert_close(outs[1][2][k], outs[0][2][k], rtol=1e-5,
                                   atol=1e-5)
