"""stablelm-12b in the port against the JAX package, on the CPU.

The smoke config (2 layers, LayerNorm, GQA 8/2, an untied head; fp32,
weights initialized in JAX and bridged through numpy) is held against
JAX: the configs field for field, ``forward`` logits, a prefill and 8
greedy decode steps, ``prefill_chunk`` at C = 4 (logits within 1e-4,
tokens, positions and lengths exactly), and the continuous engine
against the JAX continuous engine, greedy and sampled, in fp32, with
int8 weights and KV, and chunked with the prefix cache (tokens, finish
reasons and prefix counters exactly). ``init_params`` drawing each
period into a preallocated stack gives the tensors of stacking the
periods' trees, for every ported family. K1's and K2's plain versions
at stablelm's head dim of 160 are held against ``kernels/ref.py`` and
the Pallas kernels in interpret mode. JAX is imported in a fixture.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import (decode_segment, forward, init_params,
                                make_caches, prefill_chunk)
from repro_torch.models import transformer as tt
from repro_torch.models.layers import (embed_init, lm_head_init, norm_init,
                                       pos_embed_init)
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.api import SamplingParams

NAME = "stablelm-12b"
CFG = dataclasses.replace(get_config(NAME, smoke=True), dtype="float32")
BASE = dict(mode="decoder", max_batch=4, max_new_tokens=6,
            pad_buckets=(16, 32), decode_segment=2)
COUNTERS = ("prefix_hits", "prefix_misses", "prefix_hit_tokens",
            "prefix_inserts", "prefix_evictions", "prefix_bytes")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.kernels import decode_attention as jda
    from repro.kernels import flash_attention as jfa
    from repro.kernels import ref
    from repro.models import transformer as jt
    from repro.serving import EngineConfig as JaxEngineConfig
    from repro.serving import ServingEngine as JaxServingEngine
    from repro.serving.api import SamplingParams as JaxSamplingParams
    jcfg = dataclasses.replace(jax_get_config(NAME, smoke=True),
                               dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    # jitted once a config: the steps' eager dispatch dominated the tests
    jit = dict(
        prefill=jax.jit(jt.prefill, static_argnums=0,
                        static_argnames=("long_ctx",)),
        decode_step=jax.jit(jt.decode_step, static_argnums=0,
                            static_argnames=("long_ctx",)),
        prefill_chunk=jax.jit(jt.prefill_chunk, static_argnums=0,
                              static_argnames=("long_ctx",)))
    return dict(jax=jax, jnp=jnp, jt=jt, jit=jit, jda=jda, jfa=jfa, ref=ref,
                get_config=jax_get_config, cfg=jcfg, params=jp,
                tparams=to_torch(jax.tree.map(np.asarray, jp), device="cpu"),
                Engine=JaxServingEngine, EngineConfig=JaxEngineConfig,
                Sampling=JaxSamplingParams)


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max(), err_msg=what)


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (B, S))


# ---------------------------------------------------------------- model
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_equals_jax(jx, smoke):
    """Every field JAX's config has, equal; the port's own
    ``embed_scale`` off, as JAX's name test leaves a stablelm unscaled."""
    port = dataclasses.asdict(get_config(NAME, smoke=smoke))
    want = dataclasses.asdict(jx["get_config"](NAME, smoke=smoke))
    assert port.pop("embed_scale") is False
    assert port == want
    assert get_config(NAME, smoke=smoke).head_dim_ == (32 if smoke else 160)
    assert not get_config(NAME, smoke=smoke).fused_qkv


def test_forward_logits_match_jax(jx):
    toks = _tokens(2, 24, 1)
    want, _, _ = jx["jt"].forward(jx["cfg"], jx["params"],
                                  tokens=jx["jnp"].asarray(toks))
    got = forward(CFG, jx["tparams"], tokens=torch.from_numpy(toks))
    _close(got.numpy(), want)
    assert "lm_head" in jx["tparams"] and "bias" in \
        jx["tparams"]["blocks"]["blk0"]["norm1"]


@pytest.mark.parametrize("width", [None, 5], ids=["own", "padded"])
def test_prefill_and_greedy_decode_match_jax(jx, width):
    """A prefill of 12 tokens into caches of 32 slots, then 8 greedy
    decode steps, at the batch's own width and at a ``decode_width`` of 5
    (zero rows past the batch, as the continuous engine's narrow tiers
    run): every step's logits within 1e-4, the tokens and the caches'
    positions and lengths exactly."""
    jnp, jt = jx["jnp"], jx["jt"]
    B, S, L = 2, 12, 32
    toks = _tokens(B, S, 2)
    jc = jt.make_caches(jx["cfg"], B, L, dtype=jnp.float32)
    tc = make_caches(CFG, B, L, dtype=torch.float32, device="cpu")
    want, jc, _ = jx["jit"]["prefill"](jx["cfg"], jx["params"],
                                       jnp.asarray(toks), jc)
    got = forward(CFG, jx["tparams"], tokens=torch.from_numpy(toks),
                  caches=tc)
    _close(got.numpy(), want, "prefill")
    jtok = np.asarray(want[:, -1]).argmax(-1)[:, None].astype(np.int32)
    ttok = torch.from_numpy(jtok.copy())
    for t in range(8):
        pos = np.full((B, 1), S + t, np.int32)
        want, jc, _ = jx["jit"]["decode_step"](
            jx["cfg"], jx["params"], jnp.asarray(jtok), jnp.asarray(pos), jc)
        got = forward(CFG, jx["tparams"], tokens=ttok,
                      positions=torch.from_numpy(pos), caches=tc,
                      mode="decode", decode_width=width)
        assert got.shape[0] == B
        _close(got.numpy(), want, f"step {t}")
        jtok = np.asarray(want[:, -1]).argmax(-1)[:, None].astype(np.int32)
        ttok = got[:, -1].argmax(-1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), jtok)
    for b in jc:
        for k in ("pos", "len"):
            np.testing.assert_array_equal(tc[b][k].numpy(),
                                          np.asarray(jc[b][k]))


def test_decode_segment_tokens_match_jax(jx):
    """``decode_segment``'s greedy and sampled tokens and state equal
    JAX's exactly."""
    jnp, jt = jx["jnp"], jx["jt"]
    B, S, L = 3, 10, 24
    toks = _tokens(B, S, 3)
    jc = jt.make_caches(jx["cfg"], B, L, dtype=jnp.float32)
    tc = make_caches(CFG, B, L, dtype=torch.float32, device="cpu")
    want, jc, _ = jx["jit"]["prefill"](jx["cfg"], jx["params"],
                                       jnp.asarray(toks), jc)
    forward(CFG, jx["tparams"], tokens=torch.from_numpy(toks), caches=tc)
    first = np.asarray(want[:, -1]).argmax(-1)[:, None].astype(np.int32)
    pos = np.full((B, 1), S, np.int32)
    temp = np.array([0.0, 0.8, 1.0], np.float32)
    topk = np.array([0, 20, 0], np.int32)
    seed = np.array([1, 2, 3], np.int32)
    jtoks, jem, jstate, _ = jt.decode_segment(
        jx["cfg"], jx["params"], jnp.asarray(first), jnp.asarray(pos), jc,
        n_steps=6, temperature=jnp.asarray(temp), top_k=jnp.asarray(topk),
        seed=jnp.asarray(seed))
    ttoks, tem, tstate, _ = decode_segment(
        CFG, jx["tparams"], torch.from_numpy(first), torch.from_numpy(pos),
        tc, n_steps=6, temperature=torch.from_numpy(temp),
        top_k=torch.from_numpy(topk), seed=torch.from_numpy(seed))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    for k in ("tok", "pos", "budget"):
        np.testing.assert_array_equal(tstate[k].numpy(),
                                      np.asarray(jstate[k]))


def test_prefill_chunk_matches_jax(jx):
    """Two rows of 22 tokens, chunks of 4 (the last padded), into caches
    of 40 slots: every chunk's logits and the final caches equal JAX's."""
    jnp, jt = jx["jnp"], jx["jt"]
    B, S, C, L = 2, 22, 4, 40
    toks = _tokens(B, S, 4)
    jc = jt.make_caches(jx["cfg"], B, L, dtype=jnp.float32)
    tc = make_caches(CFG, B, L, dtype=torch.float32, device="cpu")
    for s0 in range(0, S, C):
        t = np.zeros((B, C), np.int32)
        t[:, :min(C, S - s0)] = toks[:, s0:s0 + C]
        pos = np.broadcast_to(s0 + np.arange(C, dtype=np.int32), (B, C))
        want, jc, _ = jx["jit"]["prefill_chunk"](
            jx["cfg"], jx["params"], jnp.asarray(t), jnp.asarray(pos), jc)
        got = prefill_chunk(CFG, jx["tparams"], torch.from_numpy(t).long(),
                            torch.from_numpy(pos.copy()), tc)
        _close(got.numpy(), want, f"chunk at {s0}")
    for b in jc:
        for k in jc[b]:
            w = np.asarray(jc[b][k])
            if w.dtype == np.int32:
                np.testing.assert_array_equal(tc[b][k].numpy(), w)
            else:
                _close(tc[b][k].numpy(), w, f"{b}/{k}")


# --------------------------------------------------------------- engine
def _prompts(n, lo, hi, seed, sys_tokens=0):
    rng = np.random.default_rng(seed)
    sysp = rng.integers(0, CFG.vocab_size, (sys_tokens,))
    return [np.concatenate([sysp, rng.integers(
        0, CFG.vocab_size, int(rng.integers(lo, hi + 1)))])
        for _ in range(n)]


def _sampling(i):
    return (dict(temperature=0.8, top_k=20, seed=7 + i) if i % 2 else {})


def _one_by_one(eng, prompts, sampling):
    """Serve the prompts one after another (hits and inserts then do not
    depend on timing); (results, the window). Closes the engine."""
    try:
        eng.window()
        out = [eng.generate(p, s).result(timeout=300)
               for p, s in zip(prompts, sampling)]
        return out, eng.window()
    finally:
        eng.close()


def _together(eng, prompts, sampling):
    try:
        handles = [eng.generate(p, s) for p, s in zip(prompts, sampling)]
        return [h.result(timeout=300) for h in handles], eng.window()
    finally:
        eng.close()


@pytest.mark.parametrize("kw", [
    {}, dict(weight_quant="int8", kv_quant="int8"),
    dict(prefill_chunk=8, prefix_cache=True, pad_buckets=(32,))],
    ids=["fp32", "int8-w-kv", "chunked-prefix"])
def test_engine_matches_jax(jx, kw):
    """The continuous decoder, greedy and sampled requests: tokens and
    finish reasons equal the JAX engine's. With the prefix cache the
    prompts share a 16-token system prompt and are served one by one,
    so the hit, miss and insert counters equal JAX's too."""
    ec = dict(BASE, **kw)
    if kw.get("prefix_cache"):
        prompts, serve = _prompts(6, 2, 10, 5, sys_tokens=16), _one_by_one
    else:
        prompts = _prompts(4, 3, 16, 6) + _prompts(4, 17, 30, 7)
        serve = _together
    sp = [_sampling(i) for i in range(len(prompts))]
    got, gw = serve(ServingEngine(CFG, jx["tparams"], EngineConfig(**ec),
                                  device="cpu"),
                    prompts, [SamplingParams(**s) for s in sp])
    want, jw = serve(jx["Engine"](jx["cfg"], jx["params"],
                                  jx["EngineConfig"](**ec)),
                     prompts, [jx["Sampling"](**s) for s in sp])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.finish_reason == w.finish_reason
    if kw.get("prefix_cache"):
        lane, jlane = gw["lanes"][32], jw["lanes"][32]
        assert {k: lane[k] for k in COUNTERS} == \
            {k: jlane[k] for k in COUNTERS}
        assert lane["prefix_hits"] >= len(prompts) - 2


# -------------------------------------------------------- init_params
def _stacked_init(cfg, seed):
    """``init_params`` as it was before periods were drawn into
    preallocated stacks: each period's tree drawn, then the periods
    stacked with ``torch.stack``."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    params = {"embed": embed_init(cfg, gen),
              "final_norm": norm_init(cfg, "cpu")}
    if cfg.abs_pos:
        params["pos_embed"] = pos_embed_init(cfg, gen,
                                             min(cfg.max_seq_len, 8192))
    if not cfg.tie_embeddings:
        params["lm_head"] = lm_head_init(cfg, gen)

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)
    params["blocks"] = {
        f"blk{j}": stack([tt._block_init(cfg, kind, gen, "cpu")
                          for _ in range(cfg.n_periods)])
        for j, kind in enumerate(cfg.pattern)}
    return params


def _equal_trees(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _equal_trees(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name,kw", [
    ("qwen2-0.5b", {}), ("recurrentgemma-9b", dict(n_layers=6)),
    ("stablelm-12b", {}), ("gemma2-27b", dict(n_layers=4))],
    ids=["qwen2", "hybrid-2-periods", "stablelm", "gemma2-2-periods"])
def test_init_params_into_preallocated_stacks(name, kw):
    """Every leaf bit-equal to the per-period stack from the same seed, so
    the same seed gives every ported model the weights it had."""
    cfg = dataclasses.replace(get_config(name, smoke=True), **kw)
    _equal_trees(init_params(cfg, 3, device="cpu"), _stacked_init(cfg, 3))


# ----------------------------------------------- K1 / K2 at head dim 160
def _bh(x):
    return x.transpose(0, 2, 1, 3).reshape(-1, x.shape[1], x.shape[3])


@pytest.mark.parametrize("kw", [
    dict(causal=True), dict(causal=True, window=24, softcap=30.0),
    dict(causal=False, kv_len=40)], ids=["causal", "window-softcap",
                                         "kv_len"])
def test_k1_plain_at_head_dim_160_matches_pallas_and_ref(jx, kw):
    """GQA 8/2 at D = 160: the plain version against the Pallas kernel in
    interpret mode (kv heads repeated, as it wants) at the same tiles,
    visits exactly, and against the jnp oracle."""
    B, S, Hq, Hkv, D = 1, 64, 8, 2, 160
    rng = np.random.default_rng(160)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
            for _ in range(2))
    out, visits = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                        bq=16, bk=16, **kw)
    kr, vr = (np.repeat(x, Hq // Hkv, axis=2) for x in (k, v))
    jout, jvis = jx["jfa"].flash_attention(_bh(q), _bh(kr), _bh(vr), bq=16,
                                           bk=16, interpret=True,
                                           return_visits=True, **kw)
    np.testing.assert_allclose(_bh(out.numpy()), np.asarray(jout), atol=2e-5,
                               rtol=0)
    np.testing.assert_array_equal(visits.numpy(), np.asarray(jvis))
    n = kw.get("kv_len", S)            # the oracle takes no kv_len
    want = jx["ref"].flash_attention_ref(
        _bh(q), _bh(kr[:, :n]), _bh(vr[:, :n]),
        **{a: b for a, b in kw.items() if a != "kv_len"})
    np.testing.assert_allclose(_bh(out.numpy()), np.asarray(want), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("window", [None, 40])
def test_k2_plain_at_head_dim_160_matches_pallas_and_ref(jx, window):
    """G = 4 query heads a kv head at D = 160 (stablelm's decode shape) on
    a wrapped ring with empty slots: against the Pallas kernel in
    interpret mode per kv head, visits exactly, and the jnp oracle."""
    B, L, Hq, Hkv, D = 2, 64, 8, 2, 160
    rng = np.random.default_rng(161)
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, L, Hkv, D)).astype(np.float32)
            for _ in range(2))
    kv_pos = np.full((B, L), -1, np.int32)
    for b, n in enumerate((90, 30)):
        p = np.arange(n)[-L:]
        kv_pos[b, p % L] = p
    q_pos = kv_pos.max(1).astype(np.int32)
    out, visits = decode_attention_plain(
        *map(torch.from_numpy, (q, k, v, q_pos, kv_pos)), bk=16,
        window=window)
    got = out.numpy().reshape(B, Hkv, Hq // Hkv, D)
    for h in range(Hkv):
        qh = q[:, 0].reshape(B, Hkv, Hq // Hkv, D)[:, h]
        jout, jvis = jx["jda"].decode_attention(
            qh, k[:, :, h], v[:, :, h], q_pos[:, None], kv_pos, bk=16,
            window=window, interpret=True, return_visits=True)
        np.testing.assert_allclose(got[:, h], np.asarray(jout), atol=2e-5,
                                   rtol=0)
        np.testing.assert_array_equal(visits.numpy().reshape(B, Hkv)[:, h],
                                      np.asarray(jvis)[:, 0])
        want = jx["ref"].decode_attention_ref(
            qh, k[:, :, h], v[:, :, h], q_pos, kv_pos, window=window)
        np.testing.assert_allclose(got[:, h], np.asarray(want), atol=2e-5,
                                   rtol=0)
