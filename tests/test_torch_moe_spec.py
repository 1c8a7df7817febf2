"""Speculative decoding of the MoE models in the port against the JAX
package, on the CPU.

The three MoE smoke configs (qwen2-moe, moonshot, phi3.5-moe; fp32,
weights initialized in JAX and bridged through numpy). JAX's verify
routes a chunk of S = k + 1 positions whole at the capacity C =
max(int(S K cf / E), 4), so a copy can be dropped there that a decode
step never drops. Held here: ``verify_chunk`` logits against JAX's
within 1e-4 and the caches as ``test_torch_spec`` holds them, at k + 1 =
5 under ``test_skewed_router_drops_the_same_copies``'s skewed router,
with a dropped copy asserted; at S <= C, verify logits equal to S
``decode_step`` logits by ``torch.equal`` (float, and int8 weights and
KV); ``spec_round``'s drafts and verify tokens equal to JAX's
(self-drafted: the target's first layer); and the continuous engine with
``spec_decode`` against the JAX spec engine, streams and ``spec_*``
counters exactly, greedy and sampled requests, float and int8 W+KV. JAX
is imported in a fixture.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.launch.experiment import self_draft
from repro_torch.models import (decode_step, forward, init_params,
                                make_caches, spec_round, verify_chunk)
from repro_torch.models import moe as moe_mod
from repro_torch.quant import quantize_params
from repro_torch.serving import EngineConfig, ServingEngine, kvcache
from repro_torch.serving.api import SamplingParams

NAMES = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b")
IDS = ["qwen2-moe", "moonshot", "phi35-moe"]
# qwen2-moe's smoke config at 16 query over 16 kv heads: the fused wqkv
# (with its bias) that the full config takes
FUSED = dict(n_heads=16, n_kv_heads=16)
ATOL = 1e-4
SKEW = 0.02          # test_torch_moe's skewed router: column 0 pulled up
BASE = dict(mode="decoder", max_batch=4, max_new_tokens=6,
            pad_buckets=(32,), decode_segment=2)


def _cfg(name, kw=None):
    return dataclasses.replace(get_config(name, smoke=True), dtype="float32",
                               **(kw or {}))


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models import transformer as jt
    from repro.serving import EngineConfig as JaxEngineConfig
    from repro.serving import ServingEngine as JaxServingEngine
    from repro.serving import kvcache as jkv
    from repro.serving.api import SamplingParams as JaxSamplingParams
    return dict(jax=jax, jnp=jnp, jt=jt, jkv=jkv, get_config=jax_get_config,
                Engine=JaxServingEngine, EngineConfig=JaxEngineConfig,
                Sampling=JaxSamplingParams, models={},
                verify=jax.jit(jt.verify_chunk, static_argnums=0),
                prefill=jax.jit(lambda c, p, t, caches: jt.forward(
                    c, p, tokens=t, caches=caches, mode="full")[1],
                    static_argnums=0),
                spec_round=jax.jit(jt.spec_round, static_argnums=(0, 2),
                                   static_argnames=("k",)))


def _model(jx, name, kw=None, skew=0.0):
    """(jax cfg, jax params, port cfg, port params), made once a model;
    ``skew`` is added to column 0 of every layer's router in both."""
    key = (name, tuple(sorted((kw or {}).items())), skew)
    if key not in jx["models"]:
        jax = jx["jax"]
        jcfg = dataclasses.replace(jx["get_config"](name, smoke=True),
                                   dtype="float32", **(kw or {}))
        tree = jax.tree.map(np.array, jax.jit(
            jx["jt"].init_params, static_argnums=0)(
                jcfg, jax.random.PRNGKey(0)))
        for blk in tree["blocks"].values():
            blk["moe"]["router"][..., 0] += np.float32(skew)
        jx["models"][key] = (jcfg, jax.tree.map(jx["jnp"].asarray, tree),
                             _cfg(name, kw), to_torch(tree, device="cpu"))
    return jx["models"][key]


def _jax_draft(jx, jcfg, jp):
    """JAX's self-draft (``repro/launch/experiment.py``): the target's
    first layer with its embeddings and head."""
    dp = dict(jp)
    dp["blocks"] = jx["jax"].tree.map(lambda x: x[:1], jp["blocks"])
    return (dataclasses.replace(jcfg, name=f"{jcfg.name}-draft",
                                n_layers=len(jcfg.pattern)), dp)


def _filled(jx, jcfg, jp, cfg, tp, B, L, lens, seed):
    """JAX and port caches of L slots prefilled with the same 16-token
    prompts and cut at ``lens`` (the spec engine's install)."""
    jnp = jx["jnp"]
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, 16)).astype(np.int32)
    jc = jx["prefill"](jcfg, jp, jnp.asarray(toks),
                       jx["jt"].make_caches(jcfg, B, L, dtype=jnp.float32))
    jc = jx["jkv"]._scatter_rollback(
        jc, jx["jax"].tree.map(jnp.copy, jc), jnp.arange(B, dtype=jnp.int32),
        jnp.asarray(lens))
    tc = make_caches(cfg, B, L, dtype=torch.float32, device="cpu")
    forward(cfg, tp, tokens=torch.from_numpy(toks).long(), caches=tc,
            return_hidden=True)
    kvcache._scatter_rollback(tc, kvcache._take_slots(tc, torch.arange(B)),
                              torch.arange(B), torch.from_numpy(lens))
    return jc, tc


def _caches_equal(tc, jc):
    for b in jc:
        for key in jc[b]:
            w, g = np.asarray(jc[b][key]), tc[b][key].numpy()
            if w.dtype == np.int32:
                np.testing.assert_array_equal(g, w, err_msg=f"{b}/{key}")
            else:
                np.testing.assert_allclose(g, w, rtol=ATOL,
                                           atol=ATOL * np.abs(w).max(),
                                           err_msg=f"{b}/{key}")


@pytest.fixture
def drops(monkeypatch):
    """A list that gathers the copies ``moe.dispatch`` drops, per call."""
    seen, dispatch = [], moe_mod.dispatch

    def counted(cfg, ids, C):
        d = dispatch(cfg, ids, C)
        seen.append(int((~d[3]).sum()))
        return d
    monkeypatch.setattr(moe_mod, "dispatch", counted)
    return seen


# ---------------------------------------------------------------- verify
@pytest.mark.parametrize("name", NAMES, ids=IDS)
def test_verify_chunk_matches_jax(jx, name, drops):
    """k + 1 = 5 positions a row (C = 4: a copy can drop) under the skewed
    router: logits within 1e-4 of JAX's, the caches equal, and at least
    one copy dropped in some layer."""
    jcfg, jp, cfg, tp = _model(jx, name, skew=SKEW)
    B, S, L = 3, 5, 32
    lens = np.array([6, 11, 14], np.int32)
    jc, tc = _filled(jx, jcfg, jp, cfg, tp, B, L, lens, 7)
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = (lens[:, None] + np.arange(S, dtype=np.int32)).astype(np.int32)
    want, jc, _ = jx["verify"](jcfg, jp, jx["jnp"].asarray(toks),
                               jx["jnp"].asarray(pos), jc)
    drops.clear()
    got = verify_chunk(cfg, tp, torch.from_numpy(toks).long(),
                       torch.from_numpy(pos), tc, decode_width=4)
    want = np.asarray(want)
    assert moe_mod.capacity(cfg, S) == 4 < S
    np.testing.assert_allclose(got.numpy(), want, rtol=ATOL,
                               atol=ATOL * np.abs(want).max())
    _caches_equal(tc, jc)
    assert len(drops) == cfg.n_layers and sum(drops) > 0


@pytest.mark.parametrize("name,kw,quant", [
    ("qwen2-moe-a2.7b", {}, None), ("moonshot-v1-16b-a3b", {}, None),
    ("phi3.5-moe-42b-a6.6b", {}, None),
    ("qwen2-moe-a2.7b", FUSED, "int8")],
    ids=IDS + ["qwen2-moe-fused-int8-w-kv"])
def test_verify_equals_decode_steps_where_nothing_drops(name, kw, quant,
                                                        drops):
    """S = 4 <= C positions a row: no copy can drop, and the verify logits
    equal 4 ``decode_step`` logits by ``torch.equal`` (both at
    ``decode_width`` 4 over 3 rows, in the same caches), float and int8
    weights and KV."""
    cfg = _cfg(name, kw)
    gen = torch.Generator().manual_seed(3)
    tp = init_params(cfg, 3, device="cpu")
    if quant:
        tp = quantize_params(tp)
    B, S, P = 3, 4, 10
    toks = torch.randint(0, cfg.vocab_size, (B, P), generator=gen)
    plain = make_caches(cfg, B, 32, dtype=torch.float32, kv_quant=quant,
                        device="cpu")
    forward(cfg, tp, tokens=toks, caches=plain, return_hidden=True)
    spec = {b: {k: t.clone() for k, t in blk.items()}
            for b, blk in plain.items()}
    chunk = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    pos = P + torch.arange(S)[None].expand(B, S)
    want = torch.cat([decode_step(cfg, tp, chunk[:, s:s + 1],
                                  pos[:, s:s + 1], plain, decode_width=4)
                      for s in range(S)], 1)
    drops.clear()
    got = verify_chunk(cfg, tp, chunk, pos, spec, decode_width=4)
    assert moe_mod.capacity(cfg, S) >= S and sum(drops) == 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,sampled", [
    ("qwen2-moe-a2.7b", False), ("phi3.5-moe-42b-a6.6b", True)],
    ids=["qwen2-moe-greedy", "phi35-moe-sampled"])
def test_spec_round_matches_jax(jx, name, sampled):
    """``spec_round`` at k = 4 with the self-draft (the target's first
    layer): the drafts and the verify tokens equal JAX's, both caches as
    ``_caches_equal`` holds them."""
    jnp = jx["jnp"]
    jcfg, jp, cfg, tp = _model(jx, name, skew=SKEW)
    jdcfg, jdp = _jax_draft(jx, jcfg, jp)
    dcfg, dp = self_draft(cfg, tp)
    B, k, L = 3, 4, 32
    lens = np.array([5, 9, 14], np.int32)
    jc, tc = _filled(jx, jcfg, jp, cfg, tp, B, L, lens, 9)
    jd, td = _filled(jx, jdcfg, jdp, dcfg, dp, B, L, lens, 9)
    tok = np.array([[3], [17], [40]], np.int32)
    pos = lens[:, None].copy()
    samp = {}
    if sampled:
        samp = dict(temperature=np.array([0.8, 0.0, 1.2], np.float32),
                    top_k=np.array([5, 0, 0], np.int32),
                    seed=np.array([1, 2, 3], np.int32))
    jdr, jver, jc, jd = jx["spec_round"](
        jcfg, jp, jdcfg, jdp, jnp.asarray(tok), jnp.asarray(pos), jc, jd,
        k=k, **{n: jnp.asarray(a) for n, a in samp.items()})
    tdr, tver, tc, td = spec_round(
        cfg, tp, dcfg, dp, torch.from_numpy(tok), torch.from_numpy(pos), tc,
        td, k=k, decode_width=4,
        **{n: torch.from_numpy(a) for n, a in samp.items()})
    np.testing.assert_array_equal(tdr.numpy(), np.asarray(jdr))
    np.testing.assert_array_equal(tver.numpy(), np.asarray(jver))
    _caches_equal(tc, jc)
    _caches_equal(td, jd)


# ---------------------------------------------------------------- engine
def _traffic(cfg):
    """Four prompts of 3-30 tokens, the second and fourth sampled."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, int(n))
               for n in (5, 12, 22, 30)]
    sampling = [{}, dict(temperature=0.8, top_k=20, seed=4), {},
                dict(temperature=1.1, seed=9)]
    return prompts, sampling


def _serve(eng, prompts, sampling, Sampling):
    try:
        hs = [eng.generate(p, Sampling(**s))
              for p, s in zip(prompts, sampling)]
        out = [np.asarray(h.result(timeout=300).tokens) for h in hs]
        return out, eng.metrics()["lanes"]
    finally:
        eng.close()


@pytest.mark.parametrize("name,kw,quant", [
    ("qwen2-moe-a2.7b", {}, None), ("qwen2-moe-a2.7b", FUSED, "int8")],
    ids=["qwen2-moe", "qwen2-moe-fused-int8-w-kv"])
def test_spec_engine_matches_jax_spec_engine(jx, name, kw, quant):
    """The continuous decoder with ``spec_decode`` (spec_k 4, so a verify
    chunk of 5 can drop a copy; self-drafted) against the JAX spec engine
    on the same bridged weights and traffic, greedy and sampled requests
    (at one width, so that JAX compiles fewer programs): equal streams
    and equal ``spec_rounds``/``spec_proposed``/``spec_accepted`` per
    lane, float and int8 weights and KV."""
    jcfg, jp, cfg, tp = _model(jx, name, kw)
    ec = dict(BASE, spec_decode=True, spec_k=4, weight_quant=quant,
              kv_quant=quant, segment_width="fixed")
    prompts, sampling = _traffic(cfg)
    want, jl = _serve(jx["Engine"](jcfg, jp, jx["EngineConfig"](**ec),
                                   draft=_jax_draft(jx, jcfg, jp)),
                      prompts, sampling, jx["Sampling"])
    got, tl = _serve(ServingEngine(cfg, tp, EngineConfig(**ec),
                                   device="cpu", draft=self_draft(cfg, tp)),
                     prompts, sampling, SamplingParams)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    keys = ("spec_rounds", "spec_proposed", "spec_accepted")
    assert {b: {k: tl[b][k] for k in keys} for b in tl} == \
        {b: {k: jl[b][k] for k in keys} for b in jl}
    assert sum(tl[b]["spec_rounds"] for b in tl) > 0
