"""The port's xLSTM blocks (mLSTM and sLSTM, xlstm-125m) against the JAX
package, on the CPU.

Inputs are made with numpy from fixed seeds; model weights are the JAX
package's init of the xlstm-125m smoke config in fp32 (one mLSTM and one
sLSTM block), bridged through numpy, with the zero-initialized gate
biases made non-zero so their paths are exercised. Tolerances, stated
per test: block outputs and every state leaf 1e-4; the port's parallel
form against its own recurrence at JAX's tolerances
(``tests/test_attention.py:83``: outputs atol 2e-3 rtol 2e-2, states
atol 1e-3 rtol 1e-2); logits 1e-4; the loss 1e-5 relative and each
gradient 1e-4 of its leaf's largest (``test_torch_training``'s);
tokens, finish reasons, pool contents and checkpoint bytes exactly.
JAX is imported in a fixture.
"""
import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.models import (decode_segment, forward, init_params,
                                make_caches, prefill_chunk, sample_logits)
from repro_torch.models import xlstm as tx
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.engine import _products, prefill_min_m
from repro_torch.serving.kvcache import CachePool
from repro_torch.training import adamw_init, loss_fn
from repro_torch.training import checkpoint as ck
from repro_torch.training.train_loop import value_and_grad
from repro_torch.training.tree import flatten

NAME = "xlstm-125m"
CFG = dataclasses.replace(get_config(NAME, smoke=True), dtype="float32")
ATOL = 1e-4
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
ENGINES = {
    "batch": dict(mode="decoder", continuous=False, pad_buckets=(16, 32),
                  max_new_tokens=5, max_batch=4),
    "continuous": dict(mode="decoder", pad_buckets=(16, 32),
                       max_new_tokens=5, max_batch=4, decode_segment=2),
    "chunked": dict(mode="decoder", pad_buckets=(16, 32), max_new_tokens=6,
                    max_batch=4, decode_segment=2, prefill_chunk=8),
}


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models import transformer as jt
    from repro.models import xlstm as jxl
    from repro.serving import EngineConfig as JaxEngineConfig
    from repro.serving import ServingEngine as JaxServingEngine
    from repro.serving import kvcache as jkv
    from repro.serving.api import SamplingParams as JaxSamplingParams
    from repro.training import checkpoint as jck
    from repro.training import optimizer as jopt
    from repro.training import train_loop as jtl
    jcfg = dataclasses.replace(jax_get_config(NAME, smoke=True),
                               dtype="float32")
    tree = jax.tree.map(np.array, jax.jit(jt.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for path, leaf in flatten(tree).items():
        if path.split("/")[-1].startswith("b_"):
            leaf[...] += 0.2 * rng.standard_normal(leaf.shape)
    return dict(jax=jax, jnp=jnp, jt=jt, jxl=jxl, jkv=jkv, jck=jck,
                jopt=jopt, jtl=jtl, get_config=jax_get_config, cfg=jcfg,
                params=jax.tree.map(jnp.asarray, tree), tree=tree,
                tparams=to_torch(tree, device="cpu"),
                Engine=JaxServingEngine, EngineConfig=JaxEngineConfig,
                Sampling=JaxSamplingParams)


def _first(tree):
    """Period 0 of every leaf (jax or torch)."""
    if isinstance(tree, dict):
        return {k: _first(v) for k, v in tree.items()}
    return tree[0]


def _layer(tree, kind):
    """The first period of the pattern position holding ``kind``."""
    return _first(tree["blocks"][f"blk{CFG.pattern.index(kind)}"][kind])


def _x(B, S, seed, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(
        (B, S, CFG.d_model))).astype(np.float32)


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (B, S))


def _close(got, want, atol=ATOL, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=what)


def _np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------ configs and trees
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_configs_equal_jax(jx, smoke):
    """``get_config("xlstm-125m")`` resolves; every field of JAX's config
    is equal, the port's own ``embed_scale`` off (JAX scales only names
    starting "gemma" or "recurrent")."""
    port = dataclasses.asdict(get_config(NAME, smoke=smoke))
    assert port.pop("embed_scale") is False
    assert port == dataclasses.asdict(jx["get_config"](NAME, smoke=smoke))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_layout_matches_jax(jx, dtype):
    """``init_params`` draws JAX's tree: the same leaves, shapes and
    dtypes (the mLSTM's gates and every ``b_*`` fp32), ``b_fgate`` at
    3.0, the other biases at zero."""
    jax = jx["jax"]
    cfg = dataclasses.replace(CFG, dtype=dtype)
    jcfg = dataclasses.replace(jx["cfg"], dtype=dtype)

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        return tuple(tree.shape), str(tree.dtype).split(".")[-1]
    tp = init_params(cfg, 0, device="cpu")
    assert layout(tp) == layout(jax.eval_shape(
        lambda k: jx["jt"].init_params(jcfg, k), jax.random.PRNGKey(0)))
    m = tp["blocks"]["blk0"]["mlstm"]
    assert torch.equal(m["b_fgate"], torch.full_like(m["b_fgate"], 3.0))
    assert not m["b_igate"].any()
    assert m["w_igate"].dtype == torch.float32
    assert m["w_in"].dtype == cfg.torch_dtype
    s = tp["blocks"]["blk1"]["slstm"]
    assert all(s[f"b_{g}"].dtype == torch.float32 and not s[f"b_{g}"].any()
               for g in "izfo")
    assert tuple(s["ffn"]["w_gate"].shape) == (1, 256, 341)


def test_prefill_min_m_covers_the_xlstm_products():
    """The engine's prefill floor looks at xlstm-125m's own products
    (none of them parts by the rows of M it knows of), and the other
    models' floors are what they were."""
    assert _products(get_config(NAME)) == {
        (768, 3072), (1536, 1536), (1536, 4), (1536, 768), (768, 768),
        (768, 1024), (1024, 768)}
    assert prefill_min_m(get_config(NAME)) == 128
    assert prefill_min_m(get_config("recurrentgemma-9b")) == 448
    assert prefill_min_m(get_config("qwen2-0.5b")) == 128


# ----------------------------------------------------------- the blocks
@pytest.mark.parametrize("S", [100, 300])
def test_mlstm_parallel_form_matches_jax(jx, S):
    """``mlstm_apply`` with no state on S > 1 positions runs the
    chunkwise-parallel form; at S = 300 it crosses the 256-position chunk
    seam. Output and the final {C, n, m} within 1e-4."""
    jnp = jx["jnp"]
    x = _x(2, S, seed=S)
    apply = jx["jax"].jit(jx["jxl"].mlstm_apply, static_argnums=0)
    want, wst = apply(jx["cfg"], _layer(jx["params"], "mlstm"),
                      jnp.asarray(x))
    got, st = tx.mlstm_apply(CFG, _layer(jx["tparams"], "mlstm"),
                             torch.from_numpy(x))
    _close(got, want, what="out")
    for k in ("C", "n", "m"):
        _close(st[k], wst[k], what=k)


def _mlstm_carried(B, seed):
    rng = np.random.default_rng(seed)
    _, nh, hd = tx._mlstm_dims(CFG)
    return {"C": (0.3 * rng.standard_normal((B, nh, hd, hd))).astype(
        np.float32),
        "n": (0.3 * rng.standard_normal((B, nh, hd))).astype(np.float32),
        "m": rng.standard_normal((B, nh)).astype(np.float32)}


def _slstm_carried(B, seed):
    rng = np.random.default_rng(seed)
    shape = (B, CFG.n_heads, CFG.d_model // CFG.n_heads)
    st = {k: (0.5 * rng.standard_normal(shape)).astype(np.float32)
          for k in ("c", "h", "m")}
    st["n"] = (1 + np.abs(rng.standard_normal(shape))).astype(np.float32)
    return st


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_recurrence_matches_jax(jx, kind, carried):
    """The recurrence over 9 positions from a carried non-zero state (the
    state is overwritten in place with JAX's new state) or, for the
    sLSTM, from none; an mLSTM with no state and S = 1 steps from its
    initial state. Output and every state leaf within 1e-4."""
    jnp = jx["jnp"]
    S = 9 if carried or kind == "slstm" else 1
    x = _x(3, S, seed=7)
    st = (_mlstm_carried if kind == "mlstm" else _slstm_carried)(3, 8) \
        if carried else None
    japply = getattr(jx["jxl"], f"{kind}_apply")
    want, wst = japply(jx["cfg"], _layer(jx["params"], kind), jnp.asarray(x),
                       state=None if st is None else
                       {k: jnp.asarray(v) for k, v in st.items()})
    tst = None if st is None else {k: torch.from_numpy(v.copy())
                                   for k, v in st.items()}
    got, ret = getattr(tx, f"{kind}_apply")(CFG, _layer(jx["tparams"], kind),
                                            torch.from_numpy(x), tst)
    if carried:
        assert ret is tst
    _close(got, want, what="out")
    for k in wst:
        _close(ret[k], wst[k], what=k)


def test_parallel_form_equals_the_recurrence(jx):
    """The port's two mLSTM forms over 300 positions (two query chunks),
    at the tolerances JAX holds its own two forms to."""
    p = _layer(jx["tparams"], "mlstm")
    x = torch.from_numpy(_x(2, 300, seed=9))
    par, spar = tx.mlstm_apply(CFG, p, x)
    srec = tx.mlstm_state(CFG, 2, device="cpu")
    rec, _ = tx.mlstm_apply(CFG, p, x, srec)
    _close(par, rec, atol=2e-3, rtol=2e-2)
    for k in ("C", "n", "m"):
        _close(spar[k], srec[k], atol=1e-3, rtol=1e-2, what=k)


def test_prefix_max_is_a_running_maximum():
    """The stabiliser's log-depth scan gives ``torch.cummax``'s values
    exactly, at lengths around powers of two."""
    rng = np.random.default_rng(10)
    for S in (1, 2, 7, 64, 257):
        x = torch.from_numpy(rng.standard_normal((2, S, 3)).astype(
            np.float32))
        assert torch.equal(tx._prefix_max(x), torch.cummax(x, 1).values)


# ------------------------------------------------------------ the model
def test_forward_logits_match_jax(jx):
    """Logits of 40 tokens without caches (the mLSTM's parallel form) and
    into caches (the recurrence), each within 1e-4 of JAX's same call,
    and the caches' states within 1e-4."""
    jnp, jt = jx["jnp"], jx["jt"]
    toks = _tokens(2, 40, seed=11)
    want, _, _ = jt.forward(jx["cfg"], jx["params"],
                            tokens=jnp.asarray(toks))
    got = forward(CFG, jx["tparams"], tokens=torch.from_numpy(toks))
    _close(got, want)
    jc = jt.make_caches(jx["cfg"], 2, 48, dtype=jnp.float32)
    want2, jc, _ = jt.forward(jx["cfg"], jx["params"],
                              tokens=jnp.asarray(toks), caches=jc)
    tc = make_caches(CFG, 2, 48, dtype=torch.float32, device="cpu")
    got2 = forward(CFG, jx["tparams"], tokens=torch.from_numpy(toks),
                   caches=tc)
    _close(got2, want2)
    for b in jc:
        for k in jc[b]:
            _close(tc[b][k], jc[b][k], what=f"{b}/{k}")


@pytest.mark.parametrize("width", [None, 5], ids=["own", "padded"])
def test_prefill_and_greedy_decode_match_jax(jx, width):
    """A prefill of 14 tokens, then 8 greedy ``decode_segment`` steps
    against JAX's on the same caches: equal tokens, and the states after
    them within 1e-4. ``padded`` runs the steps at ``decode_width`` 5 over
    a batch of 3, as the continuous engine's narrow tiers do: the pad rows
    step from the blocks' initial states and only the batch rows' states
    are written back."""
    jnp, jt = jx["jnp"], jx["jt"]
    B, S, n = 3, 14, 8
    toks = _tokens(B, S, seed=12)
    jc = jt.make_caches(jx["cfg"], B, S + n + 1, dtype=jnp.float32)
    jl, jc, _ = jt.forward(jx["cfg"], jx["params"], tokens=jnp.asarray(toks),
                           caches=jc)
    jfirst = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    pos = np.full((B, 1), S, np.int32)
    jtoks, _, _, jc = jt.decode_segment(jx["cfg"], jx["params"], jfirst,
                                        jnp.asarray(pos), jc, n_steps=n)
    tc = make_caches(CFG, B, S + n + 1, dtype=torch.float32, device="cpu")
    logits = forward(CFG, jx["tparams"], tokens=torch.from_numpy(toks),
                     caches=tc)
    first = sample_logits(logits[:, -1])[:, None]
    np.testing.assert_array_equal(first.numpy(), np.asarray(jfirst))
    got, _, _, _ = decode_segment(CFG, jx["tparams"], first,
                                  torch.from_numpy(pos), tc, n_steps=n,
                                  decode_width=width)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtoks))
    for b in jc:
        for k in jc[b]:
            assert tc[b][k].shape[1] == B
            _close(tc[b][k], jc[b][k], what=f"{b}/{k}")


@pytest.mark.parametrize("C", [4, 8])
def test_prefill_chunk_matches_jax(jx, C):
    """Two rows of 22 tokens chunk by chunk (the last chunk padded): every
    chunk's logits and the final states within 1e-4 of JAX's
    ``prefill_chunk``; the states carry across chunks."""
    jnp = jx["jnp"]
    B, S = 2, 22
    toks = _tokens(B, S, seed=13 + C)
    jc = jx["jt"].make_caches(jx["cfg"], B, 40, dtype=jnp.float32)
    tc = make_caches(CFG, B, 40, dtype=torch.float32, device="cpu")
    for s0 in range(0, S, C):
        t = np.zeros((B, C), np.int32)
        t[:, :min(C, S - s0)] = toks[:, s0:s0 + C]
        pos = np.broadcast_to(s0 + np.arange(C, dtype=np.int32), (B, C))
        want, jc, _ = jx["jt"].prefill_chunk(jx["cfg"], jx["params"],
                                             jnp.asarray(t),
                                             jnp.asarray(pos), jc)
        got = prefill_chunk(CFG, jx["tparams"], torch.from_numpy(t).long(),
                            torch.from_numpy(pos.copy()), tc)
        _close(got, want, what=f"chunk at {s0}")
    for b in jc:
        for k in jc[b]:
            _close(tc[b][k], jc[b][k], what=f"{b}/{k}")


# ------------------------------------------------------------ serving
def _serve(eng, prompts, sampling):
    try:
        handles = [eng.generate(p, s) for p, s in zip(prompts, sampling)]
        return [h.result(timeout=300) for h in handles]
    finally:
        eng.close()


@pytest.mark.parametrize("mode", sorted(ENGINES))
def test_engine_matches_jax(jx, mode):
    """Seven requests over both buckets (prompts of 3-30 tokens; with
    ``prefill_chunk=8`` those over 8 fill chunk by chunk), greedy,
    sampled and budget-capped rows: the port's tokens and finish reasons
    equal the JAX engine's in the same mode."""
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, CFG.vocab_size, int(n))
               for n in (3, 12, 20, 30, 7, 16, 25)]
    sampling = [dict(), dict(temperature=0.8, top_k=20, seed=3),
                dict(max_new_tokens=2), dict(temperature=1.0, seed=9),
                dict(), dict(temperature=0.7, top_k=5, seed=1), dict()]
    ec = ENGINES[mode]
    got = _serve(ServingEngine(CFG, jx["tparams"], EngineConfig(**ec),
                               device="cpu"),
                 prompts, [SamplingParams(**s) for s in sampling])
    want = _serve(jx["Engine"](jx["cfg"], jx["params"],
                               jx["EngineConfig"](**ec)),
                  prompts, [jx["Sampling"](**s) for s in sampling])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.finish_reason == w.finish_reason
    assert [len(g.tokens) for g in got][2] == 2


def test_cache_pool_resets_and_gathers_equal_jax(jx):
    """``CachePool`` over xlstm's states, filled with the same random
    numbers as JAX's pool: reset-on-assign writes the template (the
    mLSTM's m at -1e30), and the resets, gathers and scatters leave
    both pools and views equal by ``==``."""
    jnp, jkv = jx["jnp"], jx["jkv"]
    jpool = jkv.CachePool(jx["cfg"], 4, 24, dtype=jnp.float32)
    tpool = CachePool(CFG, 4, 24, dtype=torch.float32, device="cpu")
    m0 = tpool._template["blk0"]["m"]
    assert torch.equal(m0, torch.full_like(m0, -1e30))
    assert not tpool._template["blk1"]["m"].any()
    rng = np.random.default_rng(15)
    for b, blk in tpool.caches.items():
        for k, x in blk.items():
            arr = rng.standard_normal(tuple(x.shape)).astype(np.float32)
            x.copy_(torch.from_numpy(arr))
            jpool.caches[b][k] = jnp.asarray(arr)

    def same(jtree, ttree):
        assert {b: set(v) for b, v in jtree.items()} == \
            {b: set(v) for b, v in ttree.items()}
        for b in jtree:
            for k in jtree[b]:
                np.testing.assert_array_equal(np.asarray(jtree[b][k]),
                                              ttree[b][k].numpy(),
                                              err_msg=f"{b}/{k}")
    for pool in (jpool, tpool):
        assert pool.assign_many(["a", "b"]) == [0, 1]
    same(jpool.caches, tpool.caches)
    assert torch.equal(tpool.caches["blk0"]["m"][:, :2],
                       m0.expand(1, 2, CFG.n_heads))
    jpool.release(0)
    tpool.release(0)
    for gather in (False, True):
        js, jv = jpool.acquire(["c", "d"], gather=gather)
        ts, tv = tpool.acquire(["c", "d"], gather=gather)
        assert js == ts
        same(jpool.caches, tpool.caches)
        same(jv, tv)
        jpool.release_many(js)
        tpool.release_many(ts)
    jidx, jv = jpool.compact_view([3, 1], 4)
    tidx, tv = tpool.compact_view([3, 1], 4)
    assert jidx == tidx
    same(jv, tv)


@pytest.mark.parametrize("kw,err,match", [
    (dict(spec_decode=True), ValueError, "pure global-attention"),
    (dict(prefix_cache=True, prefill_chunk=8), ValueError,
     "pure global-attention"),
    (dict(weight_quant="int8"), NotImplementedError, "item 15"),
    (dict(kv_quant="int8"), NotImplementedError, "item 15")],
    ids=["spec_decode", "prefix_cache", "weight_quant", "kv_quant"])
def test_what_the_recurrent_states_refuse(jx, kw, err, match):
    """Speculative decoding and the prefix cache refuse recurrent states
    with JAX's ``ValueError`` (JAX's engine raises it too); int8 serving
    of the xLSTM blocks is ROADMAP Queue 1 item 15."""
    base = dict(mode="decoder", pad_buckets=(16,), max_new_tokens=4)
    draft = (CFG, jx["tparams"])
    with pytest.raises(err, match=match):
        ServingEngine(CFG, jx["tparams"], EngineConfig(**base, **kw),
                      device="cpu", draft=draft)
    if err is ValueError:
        with pytest.raises(ValueError, match=match):
            jx["Engine"](jx["cfg"], jx["params"],
                         jx["EngineConfig"](**base, **kw),
                         draft=(jx["cfg"], jx["params"]))


# ------------------------------------------------------------ training
def test_loss_and_gradients_match_jax(jx):
    """``loss_fn`` on (2, 41) tokens (the mLSTM's parallel form, the
    sLSTM stepping under autograd): the total and each metric within
    1e-5 of JAX's, every leaf's gradient within 1e-4 of the leaf's
    largest; remat on and off give the same bits. ``b_igate`` shifts
    every i of a head alike, which the stabiliser m absorbs, so its
    gradient is zero but for rounding in both packages: both must stay
    below 1e-6 of the tree's largest gradient instead."""
    jax, jnp = jx["jax"], jx["jnp"]
    toks = np.random.default_rng(16).integers(
        0, CFG.vocab_size, (2, 41)).astype(np.int32)
    (want, wm), wg = jax.jit(jax.value_and_grad(
        lambda p, t: jx["jtl"].loss_fn(jx["cfg"], p, {"tokens": t}),
        has_aux=True))(jx["params"], jnp.asarray(toks))
    batch = {"tokens": torch.from_numpy(toks)}
    grads = {}
    for remat in (True, False):
        (got, gm), grads[remat] = value_and_grad(
            lambda p: loss_fn(CFG, p, batch, remat=remat), jx["tparams"])
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)
        for k in gm:
            np.testing.assert_allclose(float(gm[k]), float(wm[k]),
                                       rtol=LOSS_TOL, atol=1e-7, err_msg=k)
    g, w = flatten(grads[True]), flatten(jax.tree.map(np.asarray, wg))
    assert sorted(g) == sorted(w)
    top = max(float(np.abs(v).max()) for v in w.values())
    for k in g:
        assert torch.equal(g[k], flatten(grads[False])[k]), k
        if k.endswith("/b_igate"):
            assert max(float(g[k].abs().max()),
                       float(np.abs(w[k]).max())) < 1e-6 * top, k
            continue
        scale = max(float(np.abs(w[k]).max()), 1e-12)
        assert float(np.abs(_np(g[k]) - w[k]).max()) <= GRAD_TOL * scale, k
    for k in ("b_fgate", "w_igate", "r_z", "b_o"):
        assert any(key.endswith(k) and float(g[key].abs().max()) > 0
                   for key in g), k


def test_checkpoint_of_an_xlstm_tree_is_byte_equal_to_jax(jx, tmp_path):
    """The smoke tree in bf16 (fp32 gates and biases) with its AdamW
    state: the port's ``save`` writes JAX's bytes, and the port restores
    JAX's file bit for bit."""
    jax = jx["jax"]
    jcfg = dataclasses.replace(jx["cfg"], dtype="bfloat16")
    tree = jax.tree.map(np.array, jx["jt"].init_params(
        jcfg, jax.random.PRNGKey(0)))
    jp = jax.tree.map(jx["jnp"].asarray, tree)
    tp = to_torch(tree, device="cpu")
    assert tp["blocks"]["blk0"]["mlstm"]["w_in"].dtype == torch.bfloat16
    jpath, tpath = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jx["jck"].save(jpath, {"params": jp, "opt": jx["jopt"].adamw_init(jp)})
    ck.save(tpath, {"params": tp, "opt": adamw_init(tp)})
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    back = ck.restore(jpath, device="cpu")["params"]
    for k, v in flatten(back).items():
        assert v.dtype == flatten(tp)[k].dtype and torch.equal(
            v, flatten(tp)[k]), k


def test_train_and_serve_clis_take_xlstm():
    """``launch.train --arch xlstm-125m --smoke --device cpu``: two steps,
    JAX's step lines, finite losses; ``launch.serve`` lists it as a
    decoder."""
    from repro_torch.launch import serve, train
    assert NAME in train.ARCHS and NAME in serve.DECODER_ARCHS
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(["--arch", NAME, "--smoke", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "16"])
    lines = buf.getvalue().splitlines()
    assert [ln.split()[:2] for ln in lines] == [["step", "0"], ["step", "1"]]
    assert all(np.isfinite(float(ln.split()[3])) for ln in lines)


def test_slstm_backward_through_time_matches_autograd():
    """``_SLSTMRecurrence``'s hand-written backward against autograd of
    the same loop (``_slstm_scan``), in float64 over 40 steps from a
    carried state, the gradients of every input within 1e-12 of each
    leaf's largest; its forward is the loop's, bit for bit."""
    rng = np.random.default_rng(17)
    B, S, nh, hd = 2, 40, 4, 16

    def t64(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape))

    wx, b = t64(B, S, 4, nh, hd), t64(4, nh, hd, scale=0.3)
    rT = t64(4, nh, hd, hd, scale=0.2)
    st = [t64(B, nh, hd, scale=0.5) for _ in range(4)]
    st[1] = st[1].abs() + 1                       # n
    args = [t.requires_grad_() for t in (wx, rT, b, *st)]
    hs, cur = tx._slstm_scan(args[0], args[1], args[2],
                             dict(zip("cnhm", args[3:])))
    out = tx._SLSTMRecurrence.apply(*args)
    assert torch.equal(out[0], hs)
    weights = [t64(*t.shape) for t in out]
    want = torch.autograd.grad(
        sum((w * t).sum() for w, t in zip(
            weights, (hs, *(cur[k] for k in "cnhm")))), args)
    got = torch.autograd.grad(
        sum((w * t).sum() for w, t in zip(weights, out)), args)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-12 * float(w.abs().max())
