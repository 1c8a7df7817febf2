"""The port's training (AdamW, the LM and GECToR losses, data, checkpoints,
the CLI) and the backward plain versions of K1 and K5 against the JAX
package, on the CPU.

Inputs are made with numpy from fixed seeds and the weights are JAX's
``init_params`` bridged through ``to_torch``; the configs are the smoke
configs in fp32. Tolerances, stated per test: data, checkpoint files and
restored leaves exactly; losses 1e-5 relative; gradients 1e-4 of the
largest gradient of the leaf (another order of the sums: the port's K1
plain version runs tile by tile, JAX's naive attention in one product, and
K5's plain backward step by step where JAX differentiates an associative
scan); AdamW on given gradients 1e-6 relative; after training steps, the
params within 1e-5 plus twice the summed learning rates (Adam's first
steps divide a gradient by its own magnitude, so an entry whose gradient
is near zero in both packages may step by lr either way) and the metrics
1e-4 relative. The cases marked ``requires_cuda`` launch the backward
kernels and skip on a host without a card; they need no JAX, which is
imported in a fixture.
"""
import dataclasses
import io
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.core.corpus import CorpusConfig, GECCorpus
from repro_torch.core.gector import gector_loss
from repro_torch.kernels import ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru_scan as rs
from repro_torch.models import forward
from repro_torch.models import rglru as tr
from repro_torch.training import (OptConfig, adamw_init, adamw_update,
                                  loss_fn, train_step)
from repro_torch.training import checkpoint as ck
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import global_norm, lr_schedule
from repro_torch.training.train_loop import chunked_ce, value_and_grad
from repro_torch.training.tree import flatten

requires_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                   reason="needs an NVIDIA GPU with CUDA")
ARCHS = ("qwen2-0.5b", "gector-base", "recurrentgemma-9b")
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5


def _cfg(arch):
    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.core import gector as jg
    from repro.core.corpus import CorpusConfig as JCorpusConfig
    from repro.core.corpus import GECCorpus as JGECCorpus
    from repro.kernels import ref
    from repro.models import attention as ja
    from repro.models import rglru as jr
    from repro.models import transformer as jt
    from repro.training import checkpoint as jck
    from repro.training import data as jdata
    from repro.training import optimizer as jopt
    from repro.training import train_loop as jtl
    cfgs = {a: dataclasses.replace(jax_get_config(a, smoke=True),
                                   dtype="float32") for a in ARCHS}
    return dict(jax=jax, jnp=jnp, jg=jg, ref=ref, ja=ja, jr=jr, jt=jt,
                jck=jck, jdata=jdata, jopt=jopt, jtl=jtl, cfgs=cfgs,
                JCorpusConfig=JCorpusConfig, JGECCorpus=JGECCorpus)


@pytest.fixture(scope="module")
def weights(jx):
    """{arch: (jax tree, numpy tree)} from JAX's init at key 0; QKV biases
    and RG-LRU gate biases made non-zero so their gradients are not
    trivially symmetric."""
    jax = jx["jax"]
    out = {}
    for arch, jcfg in jx["cfgs"].items():
        tree = jax.tree.map(np.array, jax.jit(    # writable copies
            jx["jt"].init_params, static_argnums=0)(
                jcfg, jax.random.PRNGKey(0)))
        rng = np.random.default_rng(1)
        for path, leaf in flatten(tree).items():
            name = path.split("/")[-1]
            if name in ("bq", "bk", "bv", "b", "conv_b"):
                leaf[...] = 0.1 * rng.standard_normal(leaf.shape)
        out[arch] = (jax.tree.map(jx["jnp"].asarray, tree), tree)
    return out


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _close_tree(got, want, *, rel):
    """Each leaf within ``rel`` of the leaf's largest magnitude."""
    g, w = flatten(got), flatten(want)
    assert sorted(g) == sorted(w)
    for k in g:
        a, b = _np(g[k]), np.asarray(w[k], np.float32)
        scale = max(float(np.abs(b).max()), 1e-12)
        err = float(np.abs(a - b).max())
        assert err <= rel * scale, (k, err, scale)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, S + 1)).astype(np.int32)


# ------------------------------------------------------------ optimizer
def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    import ml_dtypes
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "h": rng.standard_normal((4, 3, 2)).astype(ml_dtypes.bfloat16),
            "scale": rng.standard_normal((7,)).astype(np.float32),
            "bias": rng.standard_normal((5,)).astype(ml_dtypes.bfloat16)}


@pytest.mark.parametrize("clip", [0.05, 1e9], ids=["clip_active",
                                                   "clip_inactive"])
def test_adamw_update_matches_jax_over_steps(jx, clip):
    jax, jnp = jx["jax"], jx["jnp"]
    oc = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip)
    p_np = _opt_tree(0)
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = to_torch(p_np, device="cpu")
    js, ts = jx["jopt"].adamw_init(jp), adamw_init(tp)
    for step in range(5):
        g_np = _opt_tree(10 + step)
        jp, js, jgn = jx["jopt"].adamw_update(
            oc, jp, jax.tree.map(jnp.asarray, g_np), js)
        tp, ts, tgn = adamw_update(oc, tp, to_torch(g_np, device="cpu"), ts)
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-6)
    for k, v in flatten(tp).items():
        assert v.dtype == to_torch(flatten(p_np)[k], device="cpu").dtype
    _close_tree(tp, jp, rel=1e-6)
    _close_tree(ts["mu"], js["mu"], rel=1e-6)
    _close_tree(ts["nu"], js["nu"], rel=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 5
    assert ts["step"].dtype == torch.int32


def test_lr_schedule_and_global_norm_match_jax(jx):
    oc = OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    got = [float(lr_schedule(oc, s)) for s in range(101)]
    want = [float(jx["jopt"].lr_schedule(oc, s)) for s in range(101)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    got_t = lr_schedule(oc, torch.tensor(37, dtype=torch.int32))
    assert got_t.dtype == torch.float32
    np.testing.assert_allclose(float(got_t), want[37], rtol=1e-6)
    tree = _opt_tree(3)
    np.testing.assert_allclose(
        float(global_norm(to_torch(tree, device="cpu"))),
        float(jx["jopt"].global_norm(jx["jax"].tree.map(jx["jnp"].asarray,
                                                         tree))), rtol=1e-6)


# ----------------------------------------------------------------- data
def test_synthetic_lm_batches_equal_jax(jx):
    dc = dict(vocab_size=1000, seq_len=40, batch_size=3, seed=5)
    got = [b["tokens"] for b in SyntheticLM(DataConfig(**dc)).batches(4)]
    want = [b["tokens"] for b in
            jx["jdata"].SyntheticLM(jx["jdata"].DataConfig(**dc)).batches(4)]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------- checkpoints
def _ckpt_tree():
    import ml_dtypes
    rng = np.random.default_rng(2)
    return {"params": {"w": rng.standard_normal((3, 70)).astype(np.float32),
                       "emb": rng.standard_normal((300, 4)).astype(
                           ml_dtypes.bfloat16),
                       "blocks": {"blk0": {"s": np.ones((2, 5), np.float32)}}},
            "opt": {"step": np.array(3, np.int32),
                    "ids": np.arange(-5, 40000, dtype=np.int32)}}


def _assert_bits_equal(got, want):
    g, w = flatten(got), flatten(want)
    assert sorted(g) == sorted(w)
    for k in g:
        a = g[k].cpu()
        b = np.asarray(w[k])
        if a.dtype == torch.bfloat16:
            assert b.dtype.name == "bfloat16", k
            np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                          b.view(np.int16))
        else:
            assert a.numpy().dtype == b.dtype, k
            np.testing.assert_array_equal(a.numpy(), b)


def test_checkpoints_cross_read_and_bytes_equal(jx, tmp_path):
    jax, jnp = jx["jax"], jx["jnp"]
    tree = _ckpt_tree()
    jpath, tpath = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jx["jck"].save(jpath, jax.tree.map(jnp.asarray, tree))
    ck.save(tpath, to_torch(tree, device="cpu"))
    _assert_bits_equal(ck.restore(jpath, device="cpu"), tree)
    back = jx["jck"].restore(tpath)
    _assert_bits_equal(to_torch(jax.tree.map(np.asarray, back),
                                device="cpu"), tree)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("obj", [
    {"a": 1, "b": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 40]},
    {"neg": [-1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
             -2 ** 40]},
    {"s" * 31: "x" * 31, "t" * 40: "y" * 300, "u": "z" * 70000},
    {"bin": b"", "b255": b"1" * 255, "b256": b"2" * 256, "big": b"3" * 70000},
    {f"k{i}": [i] * i for i in range(20)},
])
def test_messagepack_subset_matches_the_package(obj):
    msgpack = pytest.importorskip("msgpack")
    assert ck.packb(obj) == msgpack.packb(obj)
    assert ck.unpackb(msgpack.packb(obj)) == obj


# --------------------------------------------------------------- losses
def test_chunked_ce_and_loss_fn_match_jax(jx, weights):
    jax, jnp = jx["jax"], jx["jnp"]
    jcfg, cfg = jx["cfgs"]["qwen2-0.5b"], _cfg("qwen2-0.5b")
    jp, p_np = weights["qwen2-0.5b"]
    tp = to_torch(p_np, device="cpu")
    toks = _tokens(cfg, 2, 40)
    toks[0, 5] = -1                            # a masked label
    inputs = np.where(toks[:, :-1] < 0, 0, toks[:, :-1])
    jh = jax.jit(lambda p, t: jx["jt"].forward(
        jcfg, p, tokens=t, return_hidden=True)[0])(jp, jnp.asarray(inputs))
    th = forward(cfg, tp, tokens=torch.from_numpy(inputs),
                 return_hidden=True)
    labels = toks[:, 1:]
    for chunk in (4096, 16):
        want = jax.jit(lambda h, lab, c=chunk: jx["jtl"].chunked_ce(
            jcfg, jp, h, lab, lab >= 0, seq_chunk=c))(jh,
                                                      jnp.asarray(labels))
        got = chunked_ce(cfg, tp, th, torch.from_numpy(labels),
                         torch.from_numpy(labels >= 0), seq_chunk=chunk)
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)
    batch = {"tokens": np.where(toks < 0, 0, toks)}
    want, wm = jax.jit(lambda p, t: jx["jtl"].loss_fn(
        jcfg, p, {"tokens": t}))(jp, jnp.asarray(batch["tokens"]))
    got, gm = loss_fn(cfg, tp, {"tokens": torch.from_numpy(batch["tokens"])})
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)
    assert sorted(gm) == sorted(wm) == ["load_balance", "nll", "router_z"]
    for k in gm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=LOSS_TOL,
                                   atol=1e-7)


def test_loss_fn_raises_on_what_is_not_ported():
    cfg = _cfg("qwen2-0.5b")
    batch = {"tokens": torch.zeros((1, 5), dtype=torch.long)}
    with pytest.raises(NotImplementedError, match="item 14"):
        loss_fn(cfg, {}, batch, seq_shard=True)
    for key in ("enc_embeds", "prefix_embeds"):
        with pytest.raises(NotImplementedError, match="item 13"):
            loss_fn(cfg, {}, dict(batch, **{key: torch.zeros(1)}))


# ------------------------------------------------------------ gradients
@pytest.fixture(scope="module")
def jax_grads(jx, weights):
    """{arch: (loss, grads)} of JAX's ``loss_fn`` (remat on) on a (2, 33)
    token batch."""
    jax, jnp = jx["jax"], jx["jnp"]
    out = {}
    for arch in ARCHS:
        jcfg = jx["cfgs"][arch]
        toks = jnp.asarray(_tokens(jcfg, 2, 32, seed=3))
        fn = jax.jit(jax.value_and_grad(
            lambda p, t, c=jcfg: jx["jtl"].loss_fn(c, p, {"tokens": t})[0]))
        loss, g = fn(weights[arch][0], toks)
        out[arch] = (float(loss), jax.tree.map(np.asarray, g))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_gradients_match_jax(jx, weights, jax_grads, arch):
    cfg = _cfg(arch)
    tp = to_torch(weights[arch][1], device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 2, 32, seed=3))}
    grads = {}
    for remat in (True, False):
        (loss, _), grads[remat] = value_and_grad(
            lambda p: loss_fn(cfg, p, batch, remat=remat), tp)
        np.testing.assert_allclose(float(loss), jax_grads[arch][0],
                                   rtol=LOSS_TOL)
    _close_tree(grads[True], jax_grads[arch][1], rel=GRAD_TOL)
    for k, v in flatten(grads[True]).items():      # remat changes no bit
        assert torch.equal(v, flatten(grads[False])[k]), k


def test_inference_mode_keeps_the_serving_launch(monkeypatch):
    """Under inference mode (every engine program) and without grad,
    ``mha_prefill`` and ``lru_scan`` call the forward as before, never the
    autograd Function; with grad on an input they go through it."""
    seen = []
    monkeypatch.setattr(ops._Attention, "apply",
                        lambda *a: seen.append("k1") or a[0])
    monkeypatch.setattr(ops._LruScan, "apply",
                        lambda *a: seen.append("k5") or a[0])
    q = torch.randn(1, 8, 2, 64)
    a = torch.rand(1, 8, 4)
    with torch.inference_mode():
        ops.mha_prefill(q, q, q)
        ops.lru_scan(a, a)
    ops.mha_prefill(q, q, q)
    ops.lru_scan(a, a)
    assert seen == []
    ops.mha_prefill(q.requires_grad_(), q, q)
    ops.lru_scan(a.requires_grad_(), a)
    assert seen == ["k1", "k5"]


# ---------------------------------------------------------------- steps
def _lr_sum(oc, n):
    return sum(float(lr_schedule(oc, s)) for s in range(1, n + 1))


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_jax(jx, weights, accum):
    jax, jnp = jx["jax"], jx["jnp"]
    arch = "qwen2-0.5b"
    jcfg, cfg = jx["cfgs"][arch], _cfg(arch)
    oc = OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    jp, p_np = weights[arch]
    tp = to_torch(p_np, device="cpu")
    js, ts = jx["jopt"].adamw_init(jp), adamw_init(tp)
    step = jax.jit(lambda p, o, b: jx["jtl"].train_step(
        jcfg, oc, p, o, b, accum_steps=accum))
    n = 3 if accum == 1 else 1
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=24,
                                  batch_size=4, seed=1))
    for b in data.batches(n):
        jp, js, jm = step(jp, js, {"tokens": jnp.asarray(b["tokens"])})
        tp, ts, tm = train_step(cfg, oc, tp, ts,
                                {"tokens": torch.from_numpy(b["tokens"])},
                                accum_steps=accum)
        assert sorted(tm) == sorted(jm)
        for k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, atol=1e-7)
    atol = 1e-5 + 2 * _lr_sum(oc, n)
    for k, v in flatten(tp).items():
        np.testing.assert_allclose(_np(v), np.asarray(flatten(jp)[k]),
                                   atol=atol, rtol=0, err_msg=k)


# --------------------------------------------------------------- GECToR
@pytest.fixture(scope="module")
def gector(jx):
    jax, jnp = jx["jax"], jx["jnp"]
    jcfg, cfg = jx["cfgs"]["gector-base"], _cfg("gector-base")
    jcorp = jx["JGECCorpus"](jx["JCorpusConfig"](
        vocab_size=cfg.vocab_size, edit_words=64, error_rate=0.4, seed=0))
    corp = GECCorpus(CorpusConfig(vocab_size=cfg.vocab_size, edit_words=64,
                                  error_rate=0.4, seed=0))
    jp = jx["jg"].init_gector(jcfg, jax.random.PRNGKey(0), jcorp.vocab)
    return jcfg, cfg, jcorp, corp, jp, jax.tree.map(np.asarray, jp)


def test_gector_loss_and_gradients_match_jax(jx, gector):
    jax, jnp = jx["jax"], jx["jnp"]
    jcfg, cfg, jcorp, corp, jp, p_np = gector
    jb = next(jcorp.batches(4, 24, 1))
    tb = next(corp.batches(4, 24, 1))
    for k in jb:
        np.testing.assert_array_equal(jb[k], tb[k])
    (want, wm), wg = jax.jit(jax.value_and_grad(
        lambda p, b: jx["jg"].gector_loss(jcfg, p, b), has_aux=True))(
            jp, jax.tree.map(jnp.asarray, jb))
    tbatch = {k: torch.from_numpy(v) for k, v in tb.items()}
    (got, gm), g = value_and_grad(
        lambda p: gector_loss(cfg, p, tbatch), to_torch(p_np, device="cpu"))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)
    for k in ("tag_acc", "edit_acc"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-6)
    _close_tree(g, jax.tree.map(np.asarray, wg), rel=GRAD_TOL)


def test_gector_training_loop_matches_jax(jx, gector):
    """Five steps of ``examples/train_gector.py``'s loop (gector_loss,
    AdamW at its settings), the port against JAX."""
    jax, jnp = jx["jax"], jx["jnp"]
    jcfg, cfg, jcorp, corp, jp, p_np = gector
    oc = OptConfig(lr=2e-3, warmup_steps=30, total_steps=5,
                   weight_decay=0.01)

    @jax.jit
    def jstep(p, o, b):
        (l, m), g = jax.value_and_grad(
            lambda pp: jx["jg"].gector_loss(jcfg, pp, b), has_aux=True)(p)
        p, o, _ = jx["jopt"].adamw_update(oc, p, g, o)
        return p, o, l, m

    tp = to_torch(p_np, device="cpu")
    jo, to = jx["jopt"].adamw_init(jp), adamw_init(tp)
    for jb, tb in zip(jcorp.batches(4, 24, 5), corp.batches(4, 24, 5)):
        jp, jo, jl, _ = jstep(jp, jo, jax.tree.map(jnp.asarray, jb))
        tbatch = {k: torch.from_numpy(v) for k, v in tb.items()}
        (tl, _), g = value_and_grad(lambda p: gector_loss(cfg, p, tbatch), tp)
        tp, to, _ = adamw_update(oc, tp, g, to)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    atol = 1e-5 + 2 * _lr_sum(oc, 5)
    for k, v in flatten(tp).items():
        np.testing.assert_allclose(_np(v), np.asarray(flatten(jp)[k]),
                                   atol=atol, rtol=0, err_msg=k)


# ----------------------------------------------------- K1 backward plain
# (B, Sq, Skv, Hq, Hkv, D, bq, bk, kwargs)
K1_CASES = {
    "causal": (2, 40, 40, 4, 4, 64, 16, 8, dict(causal=True)),
    "window": (2, 48, 48, 4, 2, 64, 16, 16, dict(causal=True, window=12)),
    "softcap": (2, 32, 32, 2, 2, 64, 16, 8,
                dict(causal=False, softcap=2.0)),
    "gqa_14_2": (1, 24, 24, 14, 2, 64, 16, 8, dict(causal=True)),
    "kv_len": (2, 30, 45, 4, 2, 64, 16, 16, dict(causal=False, kv_len=33)),
    "d256": (1, 20, 20, 2, 1, 256, 16, 8, dict(causal=True)),
    "ragged_sq": (2, 50, 50, 4, 4, 64, 32, 16,
                  dict(causal=True, window=9, softcap=5.0)),
}


def _qkv(B, Sq, Skv, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D),
                      (B, Sq, Hq, D))]


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_backward_plain_matches_jax_grad(jx, case):
    jax, jnp = jx["jax"], jx["jnp"]
    B, Sq, Skv, Hq, Hkv, D, bq, bk, kw = K1_CASES[case]
    q, k, v, do = _qkv(B, Sq, Skv, Hq, Hkv, D)
    kv_len = kw.get("kv_len", Skv)
    causal, window, softcap = kw["causal"], kw.get("window"), \
        kw.get("softcap")
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, visits, lse = fa.flash_attention_plain(tq, tk, tv, bq=bq, bk=bk,
                                                return_lse=True, **kw)
    dq, dk, dv, qvis, kvvis = fa.flash_attention_bwd_plain(
        tq, tk, tv, out, tdo, lse, bq=bq, bk=bk, **kw)

    q_pos = jnp.broadcast_to(jnp.arange(Sq), (B, Sq))
    kv_pos = jnp.broadcast_to(jnp.where(jnp.arange(Skv) < kv_len,
                                        jnp.arange(Skv), -1), (B, Skv))

    def bh(x):
        return jnp.transpose(x, (0, 2, 1, 3)).reshape(-1, x.shape[1], D)

    fns = [lambda a, b, c: jx["ja"].naive_attention(
        a, b, c, q_pos, kv_pos, causal=causal, window=window,
        softcap=softcap)]
    if kv_len == Skv:                  # flash_attention_ref has no kv_len
        fns.append(lambda a, b, c: jnp.transpose(
            jx["ref"].flash_attention_ref(
                bh(a), bh(b), bh(c), causal=causal, window=window,
                softcap=softcap).reshape(B, Hq, Sq, D), (0, 2, 1, 3)))
    refs = [jax.jit(lambda a, b, c, g, f=f: jax.vjp(f, a, b, c)[1](g))(
        q, k, v, do) for f in fns]
    for ref in refs:
        for got, w in zip((dq, dk, dv), ref):
            w = np.asarray(w)
            np.testing.assert_allclose(got.numpy(), w,
                                       atol=GRAD_TOL * np.abs(w).max())
    want_q = fa.live_block_counts(Sq, Skv, causal=causal, window=window,
                                  bq=bq, bk=bk, kv_len=kw.get("kv_len"))
    want_kv = fa.live_q_counts(Sq, Skv, causal=causal, window=window, bq=bq,
                               bk=bk, kv_len=kw.get("kv_len"))
    assert (qvis == torch.tensor(want_q, dtype=torch.int32)).all()
    assert (kvvis == torch.tensor(want_kv, dtype=torch.int32)).all()
    assert int(qvis[0].sum()) == int(kvvis[0].sum())


# The bf16 plain backward rounds its inputs, the forward's output, P and
# dS to bf16 (8 bits: 2^-9 relative a rounding) as the kernel does; a few
# such roundings feed each gradient, measured at 0.2-0.5% of the leaf's
# largest gradient.
BF16_GRAD_TOL = 1e-2


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_backward_plain_bf16_matches_jax_grad(jx, case):
    """bf16 inputs through the plain forward and backward (P and dS
    rounded to bf16 before their products, as the kernel rounds them)
    against JAX's fp32 ``vjp`` of ``naive_attention`` on the same
    bf16-rounded inputs, within BF16_GRAD_TOL of each leaf's largest
    gradient."""
    jax, jnp = jx["jax"], jx["jnp"]
    B, Sq, Skv, Hq, Hkv, D, bq, bk, kw = K1_CASES[case]
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in _qkv(B, Sq, Skv, Hq, Hkv, D))
    out, _, lse = fa.flash_attention_plain(tq, tk, tv, bq=bq, bk=bk,
                                           return_lse=True, **kw)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, out, tdo, lse, bq=bq,
                                       bk=bk, **kw)[:3]
    assert all(g.dtype == torch.bfloat16 for g in got)
    kv_len = kw.get("kv_len", Skv)
    q_pos = jnp.broadcast_to(jnp.arange(Sq), (B, Sq))
    kv_pos = jnp.broadcast_to(jnp.where(jnp.arange(Skv) < kv_len,
                                        jnp.arange(Skv), -1), (B, Skv))

    def f(a, b, c):
        return jx["ja"].naive_attention(
            a, b, c, q_pos, kv_pos, causal=kw["causal"],
            window=kw.get("window"), softcap=kw.get("softcap"))
    q, k, v, do = (_np(t) for t in (tq, tk, tv, tdo))
    ref = jax.jit(lambda a, b, c, g: jax.vjp(f, a, b, c)[1](g))(q, k, v, do)
    for g, w in zip(got, ref):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w,
                                   atol=BF16_GRAD_TOL * np.abs(w).max())


@pytest.mark.parametrize("shape,want", [
    ((14, 2), 7),                      # Qwen2-0.5B
    ((16, 1), 8),                      # the hybrid's local layers
    ((12, 12), 1),                     # GECToR-base, G = 1
    ((24, 2), 6),                      # G = 12: divisors up to 8
    ((32, 2), 8),                      # G = 16
    ((10, 1), 5),                      # G = 10
    ((11, 1), 1),                      # a prime group above 8
])
def test_bwd_cluster_plan(shape, want):
    """The bf16 dK/dV kernel's cluster: the largest divisor of the group
    up to BWD_MAX_CLUSTER; always 1 in fp32."""
    Hq, Hkv = shape
    c = fa.bwd_cluster(Hq, Hkv, torch.bfloat16)
    assert c == want
    G = Hq // Hkv
    assert G % c == 0 and 1 <= c <= fa.BWD_MAX_CLUSTER
    assert fa.bwd_cluster(Hq, Hkv, torch.float32) == 1


def test_k1_backward_through_mha_prefill_on_cpu(jx):
    """autograd through ``ops.mha_prefill`` (the Function: plain forward
    with lse, plain backward) against autograd of the port's
    ``naive_attention``."""
    from repro_torch.models.attention import naive_attention
    q, k, v, do = map(torch.from_numpy, _qkv(2, 36, 36, 14, 2, 64, seed=4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.mha_prefill(*leaves, causal=True, kv_len=36).backward(do)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    pos = torch.arange(36).expand(2, 36)
    naive_attention(*ref, pos, pos, causal=True).backward(do)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=0,
                                   atol=GRAD_TOL * float(b.grad.abs().max()))


# ----------------------------------------------------- K5 backward plain
def _scan_inputs(B, S, W, seed=0):
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.standard_normal((B, S, W))))) * 0.2 + 0.79
    b = rng.standard_normal((B, S, W)) * 0.1
    dh = rng.standard_normal((B, S, W))
    return [x.astype(np.float32) for x in (a, b, dh)]


@pytest.mark.parametrize("shape", [(1, 1, 8), (2, 37, 16), (3, 100, 24)])
def test_k5_backward_plain_matches_jax_grad(jx, shape):
    jax = jx["jax"]
    a, b, dh = _scan_inputs(*shape)
    wa, wb = (np.asarray(x) for x in jax.jit(
        lambda x, y, g: jax.vjp(jx["ref"].rglru_scan_ref, x, y)[1](g))(
            a, b, dh))
    ta, tb, tdh = map(torch.from_numpy, (a, b, dh))
    h = rs.rglru_scan_plain(ta, tb)
    da, db = rs.rglru_scan_bwd_plain(ta, h, tdh)
    np.testing.assert_allclose(db.numpy(), wb, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(da.numpy(), wa, atol=1e-5, rtol=1e-4)


def test_k5_backward_through_rglru_apply(jx, weights):
    """Gradients of the RG-LRU block (``lru_scan``'s Function on the CPU)
    against ``jax.grad`` of JAX's ``rglru_apply``, in x and every leaf."""
    jax, jnp = jx["jax"], jx["jnp"]
    jcfg, cfg = jx["cfgs"]["recurrentgemma-9b"], _cfg("recurrentgemma-9b")
    p_np = {k: v[0] for k, v in
            flatten(weights["recurrentgemma-9b"][1]["blocks"]["blk0"]
                    ["rglru"]).items()}
    from repro_torch.training.tree import unflatten
    p_np = unflatten(p_np)
    x = np.random.default_rng(6).standard_normal(
        (2, 30, cfg.d_model)).astype(np.float32)
    w = np.random.default_rng(7).standard_normal(
        (2, 30, cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jx["jr"].rglru_apply(jcfg, p, xx)[0] * w)
    wp, wx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p_np), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    (_, _), g = value_and_grad(
        lambda p: (torch.sum(tr.rglru_apply(cfg, p, tx)[0]
                             * torch.from_numpy(w)), {}),
        to_torch(p_np, device="cpu"))
    _close_tree(g, jax.tree.map(np.asarray, wp), rel=GRAD_TOL)
    gx = torch.autograd.grad(torch.sum(tr.rglru_apply(
        cfg, to_torch(p_np, device="cpu"), tx)[0] * torch.from_numpy(w)),
        tx)[0]
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx),
                               atol=GRAD_TOL * float(np.abs(wx).max()))


# ----------------------------------------------------------------- CLIs
def test_train_cli_writes_a_checkpoint_jax_reads(jx, tmp_path):
    from repro_torch.launch import train
    path = str(tmp_path / "lm.ckpt")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(["--device", "cpu", "--smoke", "--steps", "3",
                    "--batch", "2", "--seq", "16", "--ckpt", path])
    lines = buf.getvalue().splitlines()
    assert [ln.split()[:2] for ln in lines[:3]] == [
        ["step", "0"], ["step", "1"], ["step", "2"]]
    assert lines[-1] == f"checkpoint -> {path}"
    back = jx["jck"].restore(path)
    mine = ck.restore(path, device="cpu")
    assert sorted(back) == ["opt", "params"]
    assert int(back["opt"]["step"]) == 3
    _assert_bits_equal(mine, jx["jax"].tree.map(np.asarray, back))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gector-base"])
def test_serve_ckpt_serves_the_tree_held_in_memory(tmp_path, arch):
    """``serve --ckpt`` on a checkpoint of the tree ``serve`` draws from
    ``--seed`` prints what ``serve`` prints without it. GECToR's tree is
    saved whole (encoder and heads)."""
    from repro_torch.core.gector import init_gector
    from repro_torch.core.tags import TagVocab
    from repro_torch.launch import serve
    from repro_torch.models import init_params
    cfg = get_config(arch, smoke=True)
    tree = (init_params(cfg, 3, device="cpu") if arch == "qwen2-0.5b" else
            init_gector(cfg, TagVocab(64), 3, device="cpu"))
    path = str(tmp_path / "s.ckpt")
    ck.save(path, {"params": tree})
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
            "--max-new-tokens", "4", "--seed", "3"]
    outs = []
    for extra in ([], ["--ckpt", path]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main(args + extra)
        outs.append(buf.getvalue().splitlines())
    assert outs[0][0] == outs[1][0]
    assert outs[0][0].startswith("tokens of the first request:"
                                 if arch == "qwen2-0.5b" else
                                 "tags of the first request:")


# ------------------------------------------------------------- the card
@requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_cuda_k1_backward_matches_plain(case, dtype, tol):
    B, Sq, Skv, Hq, Hkv, D, _, _, kw = K1_CASES[case]
    q, k, v, do = (torch.from_numpy(x).cuda().to(dtype)
                   for x in _qkv(B, Sq, Skv, Hq, Hkv, D))
    bqs, bk = fa.TILES[(dtype, D)]
    for bq in bqs:
        out, lse = fa.flash_attention(q, k, v, bq=bq, return_lse=True, **kw)
        got = fa.flash_attention_bwd(q, k, v, out, do, lse, bq=bq, bk=bk,
                                     return_visits=True, **kw)
        torch.cuda.synchronize()
        # the plain forward's own out and lse: the two kernels together
        # against the two plain versions
        p_out, _, p_lse = fa.flash_attention_plain(
            q, k, v, bq=bq, bk=bk, return_lse=True, **kw)
        assert float((lse - p_lse).abs().max()) <= 1e-4
        want = fa.flash_attention_bwd_plain(
            q.float(), k.float(), v.float(), p_out.float(), do.float(),
            p_lse, bq=bq, bk=bk, **kw)
        for a, b in zip(got[:3], want[:3]):
            scale = float(b.abs().max())
            assert float((a.float() - b).abs().max()) <= tol * scale
        assert torch.equal(got[3].cpu(), want[3].cpu())
        assert torch.equal(got[4].cpu(), want[4].cpu())


@requires_cuda
@pytest.mark.parametrize("case", ["gqa_14_2", "window", "d256"])
def test_cuda_k1_backward_bits_across_calls_and_clusters(case):
    """The bf16 kernel at every cluster size that divides the group: two
    calls bit-equal, dQ the same bits at every size (its kernel has no
    cluster), dK and dV within bf16's 2e-2 of the plain version at each
    and within one bf16 rounding (2^-7 relative, plus 2^-16 of the
    largest value for the fp32 sums' order) of cluster 1's: only where the
    fp32 sum over the query heads is split differs."""
    B, Sq, Skv, Hq, Hkv, D, _, _, kw = K1_CASES[case]
    q, k, v, do = (torch.from_numpy(x).cuda().to(torch.bfloat16)
                   for x in _qkv(B, Sq, Skv, Hq, Hkv, D))
    bqs, bk = fa.TILES[(torch.bfloat16, D)]
    bq = bqs[0]
    out, lse = fa.flash_attention(q, k, v, bq=bq, return_lse=True, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, out, do, lse, bq=bq, bk=bk,
                                        **kw)
    G = Hq // Hkv
    first = None
    for c in [c for c in range(1, fa.BWD_MAX_CLUSTER + 1) if G % c == 0]:
        got = fa.flash_attention_bwd(q, k, v, out, do, lse, bq=bq, bk=bk,
                                     cluster=c, **kw)
        again = fa.flash_attention_bwd(q, k, v, out, do, lse, bq=bq, bk=bk,
                                       cluster=c, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        first = first or got
        assert torch.equal(got[0], first[0])
        for a, b in zip(got, want):
            scale = float(b.float().abs().max())
            assert float((a.float() - b.float()).abs().max()) <= 2e-2 * scale
        for a, b in zip(got[1:3], first[1:3]):
            scale = float(b.float().abs().max())
            assert torch.allclose(a.float(), b.float(), rtol=2 ** -7,
                                  atol=2 ** -16 * scale)


@requires_cuda
@pytest.mark.parametrize("shape", [(1, 1, 8), (2, 37, 16), (3, 100, 300)])
def test_cuda_k5_backward_matches_plain(shape):
    a, b, dh = (torch.from_numpy(x).cuda() for x in _scan_inputs(*shape))
    h = rs.rglru_scan(a, b)
    got = rs.rglru_scan_bwd(a, h, dh)
    want = rs.rglru_scan_bwd_plain(a, h, dh)
    for x, y in zip(got, want):
        assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max())


@requires_cuda
def test_cuda_autograd_runs_the_backward_kernels():
    q, k, v, do = (torch.from_numpy(x).cuda().to(torch.bfloat16)
                   for x in _qkv(2, 64, 64, 14, 2, 64))
    before = (fa.flash_attention.launches, fa.flash_attention_bwd.launches,
              rs.rglru_scan.launches, rs.rglru_scan_bwd.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.mha_prefill(*leaves, causal=True).backward(do)
    a, b, dh = (torch.from_numpy(x).cuda() for x in _scan_inputs(2, 16, 32))
    a.requires_grad_()
    b.requires_grad_()
    ops.lru_scan(a, b).backward(dh)
    torch.cuda.synchronize()
    after = (fa.flash_attention.launches, fa.flash_attention_bwd.launches,
             rs.rglru_scan.launches, rs.rglru_scan_bwd.launches)
    assert [y - x for x, y in zip(before, after)] == [1, 1, 1, 1]
    assert all(t.grad is not None for t in leaves + [a, b])
