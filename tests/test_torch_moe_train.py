"""Training of the MoE models in the port against the JAX package, on the
CPU.

The three MoE smoke configs in fp32, weights initialized in JAX and
bridged through numpy (QKV biases made non-zero). Held here, at
``test_torch_training``'s tolerances: ``loss_fn``'s total, ``nll``,
``load_balance`` and ``router_z`` (1e-5 relative) and the gradients of
every leaf, the router's included (1e-4 of the leaf's largest), against
JAX's ``value_and_grad`` (remat on and off the same bits); the dispatch's
two gathers, whose backwards gather too (``models/moe.py``), against
autograd of the plain ``torch.gather`` under a skewed router that drops
copies, bit for bit; a ``train_step`` with ``accum_steps=2`` against
JAX's (metrics 1e-4 relative, params within 1e-5 plus twice the
learning rate) and its metrics the mean of the two halves' ``loss_fn``;
a checkpoint of an MoE tree (bf16 weights, fp32 router and AdamW state)
byte-equal to JAX's ``save``; ``launch.train --arch qwen2-moe-a2.7b
--smoke --device cpu`` for 2 steps. JAX is imported in a fixture.
"""
import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.models import moe as moe_mod
from repro_torch.training import OptConfig, adamw_init, loss_fn, train_step
from repro_torch.training import checkpoint as ck
from repro_torch.training.optimizer import lr_schedule
from repro_torch.training.train_loop import value_and_grad
from repro_torch.training.tree import flatten

NAMES = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b")
IDS = ["qwen2-moe", "moonshot", "phi35-moe"]
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5


def _cfg(name, dtype="float32"):
    return dataclasses.replace(get_config(name, smoke=True), dtype=dtype)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models import transformer as jt
    from repro.training import checkpoint as jck
    from repro.training import optimizer as jopt
    from repro.training import train_loop as jtl
    return dict(jax=jax, jnp=jnp, jt=jt, jck=jck, jopt=jopt, jtl=jtl,
                get_config=jax_get_config, models={})


def _model(jx, name, dtype="float32"):
    """(jax cfg, jax tree, numpy tree) from JAX's init at key 0, QKV biases
    non-zero; made once a model."""
    key = (name, dtype)
    if key not in jx["models"]:
        jax = jx["jax"]
        jcfg = dataclasses.replace(jx["get_config"](name, smoke=True),
                                   dtype=dtype)
        tree = jax.tree.map(np.array, jax.jit(
            jx["jt"].init_params, static_argnums=0)(
                jcfg, jax.random.PRNGKey(0)))
        rng = np.random.default_rng(1)
        for path, leaf in flatten(tree).items():
            if path.split("/")[-1] in ("bq", "bk", "bv", "bqkv"):
                leaf[...] = 0.1 * rng.standard_normal(leaf.shape)
        jx["models"][key] = (jcfg, jax.tree.map(jx["jnp"].asarray, tree),
                             tree)
    return jx["models"][key]


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, S + 1)).astype(np.int32)


def _np(t):
    return t.detach().float().numpy()


def _close_tree(got, want, *, rel):
    g, w = flatten(got), flatten(want)
    assert sorted(g) == sorted(w)
    for k in g:
        a, b = _np(g[k]), np.asarray(w[k], np.float32)
        scale = max(float(np.abs(b).max()), 1e-12)
        err = float(np.abs(a - b).max())
        assert err <= rel * scale, (k, err, scale)


# --------------------------------------------------- loss and gradients
@pytest.mark.parametrize("name", NAMES, ids=IDS)
def test_loss_and_gradients_match_jax(jx, name):
    """``loss_fn`` on (2, 33) tokens: the total and each metric within
    1e-5 of JAX's, every leaf's gradient (the routers' too, which the
    gates and the aux terms reach) within 1e-4 of the leaf's largest;
    remat changes no bit."""
    jax, jnp = jx["jax"], jx["jnp"]
    jcfg, jp, tree = _model(jx, name)
    cfg = _cfg(name)
    toks = _tokens(cfg, 2, 32, seed=3)
    (want, wm), wg = jax.jit(jax.value_and_grad(
        lambda p, t: jx["jtl"].loss_fn(jcfg, p, {"tokens": t}),
        has_aux=True))(jp, jnp.asarray(toks))
    tp = to_torch(tree, device="cpu")
    batch = {"tokens": torch.from_numpy(toks)}
    grads = {}
    for remat in (True, False):
        (got, gm), grads[remat] = value_and_grad(
            lambda p: loss_fn(cfg, p, batch, remat=remat), tp)
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)
        assert sorted(gm) == sorted(wm)
        for k in gm:
            np.testing.assert_allclose(float(gm[k]), float(wm[k]),
                                       rtol=LOSS_TOL, err_msg=k)
    assert float(gm["load_balance"]) > 0 and float(gm["router_z"]) > 0
    _close_tree(grads[True], jax.tree.map(np.asarray, wg), rel=GRAD_TOL)
    flat = flatten(grads[True])
    for k, v in flat.items():
        assert torch.equal(v, flatten(grads[False])[k]), k
    routers = [k for k in flat if k.endswith("/moe/router")]
    assert routers and all(float(flat[k].abs().max()) > 0 for k in routers)


def _plain_gather(cfg, x, src, filled):
    """The dispatch buffer by ``torch.gather``, as the serving path computed
    it before its backward was written (the reference)."""
    B, E, C = src.shape
    d = x.shape[-1]
    tok = (src // cfg.moe.top_k).reshape(B, E * C, 1).expand(B, E * C, d)
    buf = torch.where(filled.reshape(B, E * C, 1), torch.gather(x, 1, tok),
                      0)
    return buf.reshape(B, E, C, d).transpose(0, 1).reshape(E, B * C, d)


def _plain_combine(y, ids, gate, slot, kept):
    B, S, K = ids.shape
    E, d = y.shape[0], y.shape[-1]
    y = y.reshape(E, B, -1, d).transpose(0, 1).reshape(B, -1, d)
    got = torch.gather(y, 1, slot[..., None].expand(B, S * K, d))
    w = torch.where(kept, gate.reshape(B, S * K), 0)
    contrib = torch.where(kept[..., None], got.float() * w[..., None], 0)
    by_id = torch.argsort(ids, dim=-1)[..., None].expand(B, S, K, d)
    contrib = torch.gather(contrib.reshape(B, S, K, d), 2, by_id)
    acc = contrib[:, :, 0]
    for k in range(1, K):
        acc = acc + contrib[:, :, k]
    return acc


@pytest.mark.parametrize("name", NAMES, ids=IDS)
def test_dispatch_gathers_backward_match_plain_gather(jx, name):
    """Under a router pulled towards expert 0 (copies dropped): the
    dispatch buffer, the combined output and the gradients of x, of the
    expert outputs and of the gates equal autograd of the plain
    ``torch.gather`` formulation by ``torch.equal`` (fp32 on the CPU,
    where the plain backward adds a token's slots in ascending expert id
    too)."""
    _, _, tree = _model(jx, name)
    cfg = _cfg(name)
    p = {k: v[0] for k, v in to_torch(tree["blocks"]["blk0"]["moe"],
                                      device="cpu").items()
         if not isinstance(v, dict)}
    p["router"] = p["router"].clone()
    p["router"][:, 0] += 0.02
    rng = np.random.default_rng(6)
    x = torch.from_numpy(np.abs(rng.standard_normal(
        (2, 24, cfg.d_model))).astype(np.float32))
    C = moe_mod.capacity(cfg, 24)
    _, _, ids, gate = moe_mod.route(cfg, p, x)
    disp = moe_mod.dispatch(cfg, ids, C)
    src, filled, slot, kept = disp
    assert (~kept).any()
    E = cfg.moe.num_experts
    y = torch.from_numpy(rng.standard_normal(
        (E, 2 * C, cfg.d_model)).astype(np.float32))
    g_buf = torch.from_numpy(rng.standard_normal(y.shape).astype(
        np.float32))
    g_out = torch.from_numpy(rng.standard_normal(x.shape).astype(
        np.float32))
    res = {}
    for path in ("custom", "plain"):
        xs, ys, gs = (t.clone().requires_grad_() for t in (x, y, gate))
        if path == "custom":
            buf = moe_mod.gather(cfg, xs, ids, disp)
            out = moe_mod.combine(ys, ids, gs, disp, torch.float32)
        else:
            buf = _plain_gather(cfg, xs, src, filled)
            out = _plain_combine(ys, ids, gs, slot, kept)
        loss = (buf * g_buf).sum() + (out * g_out).sum()
        res[path] = (buf, out, *torch.autograd.grad(loss, (xs, ys, gs)))
    for what, a, b in zip(("buf", "out", "dx", "dy", "dgate"),
                          res["custom"], res["plain"]):
        assert torch.equal(a, b), what
    assert res["custom"][2].abs().max() > 0


# ------------------------------------------------------------ the step
def test_accum_steps_match_jax_and_average_the_halves(jx):
    """``train_step`` with ``accum_steps=2`` on qwen2-moe against JAX's:
    the metrics within 1e-4 (relative), the params within 1e-5 plus twice
    the learning rate; its metrics the mean of ``loss_fn`` on the two
    halves of the batch, as JAX's scan forms them."""
    jax, jnp = jx["jax"], jx["jnp"]
    name = "qwen2-moe-a2.7b"
    jcfg, jp, tree = _model(jx, name)
    cfg = _cfg(name)
    oc = OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    toks = _tokens(cfg, 4, 24, seed=5)
    jp2, _, jm = jax.jit(lambda p, o, t: jx["jtl"].train_step(
        jcfg, oc, p, o, {"tokens": t}, accum_steps=2))(
            jp, jx["jopt"].adamw_init(jp), jnp.asarray(toks))
    tp = to_torch(tree, device="cpu")
    batch = {"tokens": torch.from_numpy(toks)}
    tp2, _, tm = train_step(cfg, oc, tp, adamw_init(tp), batch,
                            accum_steps=2)
    assert sorted(tm) == sorted(jm)
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    atol = 1e-5 + 2 * float(lr_schedule(oc, 1))
    for k, v in flatten(tp2).items():
        np.testing.assert_allclose(_np(v), np.asarray(flatten(jp2)[k]),
                                   atol=atol, rtol=0, err_msg=k)
    halves = [loss_fn(cfg, tp, {"tokens": batch["tokens"][i:i + 2]})[1]
              for i in (0, 2)]
    for k, v in halves[0].items():
        np.testing.assert_allclose(float(tm[k]),
                                   (float(v) + float(halves[1][k])) / 2,
                                   rtol=1e-6, err_msg=k)


def test_checkpoint_of_an_moe_tree_is_byte_equal_to_jax(jx, tmp_path):
    """qwen2-moe's smoke tree in its own dtypes (bf16 weights, an fp32
    router) with its AdamW state: the port's ``save`` writes JAX's bytes,
    and each package restores the other's file bit for bit."""
    jax = jx["jax"]
    _, jp, tree = _model(jx, "qwen2-moe-a2.7b", dtype="bfloat16")
    tp = to_torch(tree, device="cpu")
    assert tp["blocks"]["blk0"]["moe"]["router"].dtype == torch.float32
    assert tp["blocks"]["blk0"]["moe"]["experts"]["w_in"].dtype == \
        torch.bfloat16
    jpath, tpath = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jx["jck"].save(jpath, {"params": jp, "opt": jx["jopt"].adamw_init(jp)})
    ck.save(tpath, {"params": tp, "opt": adamw_init(tp)})
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    back = ck.restore(jpath, device="cpu")["params"]
    for k, v in flatten(back).items():
        assert v.dtype == flatten(tp)[k].dtype and torch.equal(
            v, flatten(tp)[k]), k


def test_train_cli_trains_an_moe_model():
    """``launch.train --arch qwen2-moe-a2.7b --smoke --device cpu``: two
    steps, JAX's step lines, finite losses."""
    from repro_torch.launch import train
    assert "qwen2-moe-a2.7b" in train.ARCHS
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(["--arch", "qwen2-moe-a2.7b", "--smoke", "--device",
                    "cpu", "--steps", "2", "--batch", "2", "--seq", "16"])
    lines = buf.getvalue().splitlines()
    assert [ln.split()[:2] for ln in lines] == [["step", "0"], ["step", "1"]]
    assert all(np.isfinite(float(ln.split()[3])) for ln in lines)
