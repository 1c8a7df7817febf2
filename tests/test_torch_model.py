"""The PyTorch port's GECToR against the JAX package on the same weights.

Weights are initialized in JAX (smoke config, dtype replaced with fp32)
and bridged through numpy; inputs are made with numpy from a seed. Logits
must agree within atol 1e-4 (fp32, sums in another order); tags and
corrections must be identical. The layers are checked one by one too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import gector as jg
from repro.core.tags import TagVocab as JaxTagVocab
from repro.models import forward as jax_forward
from repro.models import layers as jl
from repro.models import init_params as jax_init_params
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.core import gector as tg
from repro_torch.core.tags import TagVocab
from repro_torch.models import forward, init_params
from repro_torch.models import layers as tl

ATOL = 1e-4
JCFG = dataclasses.replace(jax_get_config("gector-base", smoke=True),
                           dtype="float32")
CFG = dataclasses.replace(get_config("gector-base", smoke=True),
                          dtype="float32")


@pytest.fixture(scope="module")
def weights():
    jp = jg.init_gector(JCFG, jax.random.PRNGKey(0), JaxTagVocab(64))
    tp = to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (B, S))


@pytest.mark.parametrize("plain_attention", [False, True])
def test_gector_forward_matches_jax(weights, plain_attention):
    jp, tp = weights
    toks = _tokens(3, 40)
    jt, jd = jg.gector_forward(JCFG, jp, jnp.asarray(toks))
    tt, td = tg.gector_forward(CFG, tp, torch.from_numpy(toks),
                               plain_attention=plain_attention)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=ATOL, rtol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL, rtol=0)


def test_causal_lm_logits_match_jax(weights):
    jp, tp = weights
    toks = _tokens(2, 33, seed=1)
    jlog, _, _ = jax_forward(JCFG, jp["encoder"], tokens=jnp.asarray(toks),
                             causal=True)
    tlog = forward(CFG, tp["encoder"], tokens=torch.from_numpy(toks),
                   causal=True)
    real = CFG.vocab_size             # padded vocab ids hold float32 min
    np.testing.assert_allclose(tlog.numpy()[..., :real],
                               np.asarray(jlog)[..., :real], atol=ATOL,
                               rtol=0)
    assert (tlog.numpy()[..., real:] == np.asarray(jlog)[..., real:]).all()


@pytest.mark.parametrize("min_error_prob", [0.0, 0.6])
def test_predict_tags_identical(weights, min_error_prob):
    jp, tp = weights
    toks = _tokens(4, 24, seed=2)
    mask = np.ones_like(toks, bool)
    mask[1, 15:] = False
    mask[3, 5:] = False
    want = jg.predict_tags(JCFG, jp, toks, mask,
                           min_error_prob=min_error_prob)
    got = tg.predict_tags(CFG, tp, toks, mask, min_error_prob=min_error_prob)
    np.testing.assert_array_equal(got, want)


def test_iterative_correct_identical(weights):
    jp, tp = weights
    rng = np.random.default_rng(3)
    sents = [rng.integers(0, CFG.vocab_size, int(rng.integers(5, 20)))
             for _ in range(6)]
    want = jg.iterative_correct(JCFG, jp, JaxTagVocab(64), sents,
                                max_iters=3)
    got = tg.iterative_correct(CFG, tp, TagVocab(64), sents, max_iters=3)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_layernorm_matches_jax():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 5, CFG.d_model)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(CFG.d_model).astype(np.float32)
    bias = rng.standard_normal(CFG.d_model).astype(np.float32)
    want = jl.apply_norm(JCFG, {"scale": jnp.asarray(scale),
                                "bias": jnp.asarray(bias)}, jnp.asarray(x))
    got = tl.apply_norm(CFG, {"scale": torch.from_numpy(scale),
                              "bias": torch.from_numpy(bias)},
                        torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    want = jax.nn.gelu(jnp.asarray(x))           # approximate=True default
    got = tl.act_fn("gelu")(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert (exact - got).abs().max() > 1e-4      # not torch's erf default


def test_embedding_plus_position_matches_jax(weights):
    jp, tp = weights
    toks = _tokens(2, 17, seed=5)
    pos = np.tile(np.arange(17) + 120, (2, 1))     # wraps % table length
    emb = jl.embed_apply(JCFG, jp["encoder"]["embed"], jnp.asarray(toks))
    tbl = jp["encoder"]["pos_embed"]["table"]
    want = emb + tbl[jnp.asarray(pos) % tbl.shape[0]]
    got = tl.embed_apply(CFG, tp["encoder"]["embed"], torch.from_numpy(toks))
    ttbl = tp["encoder"]["pos_embed"]["table"]
    got = got + ttbl[torch.from_numpy(pos) % ttbl.shape[0]]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bridge_keeps_bf16_bits():
    x = jax.random.normal(jax.random.PRNGKey(6), (3, 4), jnp.bfloat16)
    t = to_torch({"w": np.asarray(x)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))


def _layout(tree):
    """{path: (shape, dtype name)} of a nested-dict parameter tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{p}": x for p, x in _layout(v).items()})
        else:
            out[k] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


def test_init_params_has_the_jax_layout():
    """Same leaves, shapes and dtypes as the JAX package's init, so JAX
    weights bridge with no transpose."""
    cfg = get_config("gector-base", smoke=True)
    p = init_params(cfg, 0, device="cpu")
    jp = jax_init_params(jax_get_config("gector-base", smoke=True),
                         jax.random.PRNGKey(0))
    assert _layout(p) == _layout(jax.tree.map(np.asarray, jp))
    w = p["blocks"]["blk0"]["mlp"]["w_up"].float()
    bound = 2 / cfg.d_model ** 0.5               # truncated at 2 sigma
    assert w.abs().max() <= bound * 1.01
    assert abs(w.std().item() * cfg.d_model ** 0.5 - 0.88) < 0.02
    again = init_params(cfg, 0, device="cpu")
    assert torch.equal(again["blocks"]["blk0"]["mlp"]["w_up"],
                       p["blocks"]["blk0"]["mlp"]["w_up"])


def test_unported_paths_raise(weights):
    _, tp = weights
    with pytest.raises(KeyError, match="not yet ported"):
        get_config("whisper-large-v3")
    with pytest.raises(ValueError, match="needs caches and positions"):
        forward(CFG, tp["encoder"], tokens=torch.zeros(1, 4, dtype=torch.long),
                mode="chunk")


@pytest.mark.skipif("torch.cuda.is_available()",
                    reason="a card is present: there is nothing to refuse")
def test_asking_for_the_card_without_cuda_raises():
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(CFG, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tg.init_gector(CFG, TagVocab(8))
