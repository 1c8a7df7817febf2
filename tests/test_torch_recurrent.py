"""The port's RecurrentGemma path (RG-LRU blocks, local attention, K5) and
K1/K2 at head dim 256 against the JAX package, on the CPU.

Inputs are made with numpy from fixed seeds; model weights are initialized
in JAX and bridged through numpy. The configs are the RecurrentGemma smoke
config in fp32 (one period of ``("rglru", "rglru", "attn_local")``) and a
two-period variant (``n_layers=6``), which pins the layer order: JAX runs
each pattern position over all its periods before the next position.
Tolerances, stated per test: the scan atol 1e-5 / rtol 1e-4 (the plain
version runs the recurrence step by step, JAX's oracle as an associative
scan: another order of the sums); block outputs and states atol 1e-5,
logits atol 1e-4; tokens and finish reasons identical. The cases marked
``requires_cuda`` launch the CUDA kernels and skip on a host without a
card; they need no JAX, which is imported in a fixture.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain,
                                                  decode_splits)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain
from repro_torch.models import (decode_segment, forward, init_params,
                                make_caches, sample_logits)
from repro_torch.models import rglru as tr
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.api import SamplingParams

requires_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                   reason="needs an NVIDIA GPU with CUDA")
ATOL_SCAN, RTOL_SCAN = 1e-5, 1e-4
ATOL_BLOCK = 1e-5
ATOL = 1e-4
SMOKE = dataclasses.replace(get_config("recurrentgemma-9b", smoke=True),
                            dtype="float32")
CONFIGS = {"smoke": SMOKE,
           "two_periods": dataclasses.replace(SMOKE, n_layers=6)}
SCAN_SHAPES = [(1, 64, 128), (2, 300, 128), (3, 100, 256)]
DECODER = dict(mode="decoder", continuous=False, use_cache_pool=False,
               pad_buckets=(16, 32), max_new_tokens=4, max_batch=8)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.kernels import decode_attention as jda
    from repro.kernels import flash_attention as jfa
    from repro.kernels import ops as jops
    from repro.kernels import ref
    from repro.models import rglru as jr
    from repro.models import transformer as jt
    from repro.serving import EngineConfig as JaxEngineConfig
    from repro.serving import ServingEngine as JaxServingEngine
    from repro.serving.api import SamplingParams as JaxSamplingParams
    base = dataclasses.replace(jax_get_config("recurrentgemma-9b",
                                              smoke=True), dtype="float32")
    cfgs = {"smoke": base,
            "two_periods": dataclasses.replace(base, n_layers=6)}
    return dict(jax=jax, jnp=jnp, jda=jda, jfa=jfa, jops=jops, ref=ref,
                jr=jr, jt=jt, cfgs=cfgs, Engine=JaxServingEngine,
                EngineConfig=JaxEngineConfig, Sampling=JaxSamplingParams)


@pytest.fixture(scope="module")
def weights(jx):
    """{config name: (jax tree, torch tree)}, JAX-initialized from key 0;
    the zero-initialized gate and conv biases made non-zero, so their
    paths are exercised."""
    jax, jnp = jx["jax"], jx["jnp"]
    out = {}
    for name, jcfg in jx["cfgs"].items():
        jp = jax.tree.map(np.asarray, jx["jt"].init_params(
            jcfg, jax.random.PRNGKey(0)))
        rng = np.random.default_rng(1)
        for blk in jp["blocks"].values():
            if "rglru" in blk:
                r = blk["rglru"]
                for leaf in (r["gate_x"], r["gate_a"]):
                    leaf["b"] = (0.2 * rng.standard_normal(leaf["b"].shape)
                                 ).astype(np.float32)
                r["conv_b"] = (0.1 * rng.standard_normal(r["conv_b"].shape)
                               ).astype(np.float32)
        out[name] = (jax.tree.map(jnp.asarray, jp),
                     to_torch(jp, device="cpu"))
    return out


def _one_layer(tree, i=0):
    return {k: (_one_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _scan_inputs(B, S, W, seed=0):
    """a in (0.79, 0.99) and b of scale 0.1, as tests/test_kernels.py
    draws them, from numpy."""
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.standard_normal((B, S, W))))) * 0.2 + 0.79
    b = rng.standard_normal((B, S, W)) * 0.1
    return a.astype(np.float32), b.astype(np.float32)


def _prompts(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


# ------------------------------------------------------------------- K5
@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_scan_plain_matches_pallas_kernel_and_reference(jx, shape):
    a, b = _scan_inputs(*shape)
    got = ops.lru_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ja, jb = jx["jnp"].asarray(a), jx["jnp"].asarray(b)
    pallas = jx["jops"].lru_scan(ja, jb, bs=64)      # interpret on the CPU
    oracle = jx["ref"].rglru_scan_ref(ja, jb)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL_SCAN,
                                   rtol=RTOL_SCAN)


def test_scan_cpu_wrapper_runs_plain_version_without_launching():
    a, b = (torch.from_numpy(x) for x in _scan_inputs(2, 37, 130, seed=3))
    before = rglru_scan.launches
    out = rglru_scan(a, b)
    assert torch.equal(out, rglru_scan_plain(a, b))
    # lru_scan casts to fp32, as the TPU wrapper does
    assert ops.lru_scan(a.double(), b.double()).dtype == torch.float32
    assert torch.equal(ops.lru_scan(a, b, plain=True), out)
    assert rglru_scan.launches == before
    # the identity step (a = 1, b = 0) from h = 0 stays exactly 0
    zero = rglru_scan(torch.ones(1, 5, 8), torch.zeros(1, 5, 8))
    assert not zero.any()


def test_scan_bad_inputs_raise():
    a, b = (torch.from_numpy(x) for x in _scan_inputs(1, 4, 8))
    with pytest.raises(ValueError, match="shape"):
        rglru_scan(a, b[:, :3])
    with pytest.raises(TypeError, match="float32"):
        rglru_scan(a.double(), b.double())


# -------------------------------------------------------- RG-LRU block
def _rglru_layer(weights, name="smoke", j=0):
    jp, tp = weights[name]
    return (_one_layer(jp["blocks"][f"blk{j}"]["rglru"]),
            _one_layer(tp["blocks"][f"blk{j}"]["rglru"]))


def _state(B, W, seed):
    rng = np.random.default_rng(seed)
    return {"h": (0.5 * rng.standard_normal((B, W))).astype(np.float32),
            "conv": rng.standard_normal((B, 3, W)).astype(np.float32)}


def test_causal_conv4_with_a_conv_state_matches_jax(jx, weights):
    jlayer, tlayer = _rglru_layer(weights)
    W = SMOKE.d_model
    rng = np.random.default_rng(4)
    for S in (1, 2, 9):
        x = rng.standard_normal((2, S, W)).astype(np.float32)
        st = _state(2, W, seed=S)["conv"]
        jout, jst = jx["jr"]._causal_conv4(jlayer, jx["jnp"].asarray(x),
                                           jx["jnp"].asarray(st))
        tout, tst = tr._causal_conv4(tlayer, torch.from_numpy(x),
                                     torch.from_numpy(st))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   atol=ATOL_BLOCK, rtol=0)
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


@pytest.mark.parametrize("carried", [False, True])
def test_rglru_apply_matches_jax(jx, weights, carried):
    """Over a sequence, from a zero state (None) or a carried one; the
    carried state is overwritten in place with the state after the last
    position."""
    jlayer, tlayer = _rglru_layer(weights, j=1)
    B, S, W = 3, 21, SMOKE.d_model
    x = np.random.default_rng(5).standard_normal((B, S, W)).astype(
        np.float32)
    st = _state(B, W, seed=6) if carried else None
    jout, jst = jx["jr"].rglru_apply(
        jx["cfgs"]["smoke"], jlayer, jx["jnp"].asarray(x),
        state=None if st is None else {k: jx["jnp"].asarray(v)
                                       for k, v in st.items()})
    tst = None if st is None else {k: torch.from_numpy(v.copy())
                                   for k, v in st.items()}
    tout, ret = tr.rglru_apply(SMOKE, tlayer, torch.from_numpy(x), tst)
    assert ret is tst
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL_BLOCK,
                               rtol=0)
    if carried:
        for key in ("h", "conv"):
            np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                       atol=ATOL_BLOCK, rtol=0)


def test_rglru_step_matches_jax(jx, weights):
    jlayer, tlayer = _rglru_layer(weights)
    B, W = 4, SMOKE.d_model
    st = _state(B, W, seed=7)
    x = np.random.default_rng(8).standard_normal((B, 1, W)).astype(
        np.float32)
    jout, jst = jx["jr"].rglru_step(
        jx["cfgs"]["smoke"], jlayer, jx["jnp"].asarray(x),
        {k: jx["jnp"].asarray(v) for k, v in st.items()})
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    tout, _ = tr.rglru_step(SMOKE, tlayer, torch.from_numpy(x), tst)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL_BLOCK,
                               rtol=0)
    for key in ("h", "conv"):
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                   atol=ATOL_BLOCK, rtol=0)


def test_rglru_apply_then_steps_equal_one_longer_apply(weights):
    """The recurrence carries: a prefill of 12 then 5 single steps gives
    the outputs and state of one pass over all 17 positions."""
    _, tlayer = _rglru_layer(weights)
    B, S, W = 2, 17, SMOKE.d_model
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (B, S, W)).astype(np.float32))
    full_state = tr.rglru_state(SMOKE, B, device="cpu")
    full, _ = tr.rglru_apply(SMOKE, tlayer, x, full_state)
    state = tr.rglru_state(SMOKE, B, device="cpu")
    outs = [tr.rglru_apply(SMOKE, tlayer, x[:, :12], state)[0]]
    for t in range(12, S):
        outs.append(tr.rglru_step(SMOKE, tlayer, x[:, t:t + 1], state)[0])
    torch.testing.assert_close(torch.cat(outs, 1), full, atol=ATOL_BLOCK,
                               rtol=0)
    for key in ("h", "conv"):
        torch.testing.assert_close(state[key], full_state[key],
                                   atol=ATOL_BLOCK, rtol=0)


# ---------------------------------------------------------- the model
def _jax_prefill(jx, name, jp, toks, max_len):
    jnp, jt = jx["jnp"], jx["jt"]
    jcfg = jx["cfgs"][name]
    caches = jt.make_caches(jcfg, toks.shape[0], max_len, dtype=jnp.float32)
    logits, caches, _ = jt.forward(jcfg, jp, tokens=jnp.asarray(toks),
                                   caches=caches, mode="full")
    return logits, caches


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_logits_match_jax(jx, weights, name):
    """Full-sequence logits, with and without caches to fill (1e-4). The
    two-period config tells JAX's layer order from the interleaved one."""
    jp, tp = weights[name]
    cfg = CONFIGS[name]
    toks = _prompts(2, 24, cfg.vocab_size, seed=10)
    want, _ = _jax_prefill(jx, name, jp, toks, 40)
    tt = torch.from_numpy(toks)
    got = forward(cfg, tp, tokens=tt)
    caches = make_caches(cfg, 2, 40, dtype=torch.float32, device="cpu")
    filled = forward(cfg, tp, tokens=tt, caches=caches)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert torch.equal(got, filled)


def test_two_periods_run_in_jax_order_not_interleaved(weights):
    """The two-period stack as one period of six positions: in JAX's order
    (blk0 p0, blk0 p1, blk1 p0, ...) it gives the same logits, bit for
    bit; in Griffin's interleaved order (blk0 p0, blk1 p0, blk2 p0, blk0
    p1, ...) other ones, so the test above would see a swap."""
    _, tp = weights["two_periods"]
    cfg = CONFIGS["two_periods"]
    toks = torch.from_numpy(_prompts(1, 12, cfg.vocab_size, seed=11))
    got = forward(cfg, tp, tokens=toks)

    def one_period(order):
        """(j, i) pairs -> a config and tree of one period, six blocks."""
        kinds = tuple(cfg.pattern[j] for j, _ in order)
        tree = {k: v for k, v in tp.items() if k != "blocks"}
        tree["blocks"] = {
            f"blk{n}": _one_layer(tp["blocks"][f"blk{j}"], slice(i, i + 1))
            for n, (j, i) in enumerate(order)}
        return dataclasses.replace(cfg, pattern=kinds), tree

    jax_order = [(j, i) for j in range(3) for i in range(2)]
    interleaved = [(j, i) for i in range(2) for j in range(3)]
    assert torch.equal(forward(*one_period(jax_order), tokens=toks), got)
    other = forward(*one_period(interleaved), tokens=toks)
    assert (other - got).abs().max().item() > 1e-2


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ["gector-base", "qwen2-0.5b",
                                  "recurrentgemma-9b"])
def test_embed_scale_is_set_as_the_reference_name_rule_sets_it(arch, smoke):
    """The port reads the sqrt(d_model) embedding scale from
    ``cfg.embed_scale``; JAX scales names starting "gemma" or "recurrent".
    Every registered config sets the field as that rule would."""
    cfg = get_config(arch, smoke=smoke)
    assert cfg.embed_scale == cfg.name.startswith(("gemma", "recurrent"))


def test_embed_scale_follows_the_field_not_the_name(weights):
    """A renamed config keeps its scale bit for bit; the field turned off
    drops it."""
    _, tp = weights["smoke"]
    toks = torch.from_numpy(_prompts(2, 8, SMOKE.vocab_size, seed=12))
    want = forward(SMOKE, tp, tokens=toks)
    renamed = dataclasses.replace(SMOKE, name="hybrid-variant")
    assert torch.equal(forward(renamed, tp, tokens=toks), want)
    unscaled = dataclasses.replace(SMOKE, embed_scale=False)
    assert (forward(unscaled, tp, tokens=toks) - want).abs().max().item() \
        > 1e-2


def _caches_to_np(caches):
    return {j: {k: np.asarray(v) for k, v in c.items()}
            for j, c in caches.items()}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_steps_match_jax_past_the_window(jx, weights, name):
    """A prefill of 40, then 30 teacher-forced decode steps: the local
    layers' rings (64 slots, window 64) wrap at position 64. Logits of
    every step within 1e-4, and every cache and state at the end."""
    jax, jnp, jt = jx["jax"], jx["jnp"], jx["jt"]
    jp, tp = weights[name]
    cfg, jcfg = CONFIGS[name], jx["cfgs"][name]
    B, S, n, max_len = 2, 40, 30, 80
    toks = _prompts(B, S, cfg.vocab_size, seed=12)
    steps = _prompts(B, n, cfg.vocab_size, seed=13)
    _, jc = _jax_prefill(jx, name, jp, toks, max_len)
    tc = make_caches(cfg, B, max_len, dtype=torch.float32, device="cpu")
    assert tc["blk2"]["k"].shape[2] == cfg.attn.window      # the ring
    forward(cfg, tp, tokens=torch.from_numpy(toks), caches=tc)
    jstep = jax.jit(lambda p, t, pos, c: jt.decode_step(jcfg, p, t, pos,
                                                        c)[:2])
    for t in range(n):
        pos = np.full((B, 1), S + t, np.int32)
        tok = steps[:, t:t + 1]
        jl, jc = jstep(jp, jnp.asarray(tok), jnp.asarray(pos), jc)
        tl_ = forward(cfg, tp, tokens=torch.from_numpy(tok),
                      positions=torch.from_numpy(pos), caches=tc,
                      mode="decode")
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
    want = _caches_to_np(jc)
    for j, c in tc.items():
        for key, t_ in c.items():
            np.testing.assert_allclose(t_.numpy(), want[j][key], atol=1e-5,
                                       rtol=0, err_msg=f"{j}/{key}")


def test_greedy_tokens_match_jax(jx, weights):
    """Prefill, then ``decode_segment`` greedy for 12 tokens against JAX's
    ``decode_segment`` on the same caches: identical tokens."""
    jnp, jt = jx["jnp"], jx["jt"]
    name = "two_periods"
    jp, tp = weights[name]
    cfg, jcfg = CONFIGS[name], jx["cfgs"][name]
    B, S, n = 3, 14, 12
    toks = _prompts(B, S, cfg.vocab_size, seed=14)
    jl, jc = _jax_prefill(jx, name, jp, toks, S + n + 1)
    jfirst = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    pos = np.full((B, 1), S, np.int32)
    jtoks, _, _, _ = jt.decode_segment(jcfg, jp, jfirst, jnp.asarray(pos),
                                       jc, n_steps=n)
    tc = make_caches(cfg, B, S + n + 1, dtype=torch.float32, device="cpu")
    logits = forward(cfg, tp, tokens=torch.from_numpy(toks), caches=tc)
    first = sample_logits(logits[:, -1])[:, None]
    np.testing.assert_array_equal(first.numpy(), np.asarray(jfirst))
    got, _, _, _ = decode_segment(cfg, tp, first, torch.from_numpy(pos), tc,
                                  n_steps=n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtoks))


def test_prefill_state_runs_over_the_pad_tokens_as_in_jax(jx, weights):
    """Batch-at-a-time serving right-pads prompts to the bucket. The row of
    10 tokens padded to 16 leaves prefill with the recurrent state of the
    padded sequence, as JAX's rglru_apply (h[:, -1], xp[:, -3:]) does, and
    not the state of its 10 tokens alone."""
    name = "smoke"
    jp, tp = weights[name]
    cfg = CONFIGS[name]
    toks = _prompts(2, 16, cfg.vocab_size, seed=15)
    toks[0, 10:] = 0                                  # row 0: 10 + 6 pads
    _, jc = _jax_prefill(jx, name, jp, toks, 20)
    _, jexact = _jax_prefill(jx, name, jp, toks[:1, :10], 20)
    tc = make_caches(cfg, 2, 20, dtype=torch.float32, device="cpu")
    forward(cfg, tp, tokens=torch.from_numpy(toks), caches=tc)
    for j in ("blk0", "blk1"):
        for key in ("h", "conv"):
            got = tc[j][key][:, 0].numpy()
            np.testing.assert_allclose(got, np.asarray(jc[j][key])[:, 0],
                                       atol=1e-5, rtol=0)
            exact = np.asarray(jexact[j][key])[:, 0]
            assert np.abs(got - exact).max() > 1e-3, (j, key)
    # so the next step's logits of that row differ from its exact run's
    te = make_caches(cfg, 1, 20, dtype=torch.float32, device="cpu")
    forward(cfg, tp, tokens=torch.from_numpy(toks[:1, :10]), caches=te)
    nxt = torch.tensor([[7], [7]])
    padded = forward(cfg, tp, tokens=nxt, caches=tc, mode="decode",
                     positions=torch.tensor([[10], [16]]))[0]
    exact = forward(cfg, tp, tokens=nxt[:1], caches=te, mode="decode",
                    positions=torch.tensor([[10]]))[0]
    assert (padded - exact).abs().max().item() > 0.1


# ---------------------------------------------- K1 / K2 at head dim 256
K1_CASES_256 = {
    "causal_gqa": (1, 64, 64, 4, 1, dict(causal=True)),
    "window_softcap": (1, 64, 64, 2, 1, dict(causal=True, window=24,
                                             softcap=30.0)),
    "kv_len": (1, 48, 64, 2, 2, dict(causal=False, kv_len=40)),
}


def _bh(x):
    return x.transpose(0, 2, 1, 3).reshape(-1, x.shape[1], x.shape[3])


@pytest.mark.parametrize("case", sorted(K1_CASES_256))
def test_k1_plain_at_head_dim_256_matches_pallas_kernel(jx, case):
    B, Sq, Skv, Hq, Hkv, kw = K1_CASES_256[case]
    rng = np.random.default_rng(16)
    q = rng.standard_normal((B, Sq, Hq, 256)).astype(np.float32)
    k, v = (rng.standard_normal((B, Skv, Hkv, 256)).astype(np.float32)
            for _ in range(2))
    out, visits = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                        bq=16, bk=16, **kw)
    G = Hq // Hkv
    # the Pallas kernel wants one kv head per query head: repeat them
    kr, vr = (np.repeat(x, G, axis=2) for x in (k, v))
    jout, jvis = jx["jfa"].flash_attention(_bh(q), _bh(kr), _bh(vr), bq=16,
                                           bk=16, interpret=True,
                                           return_visits=True, **kw)
    np.testing.assert_allclose(_bh(out.numpy()), np.asarray(jout), atol=2e-5,
                               rtol=0)
    np.testing.assert_array_equal(visits.numpy(), np.asarray(jvis))


def test_k1_at_head_dim_256_takes_its_one_built_tile():
    """K1 is built for bq = 32 at head dim 256 (a 64-row tile spills);
    ``mha_prefill`` takes it, on the CPU through the plain version."""
    assert ops.attn_block_sizes("prefill", 128, bh=512, head_dim=256) == \
        (32, 32)
    assert ops.attn_block_sizes("prefill", 128, bh=512) == (64, 32)
    # a head dim K1 is not built for (the CPU tests' 16) keeps both tiles
    assert ops.attn_block_sizes("prefill", 128, bh=512, head_dim=16) == \
        (64, 32)
    rng = np.random.default_rng(21)
    q = torch.from_numpy(rng.standard_normal((2, 40, 4, 256)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 40, 1, 256)).astype(
        np.float32)) for _ in range(2))
    got = ops.mha_prefill(q, k, v, causal=True, window=2048, kv_len=40)
    want, _ = flash_attention_plain(q, k, v, causal=True, window=2048,
                                    kv_len=40, bq=32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("window", [None, 40])
def test_k2_plain_at_head_dim_256_matches_pallas_kernel(jx, window):
    """G = 16 query heads over one kv head, the hybrid's decode shape, on
    a wrapped ring with empty slots."""
    B, L, Hq, D = 2, 64, 16, 256
    rng = np.random.default_rng(17)
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, L, 1, D)).astype(np.float32)
            for _ in range(2))
    kv_pos = np.full((B, L), -1, np.int32)
    for b, n in enumerate((90, 30)):
        p = np.arange(n)[-L:]
        kv_pos[b, p % L] = p
    q_pos = kv_pos.max(1).astype(np.int32)
    out, visits = decode_attention_plain(
        *map(torch.from_numpy, (q, k, v, q_pos, kv_pos)), bk=16,
        window=window)
    jout, jvis = jx["jda"].decode_attention(
        q[:, 0].reshape(B, Hq, D), k[:, :, 0], v[:, :, 0], q_pos[:, None],
        kv_pos, bk=16, window=window, interpret=True, return_visits=True)
    np.testing.assert_allclose(out.numpy().reshape(B, Hq, D), np.asarray(jout),
                               atol=2e-5, rtol=0)
    np.testing.assert_array_equal(visits.numpy(), np.asarray(jvis)[:, 0])


# ------------------------------------------------------------ serving
def _serve(make, prompts, sampling):
    eng = make()
    try:
        handles = [eng.generate(p, s) for p, s in zip(prompts, sampling)]
        return [h.result(timeout=600) for h in handles]
    finally:
        eng.close()


def test_engine_tokens_and_finish_reasons_equal_the_jax_engine(jx, weights):
    """The hybrid served batch at a time in two buckets, greedy, sampled,
    budget-capped and eos-stopped rows: identical tokens and finish
    reasons."""
    jp, tp = weights["smoke"]
    rng = np.random.default_rng(18)
    prompts = [rng.integers(0, SMOKE.vocab_size, int(n))
               for n in (3, 9, 16, 5, 20, 31, 17, 25)]
    sampling = [dict(), dict(temperature=0.8, top_k=50, seed=3),
                dict(max_new_tokens=2), dict(eos_id=None)] * 2
    jcfg = jx["cfgs"]["smoke"]
    jax_engine = lambda: jx["Engine"](jcfg, jp,  # noqa: E731
                                      jx["EngineConfig"](**DECODER))
    greedy = _serve(jax_engine, prompts, [jx["Sampling"]()] * len(prompts))
    for i, sp in enumerate(sampling):
        if "eos_id" in sp:
            sampling[i] = dict(eos_id=int(greedy[i].tokens[1]))
    want = _serve(jax_engine, prompts,
                  [jx["Sampling"](**s) for s in sampling])
    got = _serve(lambda: ServingEngine(SMOKE, tp, EngineConfig(**DECODER),
                                       device="cpu"),
                 prompts, [SamplingParams(**s) for s in sampling])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.finish_reason == w.finish_reason
    assert [g.finish_reason for g in got].count("eos") == 2


@pytest.mark.parametrize("kw", [dict(weight_quant="int8"),
                                dict(kv_quant="int8")])
def test_int8_serving_of_the_hybrid_raises(kw):
    params = init_params(SMOKE, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="item 15"):
        ServingEngine(SMOKE, params, EngineConfig(**DECODER, **kw),
                      device="cpu")


# ---------------------------------------------------- trees and configs
def _layout(tree):
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def test_the_hybrid_tree_bridges_as_it_is(jx, weights):
    """JAX's tree (blk0..blk2, the rglru leaves) and the port's own init
    have the same leaves, shapes and dtypes, bf16 included."""
    jax = jx["jax"]
    for name in ("smoke", "two_periods"):
        jp, tp = weights[name]
        own = init_params(CONFIGS[name], 0, device="cpu")
        assert _layout(own) == _layout(tp) == _layout(
            jax.tree.map(np.asarray, jp))
    jcfg16 = dataclasses.replace(jx["cfgs"]["smoke"], dtype="bfloat16")
    jp16 = jax.tree.map(np.asarray, jx["jt"].init_params(
        jcfg16, jax.random.PRNGKey(0)))
    tp16 = to_torch(jp16, device="cpu")
    own16 = init_params(dataclasses.replace(SMOKE, dtype="bfloat16"), 0,
                        device="cpu")
    assert _layout(own16) == _layout(tp16)
    r = tp16["blocks"]["blk0"]["rglru"]
    assert r["w_x"].dtype == torch.bfloat16 and r["a_param"].dtype == \
        torch.float32
    np.testing.assert_array_equal(
        r["w_x"].float().numpy(),
        np.asarray(jp16["blocks"]["blk0"]["rglru"]["w_x"], np.float32))


def test_caches_hold_rings_and_states():
    cfg = CONFIGS["two_periods"]
    c = make_caches(cfg, 3, 100, dtype=torch.float32, device="cpu")
    assert set(c) == {"blk0", "blk1", "blk2"}
    assert tuple(c["blk0"]["h"].shape) == (2, 3, cfg.d_model)
    assert tuple(c["blk1"]["conv"].shape) == (2, 3, 3, cfg.d_model)
    assert tuple(c["blk2"]["k"].shape) == (2, 3, 64, 1, 64)   # window 64
    short = make_caches(cfg, 3, 20, dtype=torch.float32, device="cpu")
    assert tuple(short["blk2"]["pos"].shape) == (2, 3, 20)


@pytest.mark.parametrize("kw", [
    dict(pattern=("attn_local", "attn_global"), n_layers=2,
         post_norms=True),
    dict(pattern=("mlstm", "slstm"), n_layers=2),
    dict(pattern=("attn_local", "attn_global"), n_layers=2)])
def test_unported_blocks_still_raise(kw):
    cfg = dataclasses.replace(SMOKE, **kw)
    with pytest.raises(NotImplementedError, match="items 2 and 13"):
        make_caches(cfg, 1, 8, device="cpu")


# ---------------------------------------------------------- on the card
@requires_cuda
@pytest.mark.parametrize("shape", [(1, 1, 4096), (1, 37, 4096),
                                   (4, 300, 256), (3, 100, 130)])
def test_k5_cuda_kernel_matches_plain(shape):
    a, b = (torch.from_numpy(x).cuda() for x in _scan_inputs(*shape))
    before = rglru_scan.launches
    out = rglru_scan(a, b)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 1
    ref = rglru_scan_plain(a, b)
    err = (out - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item()
    zero = rglru_scan(torch.ones(2, 9, 33, device="cuda"),
                      torch.zeros(2, 9, 33, device="cuda"))
    assert not zero.any()


@requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", sorted(K1_CASES_256))
def test_k1_cuda_kernel_at_head_dim_256_matches_plain(case, dtype, tol):
    B, Sq, Skv, Hq, Hkv, kw = K1_CASES_256[case]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    q = torch.randn(B, Sq, Hq, 256, device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn(B, Skv, Hkv, 256, device="cuda",
                        generator=gen).to(dtype) for _ in range(2))
    bq, bk = ops.attn_block_sizes("prefill", Sq, bh=B * Hq, head_dim=256,
                                  dtype=dtype)
    out, visits = flash_attention(q, k, v, bq=bq, return_visits=True, **kw)
    torch.cuda.synchronize()
    ref, ref_visits = flash_attention_plain(q.float(), k.float(), v.float(),
                                            bq=bq, bk=bk, **kw)
    torch.testing.assert_close(out.float(), ref, atol=tol,
                               rtol=0 if dtype == torch.float32 else tol)
    assert torch.equal(visits, ref_visits)
    # fp32 is built for bq = 32 only at head dim 256, bf16 for 32 and 64
    with pytest.raises(ValueError, match="not built at head dim 256"):
        flash_attention(q, k, v, bq=64 if dtype == torch.float32 else 128,
                        **kw)


@requires_cuda
@pytest.mark.parametrize("q_dtype,kv_dtype,tol", [
    (torch.float32, torch.float32, 1e-4),
    (torch.bfloat16, torch.bfloat16, 2e-2),
    (torch.bfloat16, torch.float32, 2e-2)])
def test_k2_cuda_kernel_at_head_dim_256_matches_plain(q_dtype, kv_dtype,
                                                      tol):
    B, L, Hq, D = 3, 144, 16, 256
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    q = torch.randn(B, 1, Hq, D, device="cuda", generator=gen).to(q_dtype)
    k, v = (torch.randn(B, L, 1, D, device="cuda", generator=gen).to(
        kv_dtype) for _ in range(2))
    kv_pos = torch.arange(L, dtype=torch.int32, device="cuda").expand(
        B, L).contiguous()
    kv_pos[1, 100:] = -1
    q_pos = torch.tensor([L - 1, 99, L - 1], dtype=torch.int32,
                         device="cuda")
    for window in (None, 50):
        out, visits = decode_attention(q, k, v, q_pos, kv_pos, window=window,
                                       return_visits=True)
        torch.cuda.synchronize()
        ref, ref_visits = decode_attention_plain(
            q.float(), k.to(q_dtype).float(), v.to(q_dtype).float(), q_pos,
            kv_pos, window=window, n_split=decode_splits(B, 1, L)[0])
        torch.testing.assert_close(out.float(), ref, atol=tol,
                                   rtol=0 if q_dtype == torch.float32
                                   else tol)
        assert torch.equal(visits, ref_visits)
