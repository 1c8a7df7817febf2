"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, exponential
gating) and sLSTM (scalar memory, exponential gating with a stabiliser
state).

Port of ``repro/models/xlstm.py``, with its simplifications (no causal
conv4 before the mLSTM's QKV; the cell's GroupNorm is an RMSNorm over the
concatenated heads). Weights keep the JAX layout: the mLSTM's ``w_in``
(d, 2 dp), ``wq``/``wk``/``wv`` (dp, nh, hd) and ``w_out`` (dp, d) in the
model dtype, its gates ``w_igate``/``w_fgate`` (dp, nh) and biases in
fp32 (``b_fgate`` starts at 3.0, forget gates open); the sLSTM's
``w_{izfo}`` (d, nh, hd) and ``r_{izfo}`` (nh, hd, hd) in the model
dtype, ``b_{izfo}`` (nh, hd) in fp32, and a gated GeLU FFN of width
``int(d * 4 / 3)``.

``mlstm_apply`` runs the chunkwise-parallel form (``_mlstm_parallel``:
chunks of 256 positions, each query chunk under
``torch.utils.checkpoint``) on a whole sequence from no state, as
training does, and the recurrence step by step otherwise (a served
prefill carries the cache's state, so it steps, as in JAX). The
stabiliser ``m`` of the parallel form is JAX's max-plus scan, written as
``m_t = F_t + max_{j<=t} (i_j - F_j)`` with a log-depth prefix maximum in
``torch.maximum`` (whose backward is elementwise, so two backwards give
the same bits; ``torch.cummax``'s scatters). The recurrences stay in
torch ops, as JAX's stay in ``jnp``: no TPU kernel is behind them.

A row's bits must not follow the rows beside it (a served prefill runs
a join's rows together, a decode step the width's). Each step's
contractions (the mLSTM's ``bhvk,bhk->bhv`` and ``bhk,bhk->bh``, the
sLSTM's ``bhk,hkv->bhv``) are a product and a sum over a contiguous
last axis, not a batched matrix product: the libraries pick their
matrix kernels by the batch, while the sum's order per output follows
the summed axis alone (the mLSTM's denominator is summed in 32-wide
pieces, then across them, so that every sum has outputs enough to keep
its shape). The fp32 input products of the gates (the mLSTM's
``w_igate``/``w_fgate``, the sLSTM's ``w_{izfo}``, fp32 as in JAX) run
``ROW_TILE`` rows a call (``_tiled_matmul``): on the H100 cublasLt
gives a row of these fp32 products five to seven sets of bits across M
= 16..8192, the sets interleaved, so that no floor of M keeps them
(``chip_blas_rows.py --scan K N --fp32``), while the model dtype's
products keep a row's bits from 128 rows on (``chip_smoke.py`` phase
34 (c)). Where grad is enabled the sLSTM's recurrence runs through
``_SLSTMRecurrence``, whose backward through time is written out step
by step: autograd's own records some 30 ops a step.
A state is a dict of fp32 tensors: ``{C (B, nh, hd, hd), n (B, nh, hd),
m (B, nh)}`` for the mLSTM (``m`` starts at -1e30), ``{c, n, h, m}``
each (B, nh, hd) for the sLSTM (``m`` starts at 0), as in JAX; where JAX
returns a new state, a carried state is written in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.models.layers import act_fn, apply_norm, dense_init, \
    norm_init

_M_START = -1e30      # the mLSTM stabiliser's start and its padded i
ROW_TILE = 128        # rows of an fp32 gate product a call


def _tiled_matmul(x, w):
    """x (..., K) @ w (K, N) in calls of ``ROW_TILE`` rows each, the last
    padded with zero rows: every call has one shape, so a row's bits do
    not follow how many rows run beside it (see the module's
    docstring)."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    pad = (-M) % ROW_TILE
    if pad:
        x2 = torch.cat([x2, x2.new_zeros(pad, K)])
    out = torch.cat([x2[i:i + ROW_TILE] @ w
                     for i in range(0, x2.shape[0], ROW_TILE)])
    return out[:M].reshape(*lead, w.shape[1])


# ===================================================================== mLSTM
def _mlstm_dims(cfg):
    dp = int(cfg.d_model * cfg.xlstm_proj_factor)
    return dp, cfg.n_heads, dp // cfg.n_heads


def mlstm_init(cfg, gen):
    d = cfg.d_model
    dp, nh, hd = _mlstm_dims(cfg)
    dev, dt, f32 = gen.device, cfg.torch_dtype, torch.float32
    return {
        "norm": norm_init(cfg, dev),
        "w_in": dense_init(gen, (d, 2 * dp), d, dt),
        "wq": dense_init(gen, (dp, nh, hd), dp, dt),
        "wk": dense_init(gen, (dp, nh, hd), dp, dt),
        "wv": dense_init(gen, (dp, nh, hd), dp, dt),
        "w_igate": dense_init(gen, (dp, nh), dp, f32),
        "w_fgate": dense_init(gen, (dp, nh), dp, f32),
        "b_igate": torch.zeros((nh,), dtype=f32, device=dev),
        "b_fgate": torch.full((nh,), 3.0, dtype=f32, device=dev),
        "cell_norm": norm_init(cfg, dev, dp),
        "w_out": dense_init(gen, (dp, d), dp, dt),
    }


def mlstm_state(cfg, batch, *, device=None):
    """The mLSTM's initial state on ``device`` (default: the card): C and
    n zero, m at -1e30, so that the first step weighs its input by 1 and
    decays no history (the parallel form's convention)."""
    dev = resolve_device(device)
    _, nh, hd = _mlstm_dims(cfg)
    f32 = torch.float32
    return {"C": torch.zeros((batch, nh, hd, hd), dtype=f32, device=dev),
            "n": torch.zeros((batch, nh, hd), dtype=f32, device=dev),
            "m": torch.full((batch, nh), _M_START, dtype=f32, device=dev)}


def _dot_last(a, b):
    """sum(a * b) over the last axis (hd), in 32-wide pieces then across
    them where hd allows, so that each sum has (B, nh, hd / 32) outputs,
    not (B, nh): see the module's docstring."""
    prod = a * b
    hd = prod.shape[-1]
    if hd % 32 == 0 and hd > 32:
        prod = prod.reshape(*prod.shape[:-1], hd // 32, 32).sum(-1)
    return prod.sum(-1)


def _mlstm_cell(q, k, v, it, ft, state):
    """One step. q/k/v: (B, nh, hd) fp32, k already scaled by 1/sqrt(hd);
    it/ft: (B, nh) raw gate pre-activations (ft log-sigmoid'd). Returns
    (h (B, nh, hd), new state)."""
    fm = ft + state["m"]
    m_new = torch.maximum(fm, it)
    i = torch.exp(it - m_new)
    f = torch.exp(fm - m_new)
    C = (f[..., None, None] * state["C"]
         + i[..., None, None] * (v[..., :, None] * k[..., None, :]))
    n = f[..., None] * state["n"] + i[..., None] * k
    num = (C * q[..., None, :]).sum(-1)                    # bhvk,bhk->bhv
    den = torch.abs(_dot_last(n, q))                       # bhk,bhk->bh
    h = num / torch.clamp(den, min=1.0)[..., None]
    return h, {"C": C, "n": n, "m": m_new}


def _pad_seq(x, mult, value=0.0):
    pad = (-x.shape[1]) % mult
    if pad == 0:
        return x
    shape = (x.shape[0], pad, *x.shape[2:])
    return torch.cat([x, x.new_full(shape, value)], 1)


def _prefix_max(x):
    """max over positions j <= t along axis 1, in log2(S) steps of
    ``torch.maximum`` (a Hillis-Steele scan)."""
    d = 1
    while d < x.shape[1]:
        x = torch.cat([x[:, :d], torch.maximum(x[:, d:], x[:, :-d])], 1)
        d *= 2
    return x


def _mlstm_parallel(q, k, v, it, ft, *, q_chunk=256, kv_chunk=256):
    """Chunkwise-parallel mLSTM (JAX's ``_mlstm_parallel``). Unrolling the
    stabilised recurrence gives decay-masked attention:
        m_t   = max_{j<=t} (F_t - F_j + i_j)
        s_tj  = (q_t . k_j / sqrt(d)) * exp(F_t - F_j + i_j - m_t),  j <= t
        h_t   = sum_j s_tj v_j / max(|sum_j s_tj|, 1)
    with F = cumsum(log f). Key chunks past a query chunk are masked
    whole and add nothing (JAX adds their zeros), so they are skipped.

    q/k/v: (B, S, H, D); it/ft: (B, S, H) fp32 (ft log-sigmoid'd).
    Returns ((B, S, H, D) fp32, the final {C, n, m} state)."""
    B, S, H, D = q.shape
    kf = k.float() / math.sqrt(float(D))
    Fs = torch.cumsum(ft, 1)                               # (B, S, H)
    m = Fs + _prefix_max(it - Fs)
    qp = _pad_seq(q.float(), q_chunk)
    Fq, mq = _pad_seq(Fs, q_chunk), _pad_seq(m, q_chunk)
    kfp, vp = _pad_seq(kf, kv_chunk), _pad_seq(v.float(), kv_chunk)
    Fk = _pad_seq(Fs, kv_chunk)
    ik = _pad_seq(it, kv_chunk, value=_M_START)
    nq, nk = qp.shape[1] // q_chunk, kfp.shape[1] // kv_chunk
    dev = q.device

    def q_block(qi, qc, Fc, mc):
        qpos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        num = torch.zeros((B, H, q_chunk, D), dtype=torch.float32,
                          device=dev)
        den = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=dev)
        FcT = Fc.transpose(1, 2)[..., None]
        mcT = mc.transpose(1, 2)[..., None]
        for ki in range(nk):
            lo = ki * kv_chunk
            if lo > qi * q_chunk + q_chunk - 1:
                break
            sl = slice(lo, lo + kv_chunk)
            kc, vc = kfp[:, sl], vp[:, sl]
            FjT = Fk[:, sl].transpose(1, 2)[:, :, None, :]
            ijT = ik[:, sl].transpose(1, 2)[:, :, None, :]
            kpos = lo + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", qc, kc)
            expo = FcT - FjT + ijT - mcT
            causal = kpos[None, :] <= qpos[:, None]
            w = torch.where(causal[None, None],
                            torch.exp(torch.clamp(expo, max=0.0)), 0.0)
            sw = s * w
            num = num + torch.einsum("bhqk,bkhd->bhqd", sw, vc)
            den = den + torch.sum(sw, dim=-1)
        h = num / torch.clamp(torch.abs(den), min=1.0)[..., None]
        return h.transpose(1, 2)                            # (B, C, H, D)

    hs = []
    for qi in range(nq):
        sl = slice(qi * q_chunk, (qi + 1) * q_chunk)
        args = (qi, qp[:, sl], Fq[:, sl], mq[:, sl])
        if torch.is_grad_enabled():
            hs.append(torch.utils.checkpoint.checkpoint(
                q_block, *args, use_reentrant=False))
        else:
            hs.append(q_block(*args))
    hs = torch.cat(hs, 1)[:, :S]

    # the final state, for a decode that continues (the exact recurrent
    # state at t = S)
    m_last = m[:, -1]                                       # (B, H)
    decay = torch.exp(torch.clamp(
        Fs[:, -1][:, :, None] - Fs.transpose(1, 2) + it.transpose(1, 2)
        - m_last[:, :, None], max=0.0))                     # (B, H, S)
    vd = v.float() * decay.transpose(1, 2)[..., None]       # (B, S, H, D)
    C = torch.einsum("bshv,bshk->bhvk", vd, kf)
    n = torch.einsum("bhs,bshk->bhk", decay, kf)
    return hs, {"C": C, "n": n, "m": m_last}


def mlstm_apply(cfg, p, x, state=None):
    """x: (B, S, d) -> (delta (B, S, d), state). With no state and S > 1
    the chunkwise-parallel form; otherwise the recurrence from ``state``
    (a fresh one if None), which is then overwritten in place with the
    state after the last position (row padding included, as in JAX)."""
    B, S, _ = x.shape
    dp, nh, hd = _mlstm_dims(cfg)
    xn = apply_norm(cfg, p["norm"], x)
    proj = xn @ p["w_in"]
    main, gate = proj[..., :dp], proj[..., dp:]
    q, k, v = ((main @ p[w].reshape(dp, dp)).reshape(B, S, nh, hd)
               for w in ("wq", "wk", "wv"))
    gates = _tiled_matmul(main.float(),
                          torch.cat([p["w_igate"], p["w_fgate"]], 1))
    it = gates[..., :nh] + p["b_igate"]
    ft = F.logsigmoid(gates[..., nh:] + p["b_fgate"])
    if state is None and S > 1:
        hs, state = _mlstm_parallel(q, k, v, it, ft)
    else:
        cur = mlstm_state(cfg, B, device=x.device) if state is None \
            else state
        qf, vf = q.float(), v.float()
        kf = k.float() / math.sqrt(float(hd))
        out = []
        for t in range(S):
            h, cur = _mlstm_cell(qf[:, t], kf[:, t], vf[:, t], it[:, t],
                                 ft[:, t], cur)
            out.append(h)
        hs = torch.stack(out, 1)
        if state is None:
            state = cur
        else:
            for key, t_ in state.items():
                t_.copy_(cur[key])
    hs = apply_norm(cfg, p["cell_norm"], hs.reshape(B, S, dp).to(x.dtype))
    hs = hs * F.silu(gate)
    return hs @ p["w_out"], state


# ===================================================================== sLSTM
def slstm_init(cfg, gen):
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    dev, dt, f32 = gen.device, cfg.torch_dtype, torch.float32
    p = {"norm": norm_init(cfg, dev)}
    for g in "izfo":
        p[f"w_{g}"] = dense_init(gen, (d, nh, hd), d, dt)
        p[f"r_{g}"] = dense_init(gen, (nh, hd, hd), hd, dt)
        p[f"b_{g}"] = torch.zeros((nh, hd), dtype=f32, device=dev)
    p["cell_norm"] = norm_init(cfg, dev)
    ff = int(d * 4 / 3)
    p["ffn"] = {
        "norm": norm_init(cfg, dev),
        "w_gate": dense_init(gen, (d, ff), d, dt),
        "w_up": dense_init(gen, (d, ff), d, dt),
        "w_down": dense_init(gen, (ff, d), ff, dt),
    }
    return p


def slstm_state(cfg, batch, *, device=None):
    """The sLSTM's initial state on ``device`` (default: the card): every
    leaf zero, the stabiliser m included (JAX's)."""
    dev = resolve_device(device)
    nh = cfg.n_heads
    shape = (batch, nh, cfg.d_model // nh)
    return {k: torch.zeros(shape, dtype=torch.float32, device=dev)
            for k in ("c", "n", "h", "m")}


def _recurrent_matrix(p):
    """The four r_{izfo} (nh, hd_in, hd_out) as one fp32 (4, nh, hd_out,
    hd_in) tensor, the contraction on the contiguous last axis."""
    return torch.stack([p[f"r_{g}"].float().transpose(1, 2)
                        for g in "izfo"]).contiguous()


def _slstm_cell(pre, state):
    """One step from the gates' pre-activations ``pre`` (B, 4, nh, hd),
    i, z, f, o. Returns (h (B, nh, hd), new state)."""
    pre_i, pre_z, pre_f, pre_o = pre.unbind(1)
    zt = torch.tanh(pre_z)
    ot = torch.sigmoid(pre_o)
    fm = F.logsigmoid(pre_f) + state["m"]
    m_new = torch.maximum(fm, pre_i)
    i = torch.exp(pre_i - m_new)
    f = torch.exp(fm - m_new)
    c = f * state["c"] + i * zt
    n = f * state["n"] + i
    h = ot * c / torch.clamp(n, min=1.0)
    return h, {"c": c, "n": n, "h": h, "m": m_new}


def _slstm_scan(wx, rT, b, state, keep=False):
    """The recurrence over S steps. wx: (B, S, 4, nh, hd) fp32 input
    contributions of the gates; rT: ``_recurrent_matrix``; b: (4, nh, hd)
    the biases. Returns (hs (B, S, nh, hd), final state) and, with
    ``keep``, the pre-activations (B, S, 4, nh, hd) and the states
    {c, n, h, m} before every step and after the last, (B, S + 1, nh,
    hd) each."""
    cur, out = state, []
    pres, seen = [], {k: [t] for k, t in state.items()}
    for t in range(wx.shape[1]):
        rec = (cur["h"][:, None, :, None, :] * rT).sum(-1)  # bhk,hkv->bhv
        pre = wx[:, t] + rec + b
        h, cur = _slstm_cell(pre, cur)
        out.append(h)
        if keep:
            pres.append(pre)
            for k, t_ in cur.items():
                seen[k].append(t_)
    hs = torch.stack(out, 1)
    if not keep:
        return hs, cur
    return hs, cur, torch.stack(pres, 1), {k: torch.stack(v, 1)
                                          for k, v in seen.items()}


def _half_at_ties(a, b):
    """d max(a, b) / da as JAX differentiates it: 1 where a > b, 0.5
    where they tie, 0 below."""
    return (a > b).float() + 0.5 * (a == b).float()


class _SLSTMRecurrence(torch.autograd.Function):
    """``_slstm_scan`` with its backward through time written out step by
    step in torch ops, JAX's derivative of the same cell (ties of the two
    maxima split the gradient in halves, as ``jnp.maximum``'s): autograd
    would record some 30 ops a step and run a 512-step training sequence
    at several seconds of host time a layer. The forward is the serving
    path's loop, so both give the same bits."""

    @staticmethod
    def forward(ctx, wx, rT, b, c, n, h, m):
        state = {"c": c, "n": n, "h": h, "m": m}
        hs, cur, pre, seen = _slstm_scan(wx, rT, b, state, keep=True)
        ctx.save_for_backward(rT, pre, *(seen[k] for k in "cnhm"))
        return hs, cur["c"], cur["n"], cur["h"], cur["m"]

    @staticmethod
    def backward(ctx, g_hs, g_c, g_n, g_h, g_m):
        rT, pre, cs, ns, hs, ms = ctx.saved_tensors
        # what does not depend on the carried gradients, for every step
        # at once
        pre_i, pre_z, pre_f, pre_o = pre.unbind(2)
        zt, ot = torch.tanh(pre_z), torch.sigmoid(pre_o)
        fm = F.logsigmoid(pre_f) + ms[:, :-1]
        m, c, n = ms[:, 1:], cs[:, 1:], ns[:, 1:]
        i, f = torch.exp(pre_i - m), torch.exp(fm - m)
        nn = torch.clamp(n, min=1.0)
        h_ot, h_c = c / nn, ot / nn                # d h / d ot, d h / d c
        h_n = ot * c / (nn * nn) * _half_at_ties(n, 1.0)   # - d h / d n
        sel = _half_at_ties(fm, pre_i)             # d m / d fm
        dz, dfp, do = 1.0 - zt * zt, torch.sigmoid(-pre_f), ot * (1.0 - ot)
        zero = torch.zeros_like(cs[:, 0])
        gc, gn, gm, gh = (zero if g is None else g
                          for g in (g_c, g_n, g_m, g_h))
        dpre = torch.empty_like(pre)
        for t in reversed(range(pre.shape[1])):
            if g_hs is not None:
                gh = gh + g_hs[:, t]
            # h = ot c / max(n, 1)
            gc = gc + gh * h_c[:, t]
            gn = gn - gh * h_n[:, t]
            # c = f c_prev + i zt; n = f n_prev + i
            df = (gc * cs[:, t] + gn * ns[:, t]) * f[:, t]
            di = (gc * zt[:, t] + gn) * i[:, t]
            d_zt = gc * i[:, t]
            gc, gn = gc * f[:, t], gn * f[:, t]
            # i = exp(pre_i - m), f = exp(fm - m), m = max(fm, pre_i)
            d_m = gm - di - df
            gm = df + d_m * sel[:, t]                  # fm = logf + m_prev
            dpre[:, t] = torch.stack([
                di + d_m * (1.0 - sel[:, t]), d_zt * dz[:, t],
                gm * dfp[:, t], gh * h_ot[:, t] * do[:, t]], 1)
            # pre = wx + h_prev r + b
            gh = torch.einsum("bghv,ghvk->bhk", dpre[:, t], rT)
        d_rT = torch.einsum("bsghv,bshk->ghvk", dpre, hs[:, :-1])
        return dpre, d_rT, dpre.sum((0, 1)), gc, gn, gh, gm


def slstm_apply(cfg, p, x, state=None):
    """x: (B, S, d) -> (delta (B, S, d), state): the recurrence from
    ``state`` (zeros if None; a carried one is overwritten in place),
    the cell norm, then the gated GeLU FFN on ``x + out``; the delta is
    ``out + ffn_out``, as in JAX. Where grad is enabled the recurrence
    runs through ``_SLSTMRecurrence``."""
    B, S, d = x.shape
    nh = cfg.n_heads
    xn = apply_norm(cfg, p["norm"], x).float()
    w = torch.cat([p[f"w_{g}"].float().reshape(d, d) for g in "izfo"], 1)
    wx = _tiled_matmul(xn, w).reshape(B, S, 4, nh, d // nh)
    cur = slstm_state(cfg, B, device=x.device) if state is None else state
    rT = _recurrent_matrix(p)
    b = torch.stack([p[f"b_{g}"] for g in "izfo"])
    if torch.is_grad_enabled():
        hs, *new = _SLSTMRecurrence.apply(wx, rT, b,
                                          *(cur[k] for k in "cnhm"))
        new = dict(zip("cnhm", new))
    else:
        hs, new = _slstm_scan(wx, rT, b, cur)
    hs = hs.reshape(B, S, d).to(x.dtype)
    if state is None:
        state = new
    else:
        for key, t_ in state.items():
            t_.copy_(new[key])
    out = apply_norm(cfg, p["cell_norm"], hs)
    y = x + out
    yn = apply_norm(cfg, p["ffn"]["norm"], y)
    hmid = act_fn("gelu")(yn @ p["ffn"]["w_gate"]) * (yn @ p["ffn"]["w_up"])
    return out + hmid @ p["ffn"]["w_down"], state
