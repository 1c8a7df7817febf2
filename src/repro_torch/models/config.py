"""Model configuration dataclasses (a copy of ``repro/models/config.py``
with a torch dtype in place of the jnp one).

Every assigned architecture is expressed as a ``ModelConfig`` built from
composable block descriptors. A model is a stack of *pattern periods*: e.g.
gemma2 is ``("attn_local", "attn_global")`` repeated, recurrentgemma is
``("rglru", "rglru", "attn_local")`` repeated, xlstm is ``("mlstm", "slstm")``.
Homogeneous stacks use a single-element pattern. Parameters are stacked
over a leading period axis, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    # d_ff of each routed expert (shared experts use the same width unless set)
    expert_d_ff: int = 0
    shared_d_ff: int = 0
    router_aux_loss_weight: float = 0.01
    capacity_factor: float = 1.25
    # 'expert' = shard expert dim on model axis; 'tensor' = shard each expert's
    # d_ff on model axis (used when num_experts isn't divisible by the axis).
    sharding: str = "auto"


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    # sliding window size; None = full attention
    window: Optional[int] = None
    logit_softcap: Optional[float] = None
    qkv_bias: bool = False
    # rotary embedding base; None = no rotary (recurrent archs, or abs-pos
    # models — see ModelConfig.abs_pos)
    rope_base: Optional[float] = 10_000.0
    # cap applied to the *global* layers' effective window at long-context
    # decode (gemma2 windowed-global variant); None = no cap
    long_ctx_window_cap: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // n_heads
    # block pattern, repeated to n_layers. entries:
    #   attn | attn_local | attn_global | mlstm | slstm | rglru
    pattern: Tuple[str, ...] = ("attn",)
    moe: Optional[MoEConfig] = None
    attn: AttnConfig = AttnConfig()
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    act: str = "silu"                   # silu | gelu
    gated_mlp: bool = True              # SwiGLU-style vs plain 2-layer MLP
    final_logit_softcap: Optional[float] = None
    tie_embeddings: bool = False
    max_seq_len: int = 524_288
    # encoder-decoder (whisper): encoder layer count; 0 = decoder-only
    enc_layers: int = 0
    enc_seq_len: int = 1500             # stub frontend sequence length
    # VLM prefix: number of stub image-patch embedding tokens prepended
    vis_tokens: int = 0
    # post-attn / post-ffn extra norms (gemma2 style)
    post_norms: bool = False
    # learned absolute position embeddings (BERT / whisper decoder)
    abs_pos: bool = False
    # sLSTM/mLSTM internals
    xlstm_proj_factor: float = 2.0
    # RG-LRU internals
    rglru_rnn_width: int = 0            # 0 -> d_model
    # scale the token embedding by sqrt(d_model), rounded to the model
    # dtype (the Gemma family; JAX keys this on the name's prefix)
    embed_scale: bool = False
    vocab_pad_multiple: int = 256
    dtype: str = "bfloat16"

    # ---- derived ----
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    @property
    def layer_pattern(self) -> Tuple[str, ...]:
        """Full per-layer block list of length n_layers."""
        p = self.pattern
        reps = (self.n_layers + len(p) - 1) // len(p)
        return (p * reps)[: self.n_layers]

    @property
    def n_periods(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not a multiple of "
            f"pattern length {len(self.pattern)}"
        )
        return self.n_layers // len(self.pattern)

    @property
    def torch_dtype(self) -> torch.dtype:
        """The model's activation/weight dtype as a ``torch.dtype``."""
        return getattr(torch, self.dtype)

    @property
    def fused_qkv(self) -> bool:
        """Grouped fused-QKV layout (d, G, q_per_g + 2, hd): one column-
        parallel projection (one backward dx all-reduce) instead of three.
        Requires kv-head groups to divide the 16-way production model axis
        so the group dim shards and the q/k/v split stays shard-local
        (§Perf iteration B2)."""
        return (self.n_kv_heads % 16 == 0
                and self.n_heads % self.n_kv_heads == 0)

    @property
    def is_subquadratic(self) -> bool:
        """True if every block is recurrent or windowed attention (possibly via
        the long-context window cap), i.e. long_500k decode is admissible."""
        for b in self.pattern:
            if b in ("mlstm", "slstm", "rglru", "attn_local"):
                continue
            if b in ("attn", "attn_global"):
                if self.attn.long_ctx_window_cap is None:
                    return False
                continue
            raise ValueError(b)
        return True

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + heads)."""
        d, hd = self.d_model, self.head_dim_
        n_q, n_kv = self.n_heads, self.n_kv_heads
        total = self.padded_vocab * d  # embedding
        if not self.tie_embeddings:
            total += self.padded_vocab * d
        def attn_params():
            p = d * hd * (n_q + 2 * n_kv) + n_q * hd * d
            if self.attn.qkv_bias:
                p += hd * (n_q + 2 * n_kv)
            return p
        def mlp_params(d_ff):
            return d * d_ff * (3 if self.gated_mlp else 2)
        def ffn_params():
            if self.moe is not None:
                e_ff = self.moe.expert_d_ff or self.d_ff
                s_ff = self.moe.shared_d_ff or e_ff
                p = self.moe.num_experts * mlp_params(e_ff)
                p += self.moe.num_shared_experts * mlp_params(s_ff)
                p += d * self.moe.num_experts  # router
                return p
            return mlp_params(self.d_ff)
        for blk in self.layer_pattern:
            if blk.startswith("attn"):
                total += attn_params() + ffn_params() + 2 * d
            elif blk == "rglru":
                w = self.rglru_rnn_width or d
                # linear in/out + gates + conv-ish mixing approximation
                total += d * w * 2 + 3 * w + ffn_params() + 2 * d
            elif blk == "mlstm":
                pf = self.xlstm_proj_factor
                dp = int(d * pf)
                total += d * dp * 2 + dp * 3 * (dp // max(n_q, 1)) + dp * d + 2 * d
            elif blk == "slstm":
                total += 4 * d * d + 4 * d * d + d * int(d * 4 / 3) * 2 + 2 * d
        # encoder stack (whisper)
        for _ in range(self.enc_layers):
            total += attn_params() + mlp_params(self.d_ff) + 2 * d
            total += attn_params()  # decoder cross-attention, one per dec layer
        return int(total)

    def active_param_count(self) -> int:
        """Params active per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        e_ff = self.moe.expert_d_ff or self.d_ff
        per_expert = self.d_model * e_ff * (3 if self.gated_mlp else 2)
        inactive = (self.moe.num_experts - self.moe.top_k) * per_expert
        return int(full - inactive * self.n_layers)
