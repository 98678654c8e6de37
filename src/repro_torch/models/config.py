"""Model configuration covering every assigned architecture family.

One config dataclass drives the unified LM (models/lm.py): dense / MoE
(+MLA, +MTP) / SSM (Mamba2-SSD) / hybrid (Mamba2 + shared attention) /
local:global sliding-window attention, plus the enc-dec (whisper) and
vision-prefix (pixtral) assemblies.  Param-count helpers feed the roofline's
MODEL_FLOPS = 6·N(active)·D term.

Copied from the JAX package.  The port's models/lm.py runs every
decoder-only config (the vision prefix included) and models/encdec.py the
enc-dec one; models/api.py dispatches between them.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "LayerKind"]


class LayerKind:
    ATTN = 0      # attention mixer (GQA / MLA)
    MAMBA = 1     # Mamba2 SSD mixer


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    vocab_size: int

    # -- attention ---------------------------------------------------------
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    attn_logit_softcap: float = 0.0
    # sliding-window pattern: 0 => all-global.  "5:1" => 5 local then 1
    # global, repeating (gemma3).
    local_global_period: int = 0   # 0 = none; else every Nth layer is global
    sliding_window: int = 0

    # -- MLA (deepseek) ------------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0           # 0 => direct q projection
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # -- FFN -------------------------------------------------------------------
    d_ff: int = 0                  # dense FFN hidden (0 => no FFN, e.g. mamba2)
    mlp_variant: str = "swiglu"    # swiglu | geglu | gelu

    # -- MoE ---------------------------------------------------------------------
    moe: bool = False
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0    # leading layers that keep a dense FFN
    router_aux_coef: float = 0.001
    #: train-time expert-capacity factor (GShard dropping).  Serving paths
    #: (decode_step) always run no-drop (cf = E/k): inference must not drop.
    capacity_factor: float = 1.25

    # -- MTP (deepseek-v3) -----------------------------------------------------------
    mtp_depth: int = 0

    # -- SSM (mamba2 / zamba2) ---------------------------------------------------------
    ssm: bool = False              # True => mixer layers are Mamba2 blocks
    ssm_state: int = 0             # N
    ssm_expand: int = 2
    ssm_head_dim: int = 64         # P
    ssm_groups: int = 1            # G (B/C groups)
    ssm_conv_width: int = 4
    ssm_chunk: int = 128

    # -- hybrid (zamba2): a SHARED attention block applied every Nth layer -------------
    hybrid_attn_period: int = 0

    # -- enc-dec (whisper) -------------------------------------------------------------
    encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0           # frame count from the (stub) frontend

    # -- vision prefix (pixtral) -------------------------------------------------------
    vision_prefix: bool = False
    vision_dim: int = 0            # stub patch-embedding dim
    num_patches: int = 0

    # -- numerics ----------------------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # -- attention implementation ------------------------------------------------------
    #: The same values as the JAX package's, so one config means one path in
    #: both.  In this port: "xla" — einsum attention in plain PyTorch.
    #: "pallas_flash" — the hand-written CUDA kernels for plain causal
    #: attention: bf16 at head dims 64/128/256 on csrc/flash_attn_tc.cu
    #: (tensor cores), anything else on csrc/flash_attn.cu
    #: (kernels/flash_attn/ops.py ``route``); the plain PyTorch version on
    #: CPU tensors.
    #: Windowed/softcapped/cross/decode paths take the einsum path.
    attn_impl: str = "xla"

    # ----------------------------------------------------------------------------------
    def __post_init__(self) -> None:
        if self.ssm:
            assert self.ssm_state > 0
        elif not self.encoder_decoder:
            assert self.num_heads > 0 and self.head_dim > 0
        if self.moe:
            assert 0 < self.top_k <= self.num_experts
        if self.use_mla:
            assert self.kv_lora_rank > 0 and self.qk_rope_dim > 0

    # -- derived -------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attn_out_dim(self) -> int:
        if self.use_mla:
            return self.num_heads * self.v_head_dim
        return self.num_heads * self.head_dim

    def layer_kinds(self) -> list[int]:
        """Mixer kind per layer."""
        if self.ssm:
            return [LayerKind.MAMBA] * self.num_layers
        return [LayerKind.ATTN] * self.num_layers

    def is_global_layer(self, i: int) -> bool:
        if not self.local_global_period:
            return True
        return (i + 1) % self.local_global_period == 0

    # -- parameter counting (for MODEL_FLOPS sanity) -----------------------------
    def _attn_params(self) -> int:
        d = self.d_model
        if self.use_mla:
            q = (
                d * self.q_lora_rank
                + self.q_lora_rank
                * self.num_heads
                * (self.qk_nope_dim + self.qk_rope_dim)
                if self.q_lora_rank
                else d * self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
            )
            kv_a = d * (self.kv_lora_rank + self.qk_rope_dim)
            kv_b = (
                self.kv_lora_rank
                * self.num_heads
                * (self.qk_nope_dim + self.v_head_dim)
            )
            out = self.num_heads * self.v_head_dim * d
            return q + kv_a + kv_b + out
        q = d * self.num_heads * self.head_dim
        kv = 2 * d * self.num_kv_heads * self.head_dim
        out = self.num_heads * self.head_dim * d
        return q + kv + out

    def _ffn_params(self, hidden: int) -> int:
        mult = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
        return mult * self.d_model * hidden

    def _mamba_params(self) -> int:
        d, di, n, g = self.d_model, self.d_inner, self.ssm_state, self.ssm_groups
        in_proj = d * (2 * di + 2 * g * n + self.ssm_heads)  # z, x, B, C, dt
        conv = self.ssm_conv_width * (di + 2 * g * n)
        out_proj = di * d
        extras = self.ssm_heads * 2 + di  # A, dt_bias, (gate norm)
        return in_proj + conv + out_proj + extras

    def param_counts(self) -> dict[str, float]:
        """Returns {'total': N, 'active': N_active} (per-token active params)."""
        d = self.d_model
        embed = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        total = embed + head
        active = embed + head

        n_layers = self.num_layers
        for i in range(n_layers):
            if self.ssm:
                mix = self._mamba_params()
            else:
                mix = self._attn_params()
            total += mix
            active += mix
            if self.moe and i >= self.first_dense_layers:
                expert = self._ffn_params(self.moe_d_ff)
                total += self.num_experts * expert + self.num_shared_experts * expert
                total += d * self.num_experts  # router
                active += (
                    self.top_k + self.num_shared_experts
                ) * expert + d * self.num_experts
            elif self.d_ff and not self.ssm:
                # mamba layers have no separate FFN; for hybrids d_ff sizes
                # only the shared attention block's MLP (counted below)
                ffn = self._ffn_params(self.d_ff)
                total += ffn
                active += ffn
            total += 2 * d  # norms
            active += 2 * d

        if self.hybrid_attn_period:
            shared = self._attn_params() + self._ffn_params(self.d_ff or 4 * d)
            total += shared
            uses = n_layers // self.hybrid_attn_period
            active += shared  # params shared; active-per-token counts once

        if self.encoder_decoder:
            # encoder self-attn + ffn, decoder cross-attn already in layers
            enc = self.encoder_layers * (
                self._attn_params() + self._ffn_params(self.d_ff)
            )
            cross = self.num_layers * self._attn_params()
            total += enc + cross
            active += enc + cross

        if self.vision_prefix:
            total += self.vision_dim * d
            active += self.vision_dim * d

        if self.mtp_depth:
            mtp = self._attn_params() + (
                3 * d * self.moe_d_ff * (self.top_k + self.num_shared_experts)
                if self.moe
                else self._ffn_params(self.d_ff)
            ) + 2 * d * d  # projection
            total += mtp
            active += mtp

        return {"total": float(total), "active": float(active)}
