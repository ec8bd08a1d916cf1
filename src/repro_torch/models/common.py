"""Model configuration shared by every architecture of the zoo.

The port's copy of the reference's ``models/common.py``: one frozen
dataclass describes every architecture; family-specific fields are unused
by other families.  Configs are pure data — hashable, serializable, and
reducible to smoke size for CPU tests.

The reference's ``use_pallas`` flag is left out: in the port the device
decides, so a CUDA tensor goes through the hand-written kernels and a CPU
tensor through their plain versions (``kernels/ops.py``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

# Layer kinds used in ``block_pattern`` (heterogeneous stacks).
ATTN = "attn"            # global causal attention
LOCAL_ATTN = "local"     # sliding-window attention
RGLRU = "rglru"          # Griffin recurrent block
MLSTM = "mlstm"          # xLSTM matrix-memory block
SLSTM = "slstm"          # xLSTM scalar-memory block


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | encdec | vlm | ssm | hybrid | moe
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- attention flavour ------------------------------------------------
    pos_kind: str = "rope"           # rope | sincos | none
    scale_embed: bool = False        # multiply embeddings by sqrt(d_model)
    rope_theta: float = 10_000.0
    window: int = 0                  # sliding-window size for LOCAL_ATTN
    logit_softcap: float = 0.0       # final-logit softcap (gemma-style), 0=off
    attn_softcap: float = 0.0        # attention-logit softcap, 0=off
    parallel_block: bool = False     # cohere-style parallel attn+FFN residual

    # --- MLA (DeepSeek multi-head latent attention) -----------------------
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---------------------------------------------------------------
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0      # leading layers that use a dense FFN
    dense_d_ff: int = 0              # d_ff for those dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- heterogeneous stacks (ssm / hybrid) -------------------------------
    block_pattern: Tuple[str, ...] = ()   # repeated; remainder handled exactly
    d_rnn: int = 0                   # recurrent width (RG-LRU / xLSTM)
    conv_width: int = 4              # temporal conv width in recurrent blocks

    # --- encoder-decoder ----------------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0             # precomputed-frame count (stub frontend)

    # --- vlm ----------------------------------------------------------------
    n_img_tokens: int = 0            # precomputed-patch count (stub frontend)

    # --- plumbing -----------------------------------------------------------
    act: str = "swiglu"              # swiglu | geglu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    use_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"          # compute dtype
    param_dtype: str = "float32"     # storage dtype
    remat: str = "full"              # none | dots | full (training only)
    scan_layers: bool = True         # the reference scans layer groups

    # ------------------------------------------------------------------ api
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def store_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def pattern(self) -> Tuple[str, ...]:
        """Full per-layer kind list (length == n_layers)."""
        if not self.block_pattern:
            return (ATTN,) * self.n_layers
        reps = math.ceil(self.n_layers / len(self.block_pattern))
        return tuple((self.block_pattern * reps)[: self.n_layers])

    def layer_groups(self) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
        """Partition the stack into homogeneous repeating groups.

        Returns ((pattern, repeat), ...) with sum(len(p)*r) == n_layers and
        the original interleaving preserved.  A uniform stack yields a single
        group; recurrentgemma's 26 layers yield 8x(R,R,A) + 2x(R,).
        """
        pat = self.pattern
        if not self.block_pattern:
            return (((ATTN,), self.n_layers),)
        p = self.block_pattern
        full, rem = divmod(self.n_layers, len(p))
        groups = []
        if full:
            groups.append((p, full))
        if rem:
            groups.append((tuple(pat[len(p) * full:]), 1))
        return tuple(groups)

    def is_subquadratic(self) -> bool:
        """True when no layer requires a full-length attention cache."""
        return all(k in (RGLRU, MLSTM, SLSTM, LOCAL_ATTN)
                   for k in self.pattern)

    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive decoder

    # -------------------------------------------------------------- counts
    def param_count(self) -> int:
        """Exact parameter count of the port's ``LM.init`` (allocates
        nothing: the shapes are made on the meta device)."""
        from repro_torch.models import model as _model  # lazy, avoids cycle

        params = _model.LM(self).init(seed=0, device="meta")
        return sum(t.numel() for t in _model.tensors(params))

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top_k + shared experts);
        the dry run's 6·N·D model FLOPs of an MoE use it."""
        total = self.param_count()
        if not self.moe:
            return total
        per_expert = 3 * self.d_model * self.d_ff_expert
        n_moe_layers = self.n_layers - self.first_dense_layers
        inactive = (self.n_experts - self.top_k) * per_expert * n_moe_layers
        return total - inactive

    # -------------------------------------------------------------- smoke
    def reduced(self, **overrides: Any) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        pat = self.block_pattern
        base: Dict[str, Any] = dict(
            name=self.name + "-smoke",
            n_layers=max(2, len(pat)) if pat else 2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=257,
            window=min(self.window, 32) if self.window else 0,
            d_rnn=64 if self.d_rnn else 0,
            n_experts=min(self.n_experts, 4) if self.moe else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2) if self.moe else 0,
            d_ff_expert=64 if self.moe else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            dense_d_ff=128 if self.dense_d_ff else 0,
            kv_lora_rank=32 if self.mla else 0,
            qk_nope_dim=16 if self.mla else 0,
            qk_rope_dim=8 if self.mla else 0,
            v_head_dim=16 if self.mla else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=24 if self.encoder_seq else 0,
            n_img_tokens=8 if self.n_img_tokens else 0,
            param_dtype="float32",
            dtype="float32",
            remat="none",
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell is runnable; else the documented skip
    (the reference's words)."""
    if shape.name == "long_500k" and not cfg.is_subquadratic():
        return False, ("skip: pure full-attention arch has no sub-quadratic "
                       "mode for 524k context (see DESIGN.md)")
    return True, ""
