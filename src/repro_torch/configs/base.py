"""Model / shape configuration system (a copy of ``repro.configs.base``;
pure Python, so the port keeps its own).

One ``ModelConfig`` dataclass covers all six assigned families
(dense / moe / ssm / vlm / audio / hybrid); per-arch modules under
``repro_torch.configs`` instantiate the exact published hyperparameters and a
``reduced()`` variant for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | vlm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads

    # --- block flavour -------------------------------------------------------
    mlp_type: str = "swiglu"         # swiglu | geglu | none
    qkv_bias: bool = False
    block_pattern: str = "attention" # attention | xlstm | zamba_hybrid
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE -----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False # arctic: dense FFN ∥ MoE branch
    capacity_factor: float = 1.25

    # --- SSM / hybrid ---------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    shared_attn_every: int = 6       # zamba: shared attn block cadence
    slstm_every: int = 4             # xlstm: sLSTM block cadence (rest mLSTM)

    # --- encoder-decoder -------------------------------------------------------
    encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # --- modality stubs ---------------------------------------------------------
    modality: str = "text"           # text | vision_stub | audio_stub
    n_prefix_tokens: int = 0         # precomputed patch/frame embeddings length

    # --- numerics / training -----------------------------------------------------
    dtype: str = "bfloat16"
    params_dtype: str = "float32"    # master copy; "bfloat16" for huge MoE
    remat: str = "full"              # none | full | dots
    attention_impl: str = "reference"  # reference | blocked | flash
    optimizer: str = "adamw"         # adamw | adafactor
    scan_layers: bool = True
    #: Megatron-style sequence parallelism: the residual stream between
    #: blocks is sharded over the model axis on the sequence dim, turning
    #: per-block activation all-reduces into reduce-scatter/all-gather pairs
    #: (half the link bytes) and shrinking resident activations TP-fold.
    sequence_parallel: bool = False
    #: Tensor-parallel attention.  False replicates the (small) attention
    #: weights and computes attention purely data-parallel — the right call
    #: when n_heads doesn't divide the TP degree (GSPMD pads 8→16 heads on
    #: gemma: 2x attention waste + per-layer gathers) and attn params are
    #: a small fraction of the model.
    attn_tp: bool = True
    #: decode KV cache layout: "stacked" (one (L,B,S,G,hd) array — required
    #: by the scanned decode path) or "per_layer" (L separate buffers —
    #: serving mode: in-place DUS aliasing is trivially provable per buffer;
    #: implies scan_layers=False for decode).  See EXPERIMENTS.md §Perf E.
    decode_cache_layout: str = "stacked"

    # -------------------------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        """Embedding/LM-head table size: vocab rounded up to a multiple of
        256 so the vocab axis shards evenly on any mesh (MaxText-style).
        Logits for pad ids train toward -inf; decode slices them off."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else d * self.vocab_size
        per_layer = 0
        if self.block_pattern == "attention" or self.family in ("vlm", "audio"):
            attn = d * n_q + 2 * d * n_kv + n_q * d
            per_layer += attn + 2 * d  # norms
            if self.mlp_type in ("swiglu", "geglu"):
                per_layer += 3 * d * self.d_ff
            if self.is_moe:
                per_layer += d * self.n_experts + self.n_experts * 3 * d * self.d_ff
                if self.moe_dense_residual:
                    per_layer += 3 * d * self.d_ff
        elif self.block_pattern == "xlstm":
            di = self.ssm_expand * d
            per_layer += 4 * d * di + 2 * d  # rough: in/out proj + gates
        elif self.block_pattern == "zamba_hybrid":
            di = self.ssm_expand * d
            nh = di // self.ssm_head_dim
            per_layer += d * (2 * di + 2 * self.ssm_state + nh) + di * d + 2 * d
        total = emb + head + self.n_layers * per_layer
        if self.encoder_decoder:
            attn = d * n_q + 2 * d * n_kv + n_q * d
            enc_layer = attn + 3 * d * self.d_ff + 2 * d
            dec_cross = attn + d
            total += self.n_encoder_layers * enc_layer + self.n_layers * dec_cross
        if self.block_pattern == "zamba_hybrid":
            # one shared attention+mlp block
            total += d * n_q * 2 + 2 * d * n_kv + 3 * d * self.d_ff
        return int(total)

    def active_param_count(self) -> int:
        """MoE: parameters touched per token (6·N_active·D roofline term)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        all_experts = self.n_layers * self.n_experts * 3 * d * self.d_ff
        active = self.n_layers * self.top_k * 3 * d * self.d_ff
        return int(full - all_experts + active)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

#: archs with sub-quadratic token mixing — the only ones that run long_500k.
SUBQUADRATIC = ("ssm", "hybrid")


def applicable_shapes(cfg: ModelConfig) -> List[Tuple[ShapeConfig, Optional[str]]]:
    """(shape, skip_reason) for all four shapes; skip_reason=None → run."""
    out: List[Tuple[ShapeConfig, Optional[str]]] = []
    for s in SHAPES.values():
        reason = None
        if s.name == "long_500k" and cfg.family not in SUBQUADRATIC:
            reason = (
                "pure full-attention arch: 524k dense-KV decode is the "
                "quadratic regime long_500k excludes (DESIGN.md §6)"
            )
        out.append((s, reason))
    return out
