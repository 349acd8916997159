"""Architecture + shape-cell configuration system (the port's own copy of
``repro/configs/base.py``, value for value; it imports nothing of JAX).

One :class:`ArchConfig` per assigned architecture (exact values from the
assignment table) plus a ``reduced()`` variant for CPU smoke tests.  Shape
cells (`train_4k`, `prefill_32k`, `decode_32k`, `long_500k`) are global and
paired per-arch by :func:`cells_for`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # block pattern, cycled over layers: entries in
    # {attn, local_attn, rglru, mlstm, slstm}
    block_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0  # local-attention window (local_attn blocks)
    mlp: str = "swiglu"  # swiglu | geglu | gelu | none
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10000.0
    use_rope: bool = True
    tie_embeddings: bool = False
    qkv_bias: bool = False
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # enc-dec (audio family)
    encdec: bool = False
    enc_layers: int = 0
    # vlm
    n_img_tokens: int = 0
    # numerics / stacking
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    layer_stack: str = "scan"  # scan | unroll
    remat: bool = False
    max_seq: int = 8192  # positional table cap for learned-pos models
    # perf knobs (EXPERIMENTS §Perf hillclimbs; defaults = paper-faithful
    # GSPMD baseline)
    ctx_parallel: bool = False  # shard attention q-seq over "model" when
    #                             head count doesn't divide the axis
    scan_unroll: int = 1  # recurrent-cell scan unroll (mlstm/slstm)
    mlstm_chunk: int = 0  # chunkwise-parallel mLSTM chunk (0 = sequential)
    moe_impl: str = "gspmd"  # gspmd | ep_shard_map (explicit EP a2a-free)
    state_dtype: str = "float32"  # recurrent-state ys dtype (xlstm)
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    def block_at(self, layer: int) -> str:
        return self.block_pattern[layer % self.pattern_period]

    @property
    def sub_quadratic(self) -> bool:
        """True if no block attends globally (bounded window / recurrent
        state) -> eligible for long_500k."""
        return all(b != "attn" for b in self.block_pattern)

    def n_params(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        H, KV, hd = self.n_heads, self.n_kv_heads, self.hd
        total = V * d  # embed
        if not self.tie_embeddings:
            total += V * d
        per_layer = {}
        attn = d * H * hd + 2 * d * KV * hd + H * hd * d
        mlp_mult = {"swiglu": 3, "geglu": 3, "gelu": 2, "none": 0}[self.mlp]
        if self.moe:
            mlp_p = self.n_experts * mlp_mult * d * ff + d * self.n_experts
        else:
            mlp_p = mlp_mult * d * ff
        for b in ("attn", "local_attn"):
            per_layer[b] = attn + mlp_p + 2 * d
        per_layer["rglru"] = (2 * d * d + 3 * d + 4 * d) + mlp_p + 2 * d
        per_layer["mlstm"] = (2 * d * 2 * d + 3 * (2 * d) * (2 * d) // 4
                              + 2 * d) + 2 * d
        per_layer["slstm"] = (4 * d * d + 4 * d * d // 4
                              + 2 * d * d) + 2 * d
        for i in range(self.n_layers):
            total += per_layer[self.block_at(i)]
        if self.encdec:
            # encoder self-attn + mlp, plus decoder cross-attn already
            # counted? decoder layers counted above; add encoder stack and
            # cross-attention per decoder layer.
            total += self.enc_layers * (attn + mlp_p + 2 * d)
            total += self.n_layers * (attn + 2 * d)
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.n_params()
        d, ff = self.d_model, self.d_ff
        mlp_mult = {"swiglu": 3, "geglu": 3, "gelu": 2, "none": 0}[self.mlp]
        dense_moe = self.n_experts * mlp_mult * d * ff
        active_moe = self.top_k * mlp_mult * d * ff
        return self.n_params() - self.n_layers * (dense_moe - active_moe)

    def reduced(self) -> "ArchConfig":
        """Same family/topology, tiny: for CPU smoke tests."""
        period = self.pattern_period
        n_layers = max(2 * period, 2)
        if self.encdec:
            n_layers = max(n_layers, 2)
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            d_ff=128 if self.d_ff else 0,
            vocab_size=512,
            head_dim=16,
            window=min(self.window, 16) if self.window else 0,
            n_experts=min(self.n_experts, 4) if self.moe else 0,
            top_k=min(self.top_k, 2) if self.moe else 0,
            enc_layers=2 if self.encdec else 0,
            n_img_tokens=4 if self.n_img_tokens else 0,
            param_dtype="float32",
            compute_dtype="float32",
            layer_stack=self.layer_stack,
            max_seq=256,
        )


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cells_for(cfg: ArchConfig) -> Tuple[ShapeCell, ...]:
    """The assigned shape set for an arch.  long_500k needs sub-quadratic
    attention (skip noted in DESIGN.md for pure full-attention archs)."""
    cells = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.sub_quadratic:
        cells.append(SHAPES["long_500k"])
    return tuple(cells)
