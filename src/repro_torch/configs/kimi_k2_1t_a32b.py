"""kimi-k2-1t-a32b [moe]: trillion-param MoE (paper-table)
[arXiv:2501.kimi2; unverified].  61L d_model=7168 64H (GQA kv=8)
d_ff=2048 (per expert), vocab=163840, MoE 384 experts top-8.

~1T total / ~32B active parameters; bf16 params.  It does not fit one
80 GB card, so the port runs it in its CPU tests only, ``reduced()``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    head_dim=112,
    mlp="swiglu",
    norm="rmsnorm",
    moe=True,
    n_experts=384,
    top_k=8,
    param_dtype="bfloat16",
    remat=True,
)
