"""granite-moe-3b-a800m [moe] [hf:ibm-granite/granite-3.0-3b-a800m-base; hf].
32L d_model=1536 24H (GQA kv=8) d_ff=512 (per expert), vocab=49155,
MoE 40 experts top-8."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    mlp="swiglu",
    norm="rmsnorm",
    moe=True,
    n_experts=40,
    top_k=8,
    tie_embeddings=True,
)
