"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1:2 ratio
[arXiv:2402.19427; hf].  26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000.  Pattern period 3 = (rglru, rglru, local_attn); 26 layers =
8 full groups + 2 remainder rglru layers.  Sub-quadratic (bounded window +
recurrent state) -> runs long_500k."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    block_pattern=("rglru", "rglru", "local_attn"),
    window=2048,
    mlp="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    param_dtype="bfloat16",
    notes="RG-LRU recurrence via associative scan; local attn window 2048",
)
