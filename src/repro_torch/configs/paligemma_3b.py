"""paligemma-3b [vlm]: SigLIP + gemma [arXiv:2407.07726; hf].
18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216.

The SigLIP frontend is a STUB per the assignment: ``input_specs()``
supplies 256 precomputed patch embeddings (B, 256, d_model); the gemma
decoder attends bidirectionally over the image prefix (prefix-LM mask) and
causally over text."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=257216,
    head_dim=256,
    mlp="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    n_img_tokens=256,
    param_dtype="bfloat16",
)
