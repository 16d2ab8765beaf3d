"""Grok-1 — 314B MoE: 8 experts top-2, GQA kv=8.  [hf:xai-org/grok-1; unverified]"""

from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab_size=131072, head_dim=128,
    block_pattern=(("attn", "moe"),),
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=32768, impl="ep_a2a"),
)
