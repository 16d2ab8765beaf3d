"""Kimi-K2 — trillion-parameter MoE: 384 experts top-8 + 1 shared expert,
first layer dense, GQA kv=8.  [arXiv:2501.kimi2; unverified]"""

from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab_size=163840, head_dim=112,
    first_k_dense=1,
    block_pattern=(("attn", "moe"),),
    moe=MoEConfig(num_experts=384, top_k=8, d_expert=2048, num_shared=1,
                  impl="ep_a2a"),
)
