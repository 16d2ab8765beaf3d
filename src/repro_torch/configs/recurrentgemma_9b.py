"""RecurrentGemma-9B — hybrid RG-LRU + local attention, pattern
(recurrent, recurrent, local_attn), MQA kv=1, window 2048.
[arXiv:2402.19427; unverified]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab_size=256000, head_dim=256,
    block_pattern=(("rglru", "dense"), ("rglru", "dense"), ("local_attn", "dense")),
    window=2048,
    max_cache_len=2048,   # local window bounds the KV cache
)
