"""Qwen1.5-0.5B — dense, GQA kv=16 (MHA), QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab_size=151936, head_dim=64,
    qkv_bias=True, rope_theta=1_000_000.0,
)
