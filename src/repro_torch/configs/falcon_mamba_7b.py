"""Falcon-Mamba-7B — pure Mamba-1 SSM (attention-free), d_state=16.
[arXiv:2410.05355; unverified]"""

from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=65024,
    block_pattern=(("mamba", "none"),),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    max_cache_len=1,      # recurrent state only; no KV cache
)
