"""Model configuration for the decoder-LM family (all 10 assigned archs).

Field for field the same as ``repro.models.config``; ``jnp_dtype`` becomes
``torch_dtype``.  ``attn_impl`` selects the attention implementation:
``"auto"`` (the CUDA kernels for CUDA tensors, the plain PyTorch versions
for CPU tensors), ``"cuda"`` or ``"torch"`` (see ``kernels/ops.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # ffn hidden per expert
    num_shared: int = 0           # always-on shared experts (DeepSeek/Kimi style)
    capacity_factor: float = 1.25
    impl: str = "dense"           # dense | ep_a2a


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2               # d_inner = expand * d_model
    dt_rank: int = 0              # 0 -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                         # 0 -> d_model // n_heads
    # layer pattern: cycled (mixer, ffn) kinds after `first_k_dense` layers
    block_pattern: Tuple[Tuple[str, str], ...] = (("attn", "dense"),)
    first_k_dense: int = 0                    # leading ("attn","dense") layers
    window: Optional[int] = None              # local-attention window
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_inputs: bool = True                 # False: frontend stub provides embeddings
    dtype: str = "bfloat16"
    # runtime knobs
    remat: str = "none"                       # none | dots | save_dots | other: full
    scan_layers: bool = True
    attn_impl: str = "auto"                   # auto | cuda | torch
    attn_block_k: int = 512
    fsdp: bool = False
    max_cache_len: int = 32768
    pad_heads: int = 0                        # extra (dead) heads to align TP
    scan_bf16: bool = False                   # bf16 linear-scan fallback

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_heads_eff(self) -> int:
        return self.n_heads + self.pad_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def layer_kinds(self) -> Tuple[Tuple[str, str], ...]:
        kinds = [("attn", "dense")] * self.first_k_dense
        i = 0
        while len(kinds) < self.n_layers:
            kinds.append(self.block_pattern[i % len(self.block_pattern)])
            i += 1
        return tuple(kinds)

    def param_bytes_per_token_flops(self):  # convenience for roofline
        return None


def reduce_for_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, num_experts=min(moe.num_experts, 8), top_k=min(moe.top_k, 2),
            d_expert=64, num_shared=min(moe.num_shared, 1), impl="dense",
        )
    ssm = cfg.ssm
    if ssm is not None:
        ssm = dataclasses.replace(ssm, d_state=8)
    n_layers = max(2, 2 * len(cfg.block_pattern)) + cfg.first_k_dense
    kw = dict(
        n_layers=min(cfg.n_layers, n_layers),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        moe=moe,
        ssm=ssm,
        window=min(cfg.window, 64) if cfg.window else None,
        max_cache_len=128,
        scan_layers=cfg.scan_layers,
    )
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)
