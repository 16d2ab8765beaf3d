"""Architecture registry: one module per assigned architecture.

``get_config(arch_id)`` returns the full published config;
``get_smoke_config(arch_id)`` a reduced same-family config for CPU tests.
``SHAPES`` maps shape ids to (seq_len, global_batch, kind).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

from ..models.config import ModelConfig, reduce_for_smoke

ARCHS = (
    "qwen1.5-0.5b",
    "llama3.2-3b",
    "deepseek-7b",
    "stablelm-12b",
    "recurrentgemma-9b",
    "musicgen-large",
    "falcon-mamba-7b",
    "kimi-k2-1t-a32b",
    "grok-1-314b",
    "llava-next-34b",
)

_MODULES = {
    "qwen1.5-0.5b": "qwen15_05b",
    "llama3.2-3b": "llama32_3b",
    "deepseek-7b": "deepseek_7b",
    "stablelm-12b": "stablelm_12b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "musicgen-large": "musicgen_large",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "grok-1-314b": "grok_1_314b",
    "llava-next-34b": "llava_next_34b",
}

#: shape id -> (seq_len, global_batch, kind); kind: train | prefill | decode
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

#: archs whose mixers are sub-quadratic (run long_500k); all others skip it.
SUBQUADRATIC = ("recurrentgemma-9b", "falcon-mamba-7b")


def shape_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in SUBQUADRATIC
    return True


def get_config(arch: str, **overrides) -> ModelConfig:
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    cfg: ModelConfig = mod.CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    return reduce_for_smoke(get_config(arch), **overrides)
