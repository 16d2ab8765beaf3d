"""Model zoo: the dense DecoderLM of the JAX package, in PyTorch."""

from .config import ModelConfig, MoEConfig, SSMConfig, reduce_for_smoke
from .model import DecoderLM
from .params import ParamSpec, abstract_params, init_params, param_count

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "DecoderLM",
    "ParamSpec",
    "init_params",
    "abstract_params",
    "param_count",
    "reduce_for_smoke",
]
