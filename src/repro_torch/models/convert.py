"""Weights carried across packages.

The port's parameter names and shapes equal the JAX package's
``flatten_named(model.abstract())`` (``blocks/0/l0/mixer/wq``, ...), so a
dict of numpy arrays keyed by those names moves weights either way.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..tree import dtype_name, flatten_named, from_numpy, to_numpy, tree_map_named
from .params import ParamSpec


def params_from_numpy(named: Dict[str, np.ndarray], model, device) -> dict:
    """Builds the port's params for `model` from numpy arrays keyed by the
    JAX names, bf16 included (``ml_dtypes`` arrays or uint16 bits).  Every
    name of the model must be present with its shape and dtype."""
    def one(name: str, spec: ParamSpec) -> torch.Tensor:
        if name not in named:
            raise KeyError(f"missing parameter {name}")
        want = str(spec.dtype).replace("torch.", "")
        arr = named[name]
        t = from_numpy(arr, want if want == "bfloat16" else None)
        if tuple(t.shape) != tuple(spec.shape) or t.dtype != spec.dtype:
            raise ValueError(f"{name}: got {tuple(t.shape)} {dtype_name(arr)}, "
                             f"want {tuple(spec.shape)} {want}")
        return t.to(device)

    return tree_map_named(one, model.param_specs(), is_leaf=lambda x: isinstance(x, ParamSpec))


def params_to_numpy(params) -> Dict[str, np.ndarray]:
    """{JAX name: numpy array}; bfloat16 tensors as their uint16 bits."""
    return {name: to_numpy(t) for name, t in flatten_named(params)}
