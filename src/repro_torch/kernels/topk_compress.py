"""Per-block magnitude top-k: the hand-written CUDA kernel and its plain version.

Replaces ``repro/kernels/topk_compress.py:topk_compress``, the Pallas TPU
kernel (each 1024-element block keeps its k largest |x| by iterated
argmax-and-clear, ties to the lowest index; returns ``vals [nb, k]`` fp32,
``idx [nb, k]`` int32 and the residual).  It compresses the state store's
delta commits: ``CheckpointManager.save_delta`` runs it on the parameter
delta on the card, where the JAX package runs ``np.argpartition`` on the
host.  The kernel is ``csrc/topk_compress.cu``; its plain PyTorch version is
``ref.topk_compress_reference``, and the two agree bit for bit.

What bounds it on the H100: bytes (x read once, the residual written once):
for llama3.2-3b's embedding delta (394 M fp32) 3.2 GB, about 0.95 ms at
3.35 TB/s.  The design: one warp per block, 32 values a lane in registers,
each round a lane max and a 5-step shuffle argmax.

``launches`` counts kernel launches; the plain path never adds to it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .ref import topk_compress_reference

BLOCK = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("topk_compress")
    fn = lib.repro_topk_compress
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_longlong, ctypes.c_int, p, p, p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib


def topk_compress(x: torch.Tensor, k: int, *, block: int = BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(vals [nb, k] fp32, idx [nb, k] int32, residual [n] in x's dtype) of a
    1-D tensor.

    CPU tensors take the plain version.  CUDA tensors launch the kernel, or
    raise when the kernel does not take them: nothing falls back.
    """
    if x.device.type == "cpu":
        return topk_compress_reference(x, k, block=block)
    if x.device.type != "cuda":
        raise ValueError(f"topk_compress: unsupported device {x.device}")
    if block != BLOCK:
        raise ValueError(f"topk_compress: the kernel takes block {BLOCK}, got {block}")
    if x.dim() != 1 or x.dtype not in _DTYPE_CODES or not x.is_contiguous():
        raise ValueError(f"topk_compress: x must be a contiguous 1-D float32 or bfloat16 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if not 1 <= k <= block:
        raise ValueError(f"topk_compress: k {k} not in [1, {block}]")
    n = x.shape[0]
    if n == 0:
        raise ValueError("topk_compress: empty input")
    nb = -(-n // block)
    vals = torch.empty((nb, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((nb, k), dtype=torch.int32, device=x.device)
    res = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().repro_topk_compress(x.data_ptr(), n, int(k), vals.data_ptr(),
                                         idx.data_ptr(), res.data_ptr(), _DTYPE_CODES[x.dtype],
                                         stream)
    if err:
        raise RuntimeError(f"topk_compress: kernel launch failed with cudaError {err}")
    global launches
    launches += 1
    return vals, idx, res
