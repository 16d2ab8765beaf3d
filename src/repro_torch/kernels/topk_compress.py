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
3.35 TB/s.  The design (``csrc/topk_compress.cu``): one warp per block,
loaded 16 bytes a lane into shared memory; tau, the ``min(k + 1, 32)``-th
largest of the 32 lane maxes, bounds the kept magnitudes from below; the
entries above tau are compacted by ballot (at most ``CAP``), sorted by a warp
bitonic sort, and followed, when fewer than k, by the lowest-index entries
equal to tau.  k > ``FAST_K``, or more than ``CAP`` entries above tau, take
the TPU kernel's k rounds of argmax-and-clear in the same kernel.
With ``paths=True`` the kernel also returns which blocks took them;
``fallback_blocks`` is the same decision in plain PyTorch (the CPU's answer,
held against the kernel's on the card; ``tests/test_torch_topk_plan.py``
models the rest of the selection on it).

``launches`` counts kernel launches; the plain path never adds to it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .ref import topk_compress_reference

# The selection's constants, the kernel's own (checked against the library
# at load)
BLOCK = 1024
FAST_K = 32   # the largest k the selection takes without the rounds
CAP = 64      # the candidates above tau it keeps
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("topk_compress")
    fn = lib.repro_topk_compress
    if fn.argtypes is None:
        layout = tuple(lib.repro_topk_compress_layout(w) for w in range(3))
        if layout != (BLOCK, FAST_K, CAP):
            raise RuntimeError(f"topk_compress: the library's (BLOCK, FAST_K, CAP) are "
                               f"{layout}, the wrapper's {(BLOCK, FAST_K, CAP)}")
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_longlong, ctypes.c_int, p, p, p, p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib


def topk_compress(x: torch.Tensor, k: int, *, block: int = BLOCK, paths: bool = False
                  ) -> Tuple[torch.Tensor, ...]:
    """(vals [nb, k] fp32, idx [nb, k] int32, residual [n] in x's dtype) of a
    1-D tensor; with `paths`, also [nb] bool, True where a block took the
    rounds (the kernel's record; on the CPU, ``fallback_blocks``).

    CPU tensors take the plain version.  CUDA tensors launch the kernel, or
    raise when the kernel does not take them: nothing falls back.
    """
    if x.device.type == "cpu":
        out = topk_compress_reference(x, k, block=block)
        return (*out, fallback_blocks(x, k, block=block)) if paths else out
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
    path = torch.empty((nb,), dtype=torch.bool, device=x.device) if paths else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().repro_topk_compress(x.data_ptr(), n, int(k), vals.data_ptr(),
                                         idx.data_ptr(), res.data_ptr(),
                                         path.data_ptr() if paths else None,
                                         _DTYPE_CODES[x.dtype], stream)
    if err:
        raise RuntimeError(f"topk_compress: kernel launch failed with cudaError {err}")
    global launches
    launches += 1
    return (vals, idx, res, path) if paths else (vals, idx, res)


def _tau(x: torch.Tensor, k: int, block: int):
    """(x in blocks [nb, block], magnitudes [nb, block] int32, tau [nb, 1]) of
    the kernel's selection: magnitudes are the bits of |x| widened to fp32,
    as the kernel compares them; tau is the ``min(k + 1, 32)``-th largest of
    the lane maxes, lane ``(p // VEC) % 32`` holding element p (VEC = 16
    bytes of x's type)."""
    vec = 16 // x.element_size()
    xb = torch.nn.functional.pad(x, (0, (-x.shape[0]) % block)).view(-1, block)
    mag = xb.float().view(torch.int32) & 0x7FFFFFFF
    lane_max = mag.view(xb.shape[0], block // (32 * vec), 32, vec).amax(dim=(1, 3))
    kt = min(k + 1, 32)
    return xb, mag, lane_max.sort(dim=1, descending=True).values[:, kt - 1:kt]


def fallback_blocks(x: torch.Tensor, k: int, *, block: int = BLOCK) -> torch.Tensor:
    """[nb] bool: the blocks the kernel gives to the rounds (k > FAST_K, or
    more than CAP entries above tau)."""
    if k > FAST_K:
        return torch.ones((-(-x.shape[0] // block),), dtype=torch.bool, device=x.device)
    _, mag, tau = _tau(x, k, block)
    return (mag > tau).sum(1) > CAP
