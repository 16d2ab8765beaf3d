"""Single-token decode attention: the hand-written CUDA kernels and their plain version.

Replaces ``repro/kernels/decode_attention.py:decode_attention``, the Pallas
TPU kernel (one query per head over a KV cache with a per-sequence valid
``length``, online softmax over key blocks, GQA via KV head ``h // group``).
Its plain PyTorch version is ``ref.decode_attention_reference``.  Two kernels
take the work, by dtype alone (``_route``):

  * bf16 -> ``"mma"``, ``csrc/decode_attention_sm90.cu``: products on the
    tensor cores (``mma.sync`` m16n8k16, the up to 16 query heads of a KV
    group as its rows), K/V kept bf16 in a three-stage ``cp.async`` ring, P
    rounded to bf16 before P V as in the bf16 flash kernels;
  * fp32 -> ``"cuda_core"``, ``csrc/decode_attention.cu``: fp32 tiles and
    products on CUDA cores (the tensor cores' fp32 is TF32, which the fp32
    tolerance of 2e-5 rules out).

Nothing falls back from one route to the other.

What bounds it on the H100: bytes.  At the serving decode shape
(llama3.2-3b, B=4, 8 KV heads, length ~1024-1056, D=128, bf16) one launch
reads ~17 MB of live K/V, about 5 us at 3.35 TB/s, and does ~1 FLOP per
byte.  The bf16 kernel's split pass runs ``n_split`` blocks per (KV head,
batch row), ``n_split`` chosen from ``B * Hkv`` and the SM count (never from
``S`` or ``length``), so that the grid fills the SMs in one wave; each block
takes its even share of the live keys, read from ``length`` on the card.
The fp32 kernel splits by 256-key chunks of ``S`` and returns at once past
``length``.  Both merge the splits in a second kernel: one call is two
kernel launches and counts as one.  A row with ``length`` 0 gives 0, as the
Pallas kernel does (the plain version then averages the whole cache).

``launches`` counts kernel launches, ``launches_by_route`` the same launches
by route; the plain path never adds to either.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .ref import decode_attention_reference

HEAD_DIMS = (32, 64, 112, 128, 160, 256)
ROUTES = ("mma", "cuda_core")
GROUP_ROWS = 16  # query heads a split block of the "mma" kernel serves: mma's M
MAX_BLOCKS_PER_SM = 4

launches = 0
launches_by_route = dict.fromkeys(ROUTES, 0)
_BLOCKS_PER_SM = {}  # (device index, head_dim) -> resident split blocks an SM


def _route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes (dtype, head_dim): "mma" for bf16, "cuda_core"
    for fp32; raises for anything else."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {head_dim} not in {HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "mma"
    if dtype == torch.float32:
        return "cuda_core"
    raise ValueError(f"decode_attention: dtypes {dtype}; float32 or bfloat16, all the same")


def _lib(route: str) -> ctypes.CDLL:
    """The library of `route`, its entry points' argument types set."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if route == "mma":
        lib = _build.load("decode_attention_sm90")
        if lib.repro_decode_attention_sm90.argtypes is None:
            lib.repro_decode_attention_sm90.argtypes = [p] * 7 + [i] * 6 + [f, p]
            lib.repro_decode_attention_sm90.restype = ctypes.c_int
            lib.repro_decode_sm90_blocks_per_sm.argtypes = [i]
            lib.repro_decode_sm90_blocks_per_sm.restype = ctypes.c_int
        return lib
    lib = _build.load("decode_attention")
    if lib.repro_decode_attention.argtypes is None:
        lib.repro_decode_attention.argtypes = [p] * 7 + [i] * 7 + [f, p]
        lib.repro_decode_attention.restype = ctypes.c_int
        lib.repro_decode_chunk.argtypes = []
        lib.repro_decode_chunk.restype = ctypes.c_int
    return lib


def n_split(batch: int, hq: int, hkv: int, head_dim: int, device: torch.device) -> int:
    """Split blocks per (KV head, row group, batch row) of the "mma" kernel:
    as many as fill the SMs' resident blocks (at most MAX_BLOCKS_PER_SM an
    SM) in one wave, and no more, so no block waits for a second wave.  From
    the shapes and the card alone, never from the cache length or
    ``length``."""
    key = (device.index, head_dim)
    if key not in _BLOCKS_PER_SM:
        per_sm = _lib("mma").repro_decode_sm90_blocks_per_sm(head_dim)
        if per_sm < 1:
            raise RuntimeError(f"decode_attention: no split block of head_dim {head_dim} "
                               "fits an SM")
        _BLOCKS_PER_SM[key] = min(per_sm, MAX_BLOCKS_PER_SM)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = batch * hkv * -(-(hq // hkv) // GROUP_ROWS)
    return max(1, _BLOCKS_PER_SM[key] * sms // rows)


def decode_attention(
    q: torch.Tensor,  # [B, Hq, D]
    k: torch.Tensor,  # [B, Hkv, S, D]
    v: torch.Tensor,  # [B, Hkv, S, D]
    *,
    length: Optional[torch.Tensor] = None,  # [B] int32 valid lengths
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
):
    """One query per head over the first `length[b]` keys; output [B, Hq, D].

    With `return_lse`, returns (out, lse [B, Hq] fp32), the log-sum-exp of
    each row's scaled live logits (-inf for a row with no live key): the
    kernel is the same, and `_lse` folds the per-split maxima and sums it
    writes to its scratch, in PyTorch, after the launch.

    CPU tensors take the plain version.  CUDA tensors launch the kernel, or
    raise when the kernel does not take them: nothing falls back.
    """
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, sm_scale=sm_scale, length=length,
                                          return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    b, hq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    hkv, s = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"decode_attention: {hq} query heads are not a multiple of {hkv} KV heads")
    route = _route(q.dtype, d)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         "float32 or bfloat16, all the same")
    if length is None:
        length = torch.full((b,), s, dtype=torch.int32, device=q.device)
    if length.dtype != torch.int32 or tuple(length.shape) != (b,):
        raise ValueError(f"decode_attention: length must be int32 [{b}], got "
                         f"{length.dtype} {tuple(length.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("length", length)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous and 16-byte aligned")
    if s == 0:
        raise ValueError("decode_attention: empty KV cache")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return (out, torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)) \
            if return_lse else out
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)
    with torch.cuda.device(q.device):
        lib = _lib(route)
        splits = (n_split(b, hq, hkv, d, q.device) if route == "mma"
                  else -(-s // lib.repro_decode_chunk()))
        part_ml = torch.empty((b, hq, splits, 2), dtype=torch.float32, device=q.device)
        part_acc = torch.empty((b, hq, splits, d), dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(), out.data_ptr(),
                part_ml.data_ptr(), part_acc.data_ptr())
        if route == "mma":
            err = lib.repro_decode_attention_sm90(*ptrs, b, hq, hkv, s, d, splits, scale, stream)
        else:  # the CUDA-core kernel: dtype code 0 = float32
            err = lib.repro_decode_attention(*ptrs, 0, b, hq, hkv, s, d, splits, scale, stream)
    if err:
        raise RuntimeError(f"decode_attention: {route} kernel launch failed with cudaError {err}")
    global launches
    launches += 1
    launches_by_route[route] += 1
    if return_lse:
        chunk = None if route == "mma" else lib.repro_decode_chunk()
        return out, _lse(part_ml, route, length, chunk)
    return out


def _lse(part_ml: torch.Tensor, route: str, length: torch.Tensor,
         chunk: Optional[int]) -> torch.Tensor:
    """[B, Hq] log-sum-exp of the live logits from the split pass's scratch
    part_ml [B, Hq, splits, 2] = (running max, sum of exponentials): the
    "mma" kernel keeps maxima in the log2 domain and marks an empty split by
    a zero sum; the "cuda_core" one keeps natural maxima and writes only the
    chunks below ceil(length / chunk)."""
    m, l = part_ml[..., 0], part_ml[..., 1]
    if route == "mma":
        live = l > 0
    else:
        n_live = (length.clamp(min=0).to(torch.int64) + chunk - 1) // chunk
        live = (torch.arange(m.shape[-1], device=m.device)[None, None, :]
                < n_live[:, None, None])
    m = torch.where(live, m, torch.full_like(m, -math.inf))
    mx = m.amax(dim=-1, keepdim=True)
    safe = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    w = torch.where(live, torch.exp2(m - safe) if route == "mma" else torch.exp(m - safe),
                    torch.zeros_like(m))
    total = (torch.where(live, l, torch.zeros_like(l)) * w).sum(-1)
    mx = mx[..., 0]
    if route == "mma":  # log2 domain -> natural
        return (mx + torch.log2(total)) * math.log(2.0)
    return mx + torch.log(total)
