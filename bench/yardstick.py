"""The benchmark's yardstick: the card's published peaks, the least time a
piece of work can take on it, and the operations and bytes of the model
and of the kernels whose share of their roofline the benchmark reports.

Every count here comes from shapes the benchmark itself states (the
configuration's sizes and the traffic's batch and lengths), never from the
program: a later change to the program cannot move it.  The peaks and the
bound are a frozen copy of ``chip_smoke.bound`` (NVIDIA's H100 SXM data
sheet, dense rates, 700 W).
"""

from __future__ import annotations

from typing import Dict

HBM_BYTES_PER_S = 3.35e12                                  # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}        # dense; fp32 off the tensor cores
SFU_EXP_PER_S = 132 * 16 * 1.98e9   # exponentials: 16 an SM a clock, 132 SMs, 1.98 GHz boost
BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16", exps: float = 0.0) -> float:
    """The least seconds the card can take: the largest of bytes over the
    memory rate, operations over the peak of `dtype`, and exponentials over
    the special-function units' rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype], exps / SFU_EXP_PER_S)


# ----------------------------------------------------------------- the model
def matrix_params(model: Dict) -> Dict[str, int]:
    """Elements of the products' weights: {"blocks": all layers', "head":
    the output head's}.  The embedding is a lookup and counts in neither."""
    d, L = model["d_model"], model["n_layers"]
    kind = model["block_pattern"][0][0] if model.get("block_pattern") else "attn"
    if kind == "mamba":
        ssm = model["ssm"]
        di, n = ssm["expand"] * d, ssm["d_state"]
        dtr = ssm.get("dt_rank") or -(-d // 16)
        layer = d * 2 * di + di * (dtr + 2 * n) + dtr * di + di * d
    else:
        hd = model.get("head_dim") or d // model["n_heads"]
        h, hkv = model["n_heads"], model["n_kv_heads"]
        layer = d * (2 * h + 2 * hkv) * hd + 3 * d * model["d_ff"]
    return {"blocks": L * layer, "head": d * model["vocab_size"]}


def attention_pairs(seq: int) -> int:
    """(query, key) pairs a causal attention over `seq` positions scores."""
    return seq * (seq + 1) // 2


def mixer_flops(model: Dict, batch: int, seq: int) -> float:
    """Operations of one forward's sequence mixing beyond the weight
    products, all layers: causal attention's two products (QK^T and PV),
    or the selective scan's multiply-adds (h = a h + b, y = C h: 4 an
    element of the [B, S, Din, N] state, and its exponential counted as one)."""
    d, L = model["d_model"], model["n_layers"]
    kind = model["block_pattern"][0][0] if model.get("block_pattern") else "attn"
    if kind == "mamba":
        ssm = model["ssm"]
        return L * 5.0 * batch * seq * ssm["expand"] * d * ssm["d_state"]
    hd = model.get("head_dim") or d // model["n_heads"]
    return L * 4.0 * batch * model["n_heads"] * hd * attention_pairs(seq)


def train_step_flops(model: Dict, batch: int, seq: int) -> float:
    """A training step's model operations: 6 a matrix parameter a token
    (forward, and the backward's two products), head included, plus three
    times the forward's sequence mixing.  Nothing recomputed is counted."""
    mp = matrix_params(model)
    return 6.0 * (mp["blocks"] + mp["head"]) * batch * seq + 3.0 * mixer_flops(model, batch, seq)


def prefill_flops(model: Dict, batch: int, seq: int) -> float:
    """A prefill's model operations: 2 a block matrix parameter a prompt
    token, the causal attention, and the head at the one position whose
    logits each request needs."""
    mp = matrix_params(model)
    return (2.0 * mp["blocks"] * batch * seq + mixer_flops(model, batch, seq)
            + 2.0 * mp["head"] * batch)


# --------------------------------------------------------------- the kernels
def flash_forward(b: int, hq: int, hkv: int, seq: int, d: int) -> Dict[str, float]:
    """Causal flash attention's forward, bf16: QK^T and PV over the causal
    pairs; q, k, v read once, o written once."""
    flops = 4.0 * b * hq * d * attention_pairs(seq)
    nbytes = 2.0 * (2 * b * hq * seq * d + 2 * b * hkv * seq * d)
    return {"flops": flops, "bytes": nbytes}


def flash_backward(b: int, hq: int, hkv: int, seq: int, d: int) -> Dict[str, float]:
    """Causal flash attention's backward, bf16: five products over the
    causal pairs (QK^T again, dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T
    Q); q, k, v, o, dO and the fp32 log-sum-exp read once, dq, dk, dv
    written once."""
    flops = 10.0 * b * hq * d * attention_pairs(seq)
    q_like, kv_like = b * hq * seq * d, b * hkv * seq * d
    nbytes = 2.0 * (3 * q_like + 2 * kv_like) + 4.0 * b * hq * seq + 2.0 * (q_like + 2 * kv_like)
    return {"flops": flops, "bytes": nbytes}


def mamba_scan_backward(b: int, seq: int, din: int, n: int) -> Dict[str, float]:
    """The selective scan's reverse scan, counted by the function's own
    inputs and outputs alone (whatever a design keeps of its forward is its
    own cost): x, dy, B, C (bf16), delta, A and D (fp32) read once; dx, dB,
    dC (bf16), ddelta, dA and dD (fp32) written once; the scan starts from
    a zero state, so no state goes in or out; one exponential an element of
    the [B, S, Din, N] state."""
    reads = 2 * (2 * b * seq * din + 2 * b * seq * n) + 4 * (b * seq * din + din * n + din)
    writes = 2 * (b * seq * din + 2 * b * seq * n) + 4 * (b * seq * din + din * n + din)
    return {"bytes": float(reads + writes), "exps": float(b * seq * din * n), "flops": 0.0}
