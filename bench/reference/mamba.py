"""Plain reference of the Mamba-1 decoder as its configuration states it
(the port's block, whose departures from the published mixer the
configuration lists under ``assumed``).

A layer, with h = rmsnorm(x): [xs | z] = W_in h; xc = silu(causal depthwise
conv of xs over d_conv steps + conv_b); [dt | B | C] = W_xproj xc; delta =
softplus(W_dt dt + b_dt); A = -exp(A_log); h_t = exp(delta_t A) h_{t-1} +
delta_t xc_t B_t over a [Din, N] state from zero; y_t = C_t . h_t + D xc_t;
x + W_out (y * silu(z)).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from ..weights import Leaf
from .common import Products, rmsnorm, softplus


def _sizes(mc: Dict):
    d, ssm = mc["d_model"], mc["ssm"]
    return d, ssm["expand"] * d, ssm["d_state"], ssm["d_conv"], ssm.get("dt_rank") or -(-d // 16)


def layout(mc: Dict) -> List[Leaf]:
    """(name, shape, dtype, init, std) of every weight, in the program's
    parameter layout: a group of `n_layers` stacked layers.  ``A_log`` is
    log(1..N) on every channel and ``b_dt`` puts softplus(b_dt) log-uniform
    on [1e-3, 1e-1], Mamba's own initialisation of the two."""
    d, di, n, k, dtr = _sizes(mc)
    L, V, dt = mc["n_layers"], mc["vocab_size"], mc["dtype"]
    if L < 2:
        raise ValueError("the layout stacks the layers: n_layers >= 2")
    b = "blocks/0/l0/mixer/"
    return [
        ("embed", (V, d), dt, "normal", 1.0),
        (b + "A_log", (L, di, n), "float32", "a_log", 0.0),
        (b + "D", (L, di), "float32", "one_plus", 0.1),
        (b + "b_dt", (L, di), "float32", "dt_bias", 0.0),
        (b + "conv_b", (L, di), dt, "normal", 0.1),
        (b + "conv_w", (L, k, di), dt, "normal", k ** -0.5),
        (b + "norm", (L, d), "float32", "normal", 0.1),
        (b + "w_dt", (L, dtr, di), dt, "normal", dtr ** -0.5),
        (b + "w_in", (L, d, 2 * di), dt, "normal", d ** -0.5),
        (b + "w_out", (L, di, d), dt, "normal", di ** -0.5),
        (b + "w_xproj", (L, di, dtr + 2 * n), dt, "normal", di ** -0.5),
        ("final_norm", (d,), "float32", "normal", 0.1),
        ("lm_head", (d, V), dt, "normal", d ** -0.5),
    ]


class LinearScan(torch.autograd.Function):
    """h_t = a_t h_{t-1} + b_t from h = 0, over the first axis of a, b [S,
    ...]; its gradient by the reverse recurrence g_t = dh_t + a_{t+1} g_{t+1}."""

    @staticmethod
    def forward(ctx, a, b):
        h = torch.empty_like(b)
        h[0] = b[0]
        for t in range(1, b.shape[0]):
            torch.addcmul(b[t], a[t], h[t - 1], out=h[t])
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        g = torch.empty_like(dh)
        g[-1] = dh[-1]
        for t in range(dh.shape[0] - 2, -1, -1):
            torch.addcmul(dh[t], a[t + 1], g[t + 1], out=g[t])
        da = torch.zeros_like(a)
        da[1:] = g[1:] * h[:-1]
        return da, g


def layer(w: Dict[str, torch.Tensor], x: torch.Tensor, mc: Dict, prod: Products
          ) -> torch.Tensor:
    S = x.shape[1]
    _, di, n, k, dtr = _sizes(mc)
    h = rmsnorm(x, w["mixer/norm"], mc["norm_eps"])
    xz = prod.mm(h, w["mixer/w_in"])
    xs, z = xz[..., :di], xz[..., di:]
    full = F.pad(xs, (0, 0, k - 1, 0))
    conv = sum(full[:, i:i + S] * w["mixer/conv_w"][i] for i in range(k))
    xc = F.silu(conv + w["mixer/conv_b"])
    proj = prod.mm(xc, w["mixer/w_xproj"])
    dt_in, Bm, Cm = proj[..., :dtr], proj[..., dtr:dtr + n], proj[..., dtr + n:]
    delta = softplus(prod.mm(dt_in, w["mixer/w_dt"]) + w["mixer/b_dt"])
    A = -torch.exp(w["mixer/A_log"])
    # time-major [S, B, Din, N]: each step of the recurrence is contiguous
    a = torch.exp(delta.transpose(0, 1)[..., None] * A)
    b = (delta * xc).transpose(0, 1)[..., None] * Bm.transpose(0, 1)[:, :, None, :]
    hs = LinearScan.apply(a.contiguous(), b.contiguous())
    del a, b
    y = (hs @ Cm.transpose(0, 1)[..., None])[..., 0].transpose(0, 1) + xc * w["mixer/D"]
    return x + prod.mm(y * F.silu(z), w["mixer/w_out"])
