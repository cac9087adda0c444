"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Counterpart of the reference package's ``models/rglru.py``.  The
real-gated linear recurrent unit:

    r_t = sigmoid(W_a x_t),  i_t = sigmoid(W_x x_t)
    a_t = a^{c * r_t}            (a = sigmoid(Lambda), elementwise, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the recurrence as a log-depth (Hillis-Steele) scan over the
sequence, the reference's ``associative_scan`` combine in another tree:
ceil(log2 S) doubling steps.  Decode keeps O(1) state per channel.

Block layout (Griffin): linear in-projection and a GELU gate branch, a
short causal conv1d, the RG-LRU, and the gated output projection.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import IN_OUT, NORMAL, ONES, OUT_IN, ZEROS, param


class RGLRU(nn.Module):
    """``w_in``, ``w_gate_branch``, ``w_a``, ``w_i``, ``w_out`` (d, d);
    ``conv_w`` (W, d), ``conv_b`` (d,), ``lam`` (d,)."""

    INIT = {"w_in": NORMAL, "w_gate_branch": NORMAL, "conv_w": NORMAL,
            "conv_b": ZEROS, "w_a": NORMAL, "w_i": NORMAL, "lam": ONES,
            "w_out": NORMAL}
    AXES = {"w_in": IN_OUT, "w_gate_branch": IN_OUT,
            "conv_w": (None, "tensor"), "conv_b": ("tensor",),
            "w_a": IN_OUT, "w_i": IN_OUT, "lam": ("tensor",),
            "w_out": OUT_IN}

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.w_in = param((d, d), dtype, device)
        self.w_gate_branch = param((d, d), dtype, device)
        self.conv_w = param((cfg.conv1d_width, d), dtype, device)
        self.conv_b = param((d,), dtype, device)
        self.w_a = param((d, d), dtype, device)
        self.w_i = param((d, d), dtype, device)
        self.lam = param((d,), dtype, device)
        self.w_out = param((d, d), dtype, device)


def _gates(p: RGLRU, cfg, x):
    """x (..., d) -> (log_a (..., d), gated input (..., d)), both f32."""
    r = torch.sigmoid((x @ p.w_a).to(torch.float32))
    i = torch.sigmoid((x @ p.w_i).to(torch.float32))
    log_a_base = F.logsigmoid(8.0 * p.lam.to(torch.float32))
    log_a = cfg.rglru_c * r * log_a_base          # (..., d), <= 0
    a2 = torch.exp(2.0 * log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * i \
        * x.to(torch.float32)
    return log_a, gated


def _causal_conv(p: RGLRU, cfg, x, state=None):
    """Short depthwise causal conv.  x (B, S, d); ``state`` (B, W-1, d)
    holds the previous inputs for decode.  The taps are summed left to
    right from 0, as the reference's ``sum`` does."""
    w = cfg.conv1d_width
    if state is None:
        state = x.new_zeros(x.shape[:1] + (w - 1,) + x.shape[2:])
    xp = torch.cat([state.to(x.dtype), x], 1)
    out = 0
    for i in range(w):
        out = out + xp[:, i:xp.shape[1] - (w - 1 - i)] * p.conv_w[i]
    return out + p.conv_b, xp[:, -(w - 1):]


def _scan(log_a, u):
    """Inclusive scan of h_t = exp(log_a_t) h_{t-1} + u_t along axis 1,
    h_{-1} = 0: log2 doubling steps of the combine (la1 + la2, u1
    exp(la2) + u2), the earlier element first."""
    s = log_a.shape[1]
    off = 1
    while off < s:
        la_prev, u_prev = log_a[:, :-off], u[:, :-off]
        la_cur, u_cur = log_a[:, off:], u[:, off:]
        u = torch.cat([u[:, :off], u_prev * torch.exp(la_cur) + u_cur], 1)
        log_a = torch.cat([log_a[:, :off], la_prev + la_cur], 1)
        off *= 2
    return u


def run_rglru(p: RGLRU, cfg, x, *, state=None):
    """Full-sequence pass.  x (B, S, d) -> ((B, S, d), (h (B, d) f32,
    conv state (B, W-1, d))).  ``state``: an optional (h0, conv state)
    to resume from."""
    gate_branch = F.gelu(x @ p.w_gate_branch, approximate="tanh")
    y = x @ p.w_in
    h0, conv_state = state if state is not None else (None, None)
    y, conv_state = _causal_conv(p, cfg, y, conv_state)
    log_a, gated = _gates(p, cfg, y)
    if h0 is not None:
        gated = gated.clone()
        gated[:, 0] += torch.exp(log_a[:, 0]) * h0
    h = _scan(log_a, gated)
    out = (h.to(x.dtype) * gate_branch) @ p.w_out
    return out, (h[:, -1], conv_state)


def run_rglru_decode(p: RGLRU, cfg, x, state):
    """One token.  x (B, 1, d); state = (h (B, d) f32, conv (B, W-1, d))."""
    h, conv_state = state
    gate_branch = F.gelu(x @ p.w_gate_branch, approximate="tanh")
    y = x @ p.w_in
    y, conv_state = _causal_conv(p, cfg, y, conv_state)
    log_a, gated = _gates(p, cfg, y)
    h_new = torch.exp(log_a[:, 0]) * h + gated[:, 0]
    out = (h_new[:, None].to(x.dtype) * gate_branch) @ p.w_out
    return out, (h_new, conv_state)
