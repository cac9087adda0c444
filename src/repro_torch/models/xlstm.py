"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, chunkwise
parallel) and sLSTM (scalar memory, a sequential loop over time).

Counterpart of the reference package's ``models/xlstm.py``.  The mLSTM
prefill is chunkwise: within a chunk the stabilised decay matrix,
computed in log space,

    F_t = sum_{j<=t} log sigmoid(f_j);  D_{t,j} = F_t - F_j + log i_j (j <= t)
    m_t = max(max_j D_{t,j}, m_prev + F_t);  h_t = (W (q k^T) v)_t / n_t

and across chunks the recurrent state (C (B,H,Dk,Dv), n (B,H,Dk),
m (B,H)), which is also the decode state.  The masked entries of D are
-inf and the initial m is -1e30: both reach ``exp`` only as exp(-inf) or
exp(-huge), which are 0, never NaN.

The sLSTM is a Python loop over time steps, the reference's ``lax.scan``
(no capture: each step is a few eager ops).  d_ff = 0: the blocks carry
their own up and down projections.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..launch.scan_registry import tag_scope
from .layers import IN_OUT, NORMAL, OUT_IN, param


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """``w_up``/``w_skip_gate`` (d, 2d); ``wq``/``wk``/``wv`` (2d, d);
    ``w_if`` (2d, 2H), drawn at std 0.02; ``w_o`` (d, d)."""

    INIT = {"w_up": NORMAL, "w_skip_gate": NORMAL, "wq": NORMAL,
            "wk": NORMAL, "wv": NORMAL, "w_if": ("normal", 0.02),
            "w_o": NORMAL}
    AXES = {"w_up": IN_OUT, "w_skip_gate": IN_OUT, "wq": OUT_IN,
            "wk": OUT_IN, "wv": OUT_IN, "w_if": ("tensor", None),
            "w_o": OUT_IN}

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        up = 2 * d                                # proj_factor 2.0
        self.w_up = param((d, up), dtype, device)
        self.w_skip_gate = param((d, up), dtype, device)
        self.wq = param((up, d), dtype, device)
        self.wk = param((up, d), dtype, device)
        self.wv = param((up, d), dtype, device)
        self.w_if = param((up, 2 * h), dtype, device)
        self.w_o = param((d, d), dtype, device)


def _mlstm_qkv(p: MLSTM, cfg, x):
    h = cfg.n_heads
    up = x @ p.w_up
    lead = up.shape[:-1]
    q = (up @ p.wq).reshape(*lead, h, -1)
    k = (up @ p.wk).reshape(*lead, h, -1)
    v = (up @ p.wv).reshape(*lead, h, -1)
    gates = (up @ p.w_if).to(torch.float32)
    log_i, log_f = torch.chunk(gates, 2, dim=-1)      # (..., H)
    return q, k, v, log_i, F.logsigmoid(log_f)


def _mlstm_out(p: MLSTM, x, hid):
    """The skip-gated output projection: the first d of silu's 2d columns."""
    d = x.shape[-1]
    return (hid * F.silu(x @ p.w_skip_gate)[..., :d]) @ p.w_o


def init_mlstm_state(cfg, batch, device=None, dtype=torch.float32):
    h = cfg.n_heads
    dk = cfg.d_model // h
    return {"C": torch.zeros((batch, h, dk, dk), dtype=dtype, device=device),
            "n": torch.zeros((batch, h, dk), dtype=dtype, device=device),
            "m": torch.full((batch, h), -1e30, dtype=dtype, device=device)}


def run_mlstm(p: MLSTM, cfg, x, *, chunk: int = 256):
    """Chunkwise-parallel prefill, x (B, S, d) -> (B, S, d): the
    stabilised quadratic form within chunks of ``min(chunk, S)`` tokens
    (which must divide S), the recurrent state carried across them."""
    b, s, d = x.shape
    q, k, v, log_i, log_f = _mlstm_qkv(p, cfg, x)
    dk = q.shape[-1]
    ck = min(chunk, s)
    if s % ck:
        raise ValueError(f"run_mlstm: S = {s} is not a multiple of the "
                         f"chunk {ck}")
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    idx = torch.arange(ck, device=x.device)
    future = (idx[:, None] < idx[None, :])[None, :, :, None]
    state = init_mlstm_state(cfg, b, x.device)
    c_prev, n_prev, m_prev = state["C"], state["n"], state["m"]
    hids = []
    with tag_scope("tagscan_mlstm_chunks", s // ck):
        for c0 in range(0, s, ck):
            # (B,ck,H,D) and (B,ck,H)
            qc, kc, vc = (t[:, c0:c0 + ck] for t in (q, k, v))
            li, lf = log_i[:, c0:c0 + ck], log_f[:, c0:c0 + ck]
            bcum = torch.cumsum(lf, dim=1)               # (B,ck,H) inclusive
            # intra-chunk decay D_{t,j} = b_t - b_j + log i_j (j <= t)
            dmat = (bcum[:, :, None, :] - bcum[:, None, :, :]
                    + li[:, None, :, :])                 # (B,ck,ck,H)
            dmat = dmat.masked_fill(future, float("-inf"))
            m_intra = torch.amax(dmat, dim=2)            # (B,ck,H)
            m_inter = m_prev[:, None, :] + bcum          # (B,ck,H)
            m_t = torch.maximum(m_intra, m_inter)
            w = torch.exp(dmat - m_t[:, :, None, :])     # (B,ck,ck,H)
            scores = torch.einsum("bthd,bjhd->btjh", qc, kc) / (dk ** 0.5)
            wsc = w * scores
            num_intra = torch.einsum("btjh,bjhd->bthd", wsc, vc)
            den_intra = torch.sum(wsc, dim=2)            # (B,ck,H)
            inter_scale = torch.exp(m_inter - m_t)       # (B,ck,H)
            qsc = qc / (dk ** 0.5)
            num_inter = torch.einsum("bthk,bhkv->bthv", qsc, c_prev) \
                * inter_scale[..., None]
            den_inter = torch.einsum("bthk,bhk->bth", qsc,
                                     n_prev) * inter_scale
            den = torch.maximum(torch.abs(den_intra + den_inter),
                                torch.exp(-m_t))
            hids.append((num_intra + num_inter) / den[..., None])
            # the state at the chunk's end
            b_l = bcum[:, -1, :]                         # (B,H) total decay
            m_state = torch.maximum(
                m_prev + b_l,
                torch.amax(b_l[:, None, :] - bcum + li, dim=1))
            carry_decay = torch.exp(m_prev + b_l - m_state)
            kv_decay = torch.exp(b_l[:, None, :] - bcum + li
                                 - m_state[:, None, :])
            c_prev = c_prev * carry_decay[..., None, None] + torch.einsum(
                "bjh,bjhk,bjhv->bhkv", kv_decay, kc, vc)
            n_prev = n_prev * carry_decay[..., None] + torch.einsum(
                "bjh,bjhk->bhk", kv_decay, kc)
            m_prev = m_state
    hid = torch.cat(hids, 1).reshape(b, s, d).to(x.dtype)
    return _mlstm_out(p, x, hid)


def run_mlstm_decode(p: MLSTM, cfg, x, state):
    """One recurrent step.  x (B, 1, d); state {"C", "n", "m"} (f32)."""
    b, _, d = x.shape
    q, k, v, log_i, log_f = _mlstm_qkv(p, cfg, x)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]               # (B,H,Dk)
    log_i, log_f = log_i[:, 0], log_f[:, 0]           # (B,H)
    dk = q.shape[-1]
    m_prev, c_prev, n_prev = state["m"], state["C"], state["n"]
    m_new = torch.maximum(log_f + m_prev, log_i)
    decay = torch.exp(log_f + m_prev - m_new)[..., None, None]
    inject = torch.exp(log_i - m_new)[..., None, None]
    c_new = c_prev * decay + inject * (k[..., :, None] * v[..., None, :])
    n_new = n_prev * decay[..., 0] + inject[..., 0] * k
    qs = q.to(torch.float32) / (dk ** 0.5)
    num = torch.einsum("bhk,bhkv->bhv", qs, c_new)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", qs, n_new)),
                        torch.exp(-m_new))
    hid = (num / den[..., None]).reshape(b, 1, d).to(x.dtype)
    return _mlstm_out(p, x, hid), {"C": c_new, "n": n_new, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """``w_gates`` (d, 4d) (z, i, f, o), ``r_gates`` (d, 4d) drawn at std
    0.02, ``w_out`` (d, d)."""

    INIT = {"w_gates": NORMAL, "r_gates": ("normal", 0.02),
            "w_out": NORMAL}
    AXES = {"w_gates": IN_OUT, "r_gates": (None, "tensor"),
            "w_out": OUT_IN}

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.w_gates = param((d, 4 * d), dtype, device)
        self.r_gates = param((d, 4 * d), dtype, device)
        self.w_out = param((d, d), dtype, device)


def init_slstm_state(cfg, batch, device=None, dtype=torch.float32):
    z = torch.zeros((batch, cfg.d_model), dtype=dtype, device=device)
    return {"c": z, "n": z + 1e-6, "h": z, "m": z - 1e30}


def _slstm_step(p: SLSTM, carry, xt):
    """xt (B, 4d), the input's pre-activation; the carry's h enters
    through ``r_gates`` in xt's dtype."""
    c, n, h, m = carry["c"], carry["n"], carry["h"], carry["m"]
    pre = xt + h.to(xt.dtype) @ p.r_gates
    z, i, f, o = torch.chunk(pre.to(torch.float32), 4, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    log_f = F.logsigmoid(f)
    m_new = torch.maximum(log_f + m, i)
    ig = torch.exp(i - m_new)
    fg = torch.exp(log_f + m - m_new)
    c_new = fg * c + ig * z
    n_new = torch.maximum(fg * n + ig, torch.exp(-m_new))
    h_new = o * c_new / n_new
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def run_slstm(p: SLSTM, cfg, x, state=None):
    """Sequential over time.  x (B, S, d) -> ((B, S, d), final state)."""
    b, s, _ = x.shape
    pre = x @ p.w_gates                                # (B,S,4d)
    carry = state if state is not None else init_slstm_state(cfg, b,
                                                             x.device)
    hs = []
    with tag_scope("tagscan_slstm_time", s):
        for t in range(s):
            carry = _slstm_step(p, carry, pre[:, t])
            hs.append(carry["h"])
    return torch.stack(hs, 1).to(x.dtype) @ p.w_out, carry


def run_slstm_decode(p: SLSTM, cfg, x, state):
    """One step.  x (B, 1, d); state {"c", "n", "h", "m"} (f32)."""
    new = _slstm_step(p, state, (x @ p.w_gates)[:, 0])
    return new["h"][:, None].to(x.dtype) @ p.w_out, new
