"""Mamba-2 (SSD) mixer layer: in-proj -> causal depthwise conv -> SSD ->
gated norm -> out-proj.  The full sequence runs through the chunked SSD
scan (``ops.ssd``); decode carries a recurrent state per row,
{"ssm": (B, H, P, N) fp32, "conv": (B, K-1, conv_ch)}, updated in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def _dims(cfg: ModelConfig):
    di, n, h = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    return di, n, h, di + 2 * n


def ssm_init(gen, cfg: ModelConfig, device):
    """The JAX package's init: A = -1, D = 1 and dt_bias = 0 for every head."""
    dt = L.dtype_of(cfg)
    di, n, h, conv_ch = _dims(cfg)
    f32 = torch.float32
    return {
        "in_proj": L.dense_init(gen, cfg.d_model, 2 * di + 2 * n + h, dt, device),  # z, x, B, C, dt
        "conv_w": L.truncated_normal(gen, (cfg.ssm_conv, conv_ch), dt, cfg.ssm_conv ** -0.5,
                                     device),
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=device),
        "a_log": torch.zeros((h,), dtype=f32, device=device),
        "d": torch.ones((h,), dtype=f32, device=device),
        "dt_bias": torch.zeros((h,), dtype=f32, device=device),
        "norm": L.rmsnorm_init(di, dt, device),
        "out_proj": L.dense_init(gen, di, cfg.d_model, dt, device),
    }


def _split(cfg, proj):
    di, n, h, _ = _dims(cfg)
    return torch.split(proj, [di, di, n, n, h], dim=-1)  # z, x, B, C, dt


def ssm_apply(p, cfg: ModelConfig, x, *, impl="cuda", return_state=False):
    """x: (B, S, D) -> (B, S, D); with ``return_state`` also the decode
    state after the last token (the prefill paths that cache it; the train
    forward asks for none, so the scan's backward sees y alone)."""
    b, s, _ = x.shape
    di, n, h, _ = _dims(cfg)
    proj = L.dense_apply(p["in_proj"], x)
    z, xbc_pre, b_pre, c_pre, dt_raw = _split(cfg, proj)
    raw = torch.cat([xbc_pre, b_pre, c_pre], dim=-1)
    xbc = F.silu(L.causal_conv(p, raw))
    xi, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    xh = xi.reshape(b, s, h, cfg.ssm_head_dim)
    # pad to a chunk multiple: dt = 0 rows are exact no-ops (decay 1, zero input)
    pad = (-s) % cfg.ssm_chunk
    xh, dt, bmat, cmat = (F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad)).contiguous()
                          for a in (xh, dt, bmat, cmat))
    out = ops.ssd(xh, dt, p["a_log"], bmat, cmat, p["d"], chunk=cfg.ssm_chunk,
                  return_state=return_state, impl=impl)
    y, final = out if return_state else (out, None)
    y = y[:, :s].reshape(b, s, di)
    y = L.rmsnorm_apply(p["norm"], y * F.silu(z), cfg.norm_eps)
    y = L.dense_apply(p["out_proj"], y)
    if return_state:
        # conv state for decode: the last K-1 pre-activation conv inputs
        return y, {"ssm": final, "conv": L.conv_state(raw, p["conv_w"].shape[0])}
    return y


def ssm_state_init(cfg: ModelConfig, batch, dtype, device):
    _, n, h, conv_ch = _dims(cfg)
    return {"ssm": torch.zeros((batch, h, cfg.ssm_head_dim, n), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                                device=device)}


def ssm_decode_apply(p, cfg: ModelConfig, x, state):
    """x: (B, 1, D); state from ``ssm_state_init``, updated in place.
    Returns y (B, 1, D)."""
    b = x.shape[0]
    di, n, h, _ = _dims(cfg)
    proj = L.dense_apply(p["in_proj"], x[:, 0])
    z, xbc_pre, b_pre, c_pre, dt_raw = _split(cfg, proj)
    raw = torch.cat([xbc_pre, b_pre, c_pre], dim=-1)  # (B, CH)
    window = torch.cat([state["conv"], raw[:, None]], dim=1)  # (B, K, CH)
    xbc = F.silu(L.causal_conv_step(p, window))
    xi, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    y, new_ssm = ops.ssd_decode(xi.reshape(b, h, cfg.ssm_head_dim), dt, p["a_log"], bmat,
                                cmat, p["d"], state["ssm"])
    state["ssm"].copy_(new_ssm)
    state["conv"].copy_(window[:, 1:])
    y = L.rmsnorm_apply(p["norm"], y.reshape(b, di) * F.silu(z), cfg.norm_eps)
    return L.dense_apply(p["out_proj"], y)[:, None]
