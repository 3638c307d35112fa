"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Block: { gate branch: gelu(W_gate x) ; recurrent branch: W_in x -> causal
conv(4) -> RG-LRU } -> elementwise product -> W_out.

RG-LRU (diagonal gates, per channel, in fp32):
    r_t = sigmoid(w_a * u_t + b_a)          (recurrence gate)
    i_t = sigmoid(w_x * u_t + b_x)          (input gate)
    log a_t = -C * r_t * softplus(lam)       (C = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)
The full sequence runs through the scan (``ops.rglru_scan``); decode carries
{"h": (B, W) fp32, "conv": (B, 3, W)} per row, updated in place.

Every weight but ``w_out`` is per channel or splits its output channels, so
under tensor parallelism a rank runs the same code on its own W/tp
channels (``parallel/sharding.py`` gives each leaf that split) and returns
its fp32 share of ``w_out`` (``partial``) for the caller's all-reduce.
Where the tensor axis does not divide W, ``sanitize_specs`` leaves every
leaf whole and each rank runs all W channels (``transformer.layer_plan``),
keeping its own fp32 output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ACTS
from repro_torch.models import layers as L

RGLRU_C = 8.0


def lru_init(gen, cfg: ModelConfig, device):
    """The JAX package's init: zero gate weights and biases, lam = -1."""
    dt = L.dtype_of(cfg)
    w = cfg.lru_width

    def f32(value):
        return torch.full((w,), value, dtype=torch.float32, device=device)
    return {
        "w_in": L.dense_init(gen, cfg.d_model, w, dt, device),
        "w_gate": L.dense_init(gen, cfg.d_model, w, dt, device),
        "w_out": L.dense_init(gen, w, cfg.d_model, dt, device),
        "conv_w": L.truncated_normal(gen, (4, w), dt, 0.5, device),
        "conv_b": torch.zeros((w,), dtype=dt, device=device),
        "gate_a_w": f32(0.0), "gate_a_b": f32(0.0),
        "gate_x_w": f32(0.0), "gate_x_b": f32(0.0),
        "lam": f32(-1.0),  # softplus(lam) ~0.31 at init: moderate decay
    }


def _gates(p, u):
    """(a, bx) of the conv output u, both fp32."""
    u32 = u.to(torch.float32)
    r = torch.sigmoid(p["gate_a_w"] * u32 + p["gate_a_b"])
    i = torch.sigmoid(p["gate_x_w"] * u32 + p["gate_x_b"])
    log_a = -RGLRU_C * r * F.softplus(p["lam"])
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    return a, beta * (i * u32)


def _out(p, y, partial):
    return L.partial_apply(p["w_out"], y) if partial else L.dense_apply(p["w_out"], y)


def lru_apply(p, cfg: ModelConfig, x, *, impl="cuda", return_state=False, partial=False):
    """x: (B, S, D) -> (B, S, D); with ``return_state`` also the decode
    state after the last token; with ``partial`` (``p`` a rank's channels)
    the rank's fp32 share of the output projection."""
    gate = ACTS["gelu"](L.dense_apply(p["w_gate"], x))
    u = L.dense_apply(p["w_in"], x)
    a, bx = _gates(p, L.causal_conv(p, u))
    h, h_last = ops.rglru_scan(a, bx, impl=impl)
    y = _out(p, h.to(x.dtype) * gate, partial)
    if return_state:
        return y, {"h": h_last, "conv": L.conv_state(u, p["conv_w"].shape[0])}
    return y


def lru_state_init(cfg: ModelConfig, batch, dtype, device):
    return {"h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, 3, cfg.lru_width), dtype=dtype, device=device)}


def lru_decode_apply(p, cfg: ModelConfig, x, state, *, partial=False):
    """x: (B, 1, D); state from ``lru_state_init``, updated in place.
    Returns y (B, 1, D) (``partial`` as ``lru_apply``)."""
    gate = ACTS["gelu"](L.dense_apply(p["w_gate"], x[:, 0]))
    u = L.dense_apply(p["w_in"], x[:, 0])  # (B, W)
    window = torch.cat([state["conv"], u[:, None]], dim=1)  # (B, K, W)
    a, bx = _gates(p, L.causal_conv_step(p, window))
    h = a * state["h"] + bx
    state["h"].copy_(h)
    state["conv"].copy_(window[:, 1:])
    return _out(p, h.to(x.dtype) * gate, partial)[:, None]
