"""Mamba-2 (SSD) mixer layer: in-proj -> causal depthwise conv -> SSD ->
gated norm -> out-proj.  The full sequence runs through the chunked SSD
scan (``ops.ssd``); decode carries a recurrent state per row,
{"ssm": (B, H, P, N) fp32, "conv": (B, K-1, conv_ch)}, updated in place.

``ssm_apply_sharded`` and ``ssm_decode_sharded`` run the layer over the
tensor axis of a mesh, each rank on H/tp heads, with every weight in the
layout ``parallel/sharding.py`` gives it.  Those layouts split the fused
``in_proj`` columns [z | x | B | C | dt] and the conv channels [x | B | C]
evenly, so a rank's block is not its heads' columns: each rank multiplies
x by its ``in_proj`` block and all-gathers the product over the tensor
axis (an activation of B_r x S x 2(di + n) + H, where gathering the weight
would move D x that many columns per layer and step, decode included),
gathers the small conv weights, and takes z, x and dt of its heads and B
and C whole (one group).  The gated RMSNorm runs over the whole inner
width: each rank all-reduces its fp32 sum of squares before it scales its
slice.  ``out_proj``'s rows line up with the heads, so each rank returns
its fp32 share for the caller's all-reduce.  A rank's decode state is
{"ssm": (B_r, H/tp, P, N), "conv_x": (B_r, K-1, di/tp), "conv_bc": (B_r,
K-1, 2N)}: the conv state's x channels by head, its B and C channels on
every rank.  Where the tensor axis does not divide the heads (or
``out_proj``'s rows), the layer runs whole on every rank: the same code at
all H heads under ``ctx.whole()`` (``transformer.layer_plan``), each leaf
the layout still splits gathered first, nothing summed over the axis.
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


# ------------------------------------------------------------------ sharded

def _rank_cols(cfg: ModelConfig, heads: int, j: int):
    """Tensor-parallel rank j's slices (``heads`` heads each) of the fused
    projection [z | x | B | C | dt]: its z columns (also its slice of the
    inner width, the norm scale and the conv's x channels), its x columns
    and its dt columns."""
    di, n, h, _ = _dims(cfg)
    x0, x1 = j * heads * cfg.ssm_head_dim, (j + 1) * heads * cfg.ssm_head_dim
    h0 = 2 * di + 2 * n + j * heads
    return slice(x0, x1), slice(di + x0, di + x1), slice(h0, h0 + heads)


def _rank_inputs(ps, cfg: ModelConfig, hs, *, ctx, heads: int):
    """{rank: (z, raw conv input, dt_raw, local conv params, head slice)}:
    the fused projection gathered over the tensor axis and cut to the
    rank's heads.  ``hs``: {rank: (..., D)}."""
    di, n, _, conv_ch = _dims(cfg)
    proj = ctx.tp_gather({r: L.dense_apply(ps[r]["in_proj"], h) for r, h in hs.items()}, -1,
                         2 * di + 2 * n + cfg.ssm_heads)
    conv_w = ctx.tp_gather({r: ps[r]["conv_w"] for r in hs}, 1, conv_ch)
    conv_b = ctx.tp_gather({r: ps[r]["conv_b"] for r in hs}, 0, conv_ch)
    out = {}
    for r in hs:
        j = ctx.tp_index(r)
        inner, xcols, dtcols = _rank_cols(cfg, heads, j)
        pr = proj[r]
        raw = torch.cat([pr[..., xcols], pr[..., 2 * di:2 * di + 2 * n]], dim=-1)
        conv = {"conv_w": torch.cat([conv_w[r][:, inner], conv_w[r][:, di:]], dim=-1),
                "conv_b": torch.cat([conv_b[r][inner], conv_b[r][di:]])}
        out[r] = (pr[..., inner], raw, pr[..., dtcols], conv,
                  slice(j * heads, (j + 1) * heads))
    return out


def _norm_out(ps, cfg: ModelConfig, ys, *, ctx):
    """{rank: the fp32 share of out_proj} of {rank: (y * silu(z), the
    rank's slice of the inner width)}: the gated RMSNorm over the whole
    inner width (each rank's fp32 sum of squares all-reduced over the
    tensor axis), then the rank's rows of ``out_proj``."""
    di = cfg.ssm_inner
    ssq = ctx.tp_reduce({r: g.to(torch.float32).square().sum(dim=-1, keepdim=True)
                         for r, (g, _) in ys.items()})
    out = {}
    for r, (g, inner) in ys.items():
        y = g.to(torch.float32) * torch.rsqrt(ssq[r] / di + cfg.norm_eps)
        y = (y * ps[r]["norm"]["scale"][inner].to(torch.float32)).to(g.dtype)
        out[r] = L.partial_apply(ps[r]["out_proj"], y)
    return out


def ssm_apply_sharded(ps, cfg: ModelConfig, hs, *, ctx, heads: int, impl="cuda",
                      return_state=False):
    """``ssm_apply`` over the tensor axis of ``ctx``: ps {rank: the layer's
    local mixer params}, hs {rank: (B_r, S, D)}, ``heads`` = H / tp (H
    under a ``ctx.whole()``).  Each rank runs ``ops.ssd`` on its heads.
    Returns {rank: fp32 share of the output} (summed over the tensor axis
    by the caller), with ``return_state`` also {rank: its decode state
    after the last token}."""
    di, n, _, _ = _dims(cfg)
    ys, states = {}, {}
    for r, (z, raw, dt_raw, conv, hd) in _rank_inputs(ps, cfg, hs, ctx=ctx,
                                                        heads=heads).items():
        b, s, _ = z.shape
        dl = heads * cfg.ssm_head_dim
        xbc = F.silu(L.causal_conv(conv, raw))
        xi, bmat, cmat = torch.split(xbc, [dl, n, n], dim=-1)
        dt = F.softplus(dt_raw.to(torch.float32) + ps[r]["dt_bias"][hd])
        xh = xi.reshape(b, s, heads, cfg.ssm_head_dim)
        pad = (-s) % cfg.ssm_chunk
        xh, dt, bmat, cmat = (F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad)).contiguous()
                              for a in (xh, dt, bmat, cmat))
        out = ops.ssd(xh, dt, ps[r]["a_log"][hd], bmat, cmat, ps[r]["d"][hd],
                      chunk=cfg.ssm_chunk, return_state=return_state, impl=impl)
        y, final = out if return_state else (out, None)
        ys[r] = (y[:, :s].reshape(b, s, dl) * F.silu(z), _rank_cols(cfg, heads,
                                                                    ctx.tp_index(r))[0])
        if return_state:
            cs = L.conv_state(raw, conv["conv_w"].shape[0])
            states[r] = {"ssm": final, "conv_x": cs[..., :dl], "conv_bc": cs[..., dl:]}
    out = _norm_out(ps, cfg, ys, ctx=ctx)
    return (out, states) if return_state else out


def ssm_state_init_sharded(cfg: ModelConfig, batch, heads: int, dtype, device):
    """A tensor-parallel rank's decode state at ``heads`` heads."""
    _, n, _, _ = _dims(cfg)
    k = cfg.ssm_conv - 1
    return {"ssm": torch.zeros((batch, heads, cfg.ssm_head_dim, n), dtype=torch.float32,
                               device=device),
            "conv_x": torch.zeros((batch, k, heads * cfg.ssm_head_dim), dtype=dtype,
                                  device=device),
            "conv_bc": torch.zeros((batch, k, 2 * n), dtype=dtype, device=device)}


def ssm_decode_sharded(ps, cfg: ModelConfig, hs, states, *, ctx, heads: int):
    """``ssm_decode_apply`` over the tensor axis: hs {rank: (B_r, 1, D)},
    states {rank: ``ssm_state_init_sharded``'s}, updated in place.  Returns
    {rank: fp32 share (B_r, 1, D)}."""
    _, n, _, _ = _dims(cfg)
    dl = heads * cfg.ssm_head_dim
    ys = {}
    for r, (z, raw, dt_raw, conv, hd) in _rank_inputs(
            ps, cfg, {r: h[:, 0] for r, h in hs.items()}, ctx=ctx, heads=heads).items():
        st = states[r]
        b = z.shape[0]
        prev = torch.cat([st["conv_x"], st["conv_bc"]], dim=-1)
        window = torch.cat([prev, raw[:, None]], dim=1)  # (B, K, dl + 2N)
        xbc = F.silu(L.causal_conv_step(conv, window))
        xi, bmat, cmat = torch.split(xbc, [dl, n, n], dim=-1)
        dt = F.softplus(dt_raw.to(torch.float32) + ps[r]["dt_bias"][hd])
        y, new_ssm = ops.ssd_decode(xi.reshape(b, heads, cfg.ssm_head_dim), dt,
                                    ps[r]["a_log"][hd], bmat, cmat, ps[r]["d"][hd], st["ssm"])
        st["ssm"].copy_(new_ssm)
        st["conv_x"].copy_(window[:, 1:, :dl])
        st["conv_bc"].copy_(window[:, 1:, dl:])
        ys[r] = (y.reshape(b, dl) * F.silu(z), _rank_cols(cfg, heads, ctx.tp_index(r))[0])
    return {r: y[:, None] for r, y in _norm_out(ps, cfg, ys, ctx=ctx).items()}
