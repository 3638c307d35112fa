"""Foundational layers: RMSNorm, RoPE, embeddings, gated MLP, init helpers.

Parameters are nested dicts of tensors with the JAX package's names and
layouts (dense weights are (d_in, d_out), ``y = x @ w``), so a JAX tree
bridges over leaf by leaf.  Norms and RoPE run in fp32 and cast back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import ACTS

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def truncated_normal(gen: torch.Generator, shape, dtype, scale, device):
    """A standard normal truncated to [-2, 2], drawn in fp32, times
    ``scale`` in place (the bits of ``t * scale`` without a second fp32
    copy: one Arctic expert weight is 17.9 GB in fp32), cast to ``dtype``.
    On ``meta`` (no ``gen``) it draws nothing: the shape and dtype alone."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.is_meta:
        return t.to(dtype)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale).to(dtype)


def dense_init(gen, d_in, d_out, dtype, device, with_bias=False):
    p = {"w": truncated_normal(gen, (d_in, d_out), dtype, d_in ** -0.5, device)}
    if with_bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense_apply(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(dim, dtype, device):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x, eps=1e-6):
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


# ----------------------------------------------------------------- RoPE

def rope_tables(positions, head_dim: int, theta: float):
    """cos and sin of half-split RoPE at ``positions`` ((B, S) or (S,)),
    each (B or 1, S, 1, D/2) fp32.  Built once per forward or decode step
    and shared by every layer."""
    if head_dim % 2:
        raise ValueError(f"RoPE needs an even head_dim; got {head_dim}")
    freqs = theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                    device=positions.device) / head_dim)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(torch.float32) * freqs  # (B,S,D/2)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def rope_apply(x, rope):
    """Half-split RoPE.  x: (B, S, H, D); rope: ``rope_tables`` of x's
    positions."""
    cos, sin = rope
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- causal conv
# The recurrent mixers' depthwise temporal conv (RG-LRU, SSD): weights
# p["conv_w"] (K, CH) and p["conv_b"] (CH,).  Op by op in the input's dtype,
# in the JAX package's order (the taps summed, then the bias); not
# F.conv1d, which on the card runs fp32 through cuDNN in TF32 and sums in
# another order.

def causal_conv(p, u):
    """Causal depthwise conv over u (B, S, CH)."""
    k, s = p["conv_w"].shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, k - 1, 0))
    return sum(pad[:, i:i + s] * p["conv_w"][i] for i in range(k)) + p["conv_b"]


def causal_conv_step(p, window):
    """The conv at the last position of ``window`` (B, K, CH): the same
    operations as ``causal_conv``'s last row."""
    return sum(window[:, i] * p["conv_w"][i] for i in range(window.shape[1])) + p["conv_b"]


def conv_state(u, k):
    """The decode conv state after u (B, S, CH): its last K-1 rows,
    left-padded with zeros if S < K-1."""
    s = u.shape[1]
    if s >= k - 1:
        return u[:, s - (k - 1):]
    return F.pad(u, (0, 0, k - 1 - s, 0))


# ----------------------------------------------------------------- MLP

def mlp_init(gen, cfg: ModelConfig, device):
    dt = dtype_of(cfg)
    return {
        "w_gate": dense_init(gen, cfg.d_model, cfg.d_ff, dt, device),
        "w_in": dense_init(gen, cfg.d_model, cfg.d_ff, dt, device),
        "w_out": dense_init(gen, cfg.d_ff, cfg.d_model, dt, device),
    }


def partial_apply(p, x):
    """A row-parallel rank's share of ``x @ w``: its rows of w against its
    columns of x, in fp32 (bf16 inputs are exact in fp32).  Summed over the
    tensor axis and cast once, it is the single-device product up to fp32
    summation order; rounding each share first would add a bf16 rounding
    per rank.  A bias would be added once, after the sum."""
    if "b" in p:
        raise ValueError("a row-parallel projection takes no bias")
    return x.to(torch.float32) @ p["w"].to(torch.float32)


def mlp_apply(p, cfg: ModelConfig, x, *, partial=False):
    """The gated MLP; with ``partial`` a tensor-parallel rank's fp32 share
    of the output projection (``partial_apply``)."""
    g = ACTS[cfg.act](dense_apply(p["w_gate"], x))
    h = g * dense_apply(p["w_in"], x)
    return partial_apply(p["w_out"], h) if partial else dense_apply(p["w_out"], h)


# ----------------------------------------------------------------- Embedding

def embed_init(gen, cfg: ModelConfig, device):
    return {"table": truncated_normal(gen, (cfg.vocab_size, cfg.d_model),
                                      dtype_of(cfg), 1.0, device)}


def embed_apply(p, tokens):
    return p["table"][tokens]


def unembed_apply(p_head, p_embed, x, tie: bool):
    """Returns logits in fp32 (computed in the weights' dtype, then cast,
    as the JAX package does)."""
    if tie:
        return torch.einsum("bsd,vd->bsv", x, p_embed["table"]).to(torch.float32)
    return (x @ p_head["w"]).to(torch.float32)


def token_nll(logits, labels):
    """``logsumexp(logits) - logits[label]`` per position: logits (..., V)
    fp32, labels (...) int."""
    return (torch.logsumexp(logits, dim=-1)
            - torch.gather(logits, -1, labels[..., None].long())[..., 0])


def cross_entropy(logits, labels, mask):
    """logits: (B, S, V) fp32; labels: (B, S) int; mask: (B, S) {0, 1}.
    Returns (mean_loss, token_count)."""
    nll = token_nll(logits, labels) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    return nll.sum() / denom, denom


def lm_head_chunk(s: int, chunk: int = 0) -> int:
    """The LM head's chunk length along a sequence of ``s`` positions, 0
    where the head runs whole: ``chunk == 0`` means 512 from 4,096
    positions on, and a chunk that ``s`` does not exceed or that does not
    divide it runs whole (the JAX package's ``chunked_lm_head_loss`` rule)."""
    if chunk == 0:
        chunk = 512 if s >= 4096 else 0
    return 0 if not chunk or s <= chunk or s % chunk else chunk


def checkpointed(fn, *args):
    """``fn(*args)`` whose saved tensors are dropped and recomputed in the
    backward (``torch.utils.checkpoint``, non-reentrant, the JAX package's
    ``jax.checkpoint``).  ``fn`` draws no random numbers, so no RNG state
    is stashed (there is none on ``meta``)."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)


def chunked_lm_head_loss(head_fn, hidden, labels, mask, chunk: int = 0):
    """Sequence-chunked LM head and cross-entropy with per-chunk remat:
    each chunk's masked ``logsumexp - gold`` sum is ``checkpointed``, so the
    head's working set is (B, chunk, V) and no (B, S, V) logits are held
    (``lm_head_chunk`` picks the chunk; where it is 0 the head runs whole,
    ``cross_entropy``).  Exact.  ``head_fn(h_chunk) -> logits``.  Returns
    (mean_loss, token_count)."""
    s = hidden.shape[1]
    chunk = lm_head_chunk(s, chunk)
    if not chunk:
        return cross_entropy(head_fn(hidden), labels, mask)

    def chunk_nll(h_c, y_c, m_c):
        return (token_nll(head_fn(h_c), y_c) * m_c).sum()

    total = 0.0
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpointed(chunk_nll, hidden[:, sl], labels[:, sl], mask[:, sl])
    denom = torch.clamp(mask.sum(), min=1.0)
    return total / denom, denom


# ----------------------------------------------------------------- vocab-parallel
# A rank whose embedding table (``P(t, f)``) or LM head (``P(f, t)``) holds
# the vocabulary entries lo .. lo + V_r - 1 (``model.lm_loss_sharded``).

def embed_apply_vocab_shard(p, tokens, lo: int):
    """The lookup of ``tokens`` in a table holding vocabulary rows lo ..
    lo + V_r - 1; ids outside that range give zero rows, so a sum over the
    tensor axis gives the whole lookup exactly."""
    tab = p["table"]
    ids = tokens - lo
    hit = (ids >= 0) & (ids < tab.shape[0])
    return torch.where(hit[..., None], tab[ids.clamp(0, tab.shape[0] - 1)], 0)


def gather_vocab_shard(logits, labels, lo: int):
    """``logits[..., labels - lo]`` where the label falls in this rank's
    vocabulary range lo .. lo + V_r - 1, zero elsewhere."""
    ids = labels.long() - lo
    hit = (ids >= 0) & (ids < logits.shape[-1])
    got = torch.gather(logits, -1, ids.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    return torch.where(hit, got, 0.0)
