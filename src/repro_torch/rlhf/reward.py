"""Reward model: a value-head trunk scored at the last valid token, as the
JAX package's ``rlhf/reward.py``."""

from __future__ import annotations

import torch

from repro_torch.models import model as MDL


def score_sequences(params, cfg, tokens, mask, *, impl="cuda"):
    """tokens: (B, S); mask: (B, S).  Returns the scalar reward of each
    sequence (B,), fp32."""
    h = MDL.forward(params, cfg, {"tokens": tokens}, impl=impl)
    v = MDL.values_of(params, h)  # (B, S)
    idx = torch.clamp(mask.sum(-1).to(torch.int64) - 1, min=0)
    return v.gather(-1, idx[:, None])[:, 0]
