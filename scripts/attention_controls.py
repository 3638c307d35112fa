#!/usr/bin/env python3
"""Where the bf16 readings of the prefill attention kernels come from, on a
CUDA card: the tile body of ``csrc/attn_tile.cuh`` beside the arithmetic
it replaced.

    PYTHONPATH=src python scripts/attention_controls.py

The former bf16 kernels widened their loads to fp32, ran the fp32-FMA body
and rounded their stores to bf16; the fp32 kernels still run that body, so
the fp32 kernel on the values widened to fp32, its output rounded to bf16,
is the former bf16 kernel bit for bit ("fp32 body" below).

1. Kernel level, at ``chip_smoke.py`` phase 2's shapes (flash_mha at D 64
   and D 256, flash_mha_varlen on its packed minibatch): the scaled error
   against attention computed in fp32 on the same bf16 values (exact up to
   fp32 summation order) of the tile body, the fp32 body, the plain version
   (scores and probabilities rounded to bf16) and the plain version with
   fp32 scores (probabilities still rounded); then the tile body against
   the plain version, as ``chip_smoke.py`` holds it.
2. Model level: phase 3's comparison (last-position prefill logits and 8
   teacher-forced decode steps, impl="cuda" against impl="reference") for
   qwen2-0.5b and recurrentgemma-9b at full depth, with flash_mha as it
   ships and with its bf16 calls routed through the fp32 body.

Prints the card's name and power limit first.  Fails without a card.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.data import packing  # noqa: E402
from repro_torch.kernels import flash_attention, ops, ref, varlen_attention  # noqa: E402


def scaled_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs() / (1 + want.abs())).max().item()


def fp32_body(fn):
    """``fn`` on bf16 inputs run as the former bf16 kernel ran it."""
    def call(q, k, v, *args, **kw):
        if q.dtype != torch.bfloat16:
            return fn(q, k, v, *args, **kw)
        return fn(q.float(), k.float(), v.float(), *args, **kw).to(torch.bfloat16)
    return call


def fp32_scores_mha(q, k, v, **kw):
    """The plain version with its scores in fp32 (q and k widened); its
    probabilities are still rounded to v's dtype before the second
    product."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qr = q.float().reshape(b, sq, hkv, hq // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.float()) / math.sqrt(d)
    pos_q = torch.arange(sq, device=q.device)[:, None]
    pos_k = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = pos_k <= pos_q
    if kw.get("window"):
        mask = mask & (pos_q - pos_k < kw["window"])
    probs = torch.softmax(torch.where(mask, logits, ref.NEG_INF), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, hq, d)


def kernel_readings(device):
    g = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)

    for name, (b, s, hq, hkv, d, window) in {"flash_mha D64": (4, 512, 14, 2, 64, None),
                                             "flash_mha D256": (4, 512, 16, 1, 256, 2048)}.items():
        q, k, v = randn(b, s, hq, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
        kw = dict(causal=True, window=window)
        exact = ref.mha_ref(q.float(), k.float(), v.float(), **kw)
        rows = {"tile body": flash_attention.flash_mha(q, k, v, **kw),
                "fp32 body": fp32_body(flash_attention.flash_mha)(q, k, v, **kw),
                "plain": ref.mha_ref(q, k, v, **kw),
                "plain, fp32 scores": fp32_scores_mha(q, k, v, **kw)}
        torch.cuda.synchronize()
        for what, out in rows.items():
            print(f"[kernel] {name} {what} vs fp32 attention: {scaled_err(out, exact):.3e}")
        for what in ("tile body", "fp32 body"):
            print(f"[kernel] {name} {what} vs plain: {scaled_err(rows[what], rows['plain']):.3e}")

    lens, t = cs.varlen_lengths(np.random.default_rng(5))
    cu = torch.from_numpy(packing.cu_seqlens_of(lens)).to(device)
    q, k, v = randn(t, 14, 64), randn(t, 2, 64), randn(t, 2, 64)
    exact = ref.mha_varlen_ref(q.float(), k.float(), v.float(), cu)
    rows = {"tile body": varlen_attention.flash_mha_varlen(q, k, v, cu),
            "fp32 body": fp32_body(varlen_attention.flash_mha_varlen)(q, k, v, cu),
            "plain": ref.mha_varlen_ref(q, k, v, cu)}
    torch.cuda.synchronize()
    for what, out in rows.items():
        print(f"[kernel] flash_mha_varlen {what} vs fp32 attention: "
              f"{scaled_err(out, exact):.3e}")


def model_readings(device):
    shipped = ops.mha  # the models' attention entry point, flash_mha on impl="cuda"

    def mha_fp32_body(q, k, v, *, impl="cuda", **kw):
        if impl != "cuda":
            return shipped(q, k, v, impl=impl, **kw)
        return fp32_body(flash_attention.flash_mha)(q, k, v, **kw)

    for arch in ("qwen2-0.5b", "recurrentgemma-9b"):
        cfg = cs.get_config(arch)
        params = cs.make_params(cfg, seed=0, device=device)
        for what, fn in (("tile body", shipped), ("fp32 body", mha_fp32_body)):
            ops.mha = fn
            try:
                sl = cs.phase_slice(cfg, params, impl="cuda")
            finally:
                ops.mha = shipped
            print(f"[model] {arch} {cfg.num_layers} layers bf16, flash_mha {what}: "
                  f"prefill_err={sl['prefill_err']:.3e} decode_err={sl['decode_err']:.3e} "
                  f"(of max |logit| {sl['logit_scale']:.3f}; tol {cs.LOGIT_TOL})")
        del params
        torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print("attention_controls: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    device = torch.device("cuda")
    with torch.no_grad():
        kernel_readings(device)
        model_readings(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
