#!/usr/bin/env python3
"""The readings behind ``chip_smoke.py``'s packed-training limits, each
beside those of planted faults the limits have to fail, on a CUDA card;
then the share of a train step that the plain attention backward takes.

    PYTHONPATH=src python scripts/train_controls.py

1. Phase 6's models and first rollout (full-width, 24-layer bf16
   qwen2-0.5b, ``chip_smoke.train_models`` / ``train_rollout``).  On the
   first minibatch, the actor's and critic's loss, grad_norm and gradients
   (``chip_smoke.grad_agreement``) against the reference tier, for: the
   kernel tier (the sound reading, as ``chip_smoke`` holds it); the plain
   version with query chunks of 64 instead of 128 (the reference tier's
   own spread: the same math, other matmul shapes); and the kernel tier
   with planted faults: every inner sequence boundary one token late in
   every layer, then in the last layer only, and a window of 64 keys.
2. The same at full width in fp32 on 2 layers (``FP32_GRAD_TOL``): the
   kernel tier, and the kernel tier with the boundaries one token late.
3. The plain attention backward of a train step: one layer's varlen
   attention forward plus backward at the first minibatch's shape, kernel
   forward then plain backward as the train step runs it, beside the
   kernel forward alone (CUDA events), times layers x minibatches, against
   one timed actor train step.

Prints the card's name and power limit first.  Fails without a card.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, ref, varlen_attention  # noqa: E402
from repro_torch.rlhf import experiment as EXP  # noqa: E402

KERNEL = varlen_attention.flash_mha_varlen


def late_boundaries(layers=None):
    """The kernel with every inner boundary of cu_seqlens one token late:
    in every call when ``layers`` is None, else in the last layer's only.
    A train forward with remat calls the kernel once per layer in order,
    then once per layer in reverse (the recompute), so the last layer's
    calls are those numbered ``layers`` and ``layers + 1`` modulo
    ``2 * layers``."""
    calls = [0]

    def fn(q, k, v, cu, **kw):
        calls[0] += 1
        if layers is None or calls[0] % (2 * layers) in (layers, layers + 1):
            cu = cu.clone()
            cu[1:-1] += 1
        return KERNEL(q, k, v, cu, **kw)
    return fn


def windowed(q, k, v, cu, **kw):
    return KERNEL(q, k, v, cu, **dict(kw, window=64))


def run(label, cfg, exp, models, roll, want, *, patch=None, impl="cuda"):
    """Patch the kernel (or the plain version) as named, take the first
    minibatch's gradients and print their agreement with ``want``."""
    saved = varlen_attention.flash_mha_varlen, ref.mha_varlen_ref
    try:
        if patch == "plain":
            ref.mha_varlen_ref = functools.partial(saved[1], q_chunk=64)
        elif patch is not None:
            patch.launches = 0  # the kernel's wrapper counts on the name it is bound to
            varlen_attention.flash_mha_varlen = patch
        got = cs.first_minibatch(cfg, exp, models, roll, impl=impl)
    finally:
        varlen_attention.flash_mha_varlen, ref.mha_varlen_ref = saved
    for name, c in cs.grad_agreement(got, want).items():
        print(f"[controls] {label}: {name} loss_err={c['loss_err']:.3e} grad_norm_err="
              f"{c['grad_norm_err']:.3e} global_err={c['global_err']:.3e} clip_frac "
              f"{c['clip_frac']:.4f} vs {c['ref_clip_frac']:.4f}; worst leaves "
              + ", ".join(f"{n} {e:.3e}" for e, n in c["worst_leaves"]), flush=True)
    del got


def events_ms(fn, iters=10):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def backward_share(cfg, exp, models, roll, ex):
    """Item 3."""
    mb = {k: v[0] for k, v in EXP.actor_train_batch(exp, roll).items()}
    t = mb["tokens"].shape[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((t, h, cfg.head_dim), generator=g, device="cuda").to(torch.bfloat16)
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    w = torch.randn_like(q)
    cu = mb["cu_seqlens"]
    longest = exp.prompt_len + exp.gen_len

    def fwd_bwd():
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = KERNEL(*xs, cu, max_seqlen=longest)
        torch.autograd.grad(out, xs, w)

    fb = events_ms(fwd_bwd)
    fwd = events_ms(lambda: KERNEL(q, k, v, cu))
    per_step = cfg.num_layers * exp.ppo.n_minibatches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex["actor_train"](models["actor"], roll)
    torch.cuda.synchronize()
    step = time.perf_counter() - t0
    bwd_s = (fb - fwd) * per_step / 1e3
    print(f"[controls] plain attention backward: one layer at T {t} (kernel forward + plain "
          f"backward {fb:.3f} ms, kernel forward {fwd:.4f} ms), x {per_step} layer-minibatches "
          f"= {bwd_s:.3f}s of a {step:.3f}s actor train step ({100 * bwd_s / step:.1f}%)",
          flush=True)


def main():
    if not torch.cuda.is_available():
        print("train_controls: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    build.build()
    cfg = get_config("qwen2-0.5b")
    exp = cs.train_experiment()
    models = cs.train_models(cfg, exp, "cuda")
    ex = EXP.build_executors(cfg, cfg, exp)
    roll, _ = cs.train_rollout(cfg, exp, ex, models, np.random.default_rng(300))
    want = cs.first_minibatch(cfg, exp, models, roll, impl="reference")
    run("bf16 24 layers, kernel (sound)", cfg, exp, models, roll, want)
    run("bf16 24 layers, plain at q_chunk 64 (the reference tier's spread)", cfg, exp, models,
        roll, want, patch="plain", impl="reference")
    run("bf16 24 layers, kernel, boundaries one token late in every layer", cfg, exp, models,
        roll, want, patch=late_boundaries())
    run("bf16 24 layers, kernel, boundaries one token late in the last layer", cfg, exp, models,
        roll, want, patch=late_boundaries(cfg.num_layers))
    run("bf16 24 layers, kernel, window 64", cfg, exp, models, roll, want, patch=windowed)
    del want
    small, m32 = cs.fp32_train_models(cfg, "cuda")
    want = cs.first_minibatch(small, exp, m32, roll, impl="reference")
    run("fp32 2 layers, kernel (sound)", small, exp, m32, roll, want)
    run("fp32 2 layers, kernel, boundaries one token late in the last layer", small, exp, m32,
        roll, want, patch=late_boundaries(small.num_layers))
    del want, m32
    torch.cuda.empty_cache()
    backward_share(cfg, exp, models, roll, ex)
    return 0


if __name__ == "__main__":
    sys.exit(main())
