#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. print the card's name and power limit; build the CUDA kernels from
     src/repro_torch/kernels/csrc (one nvcc per source, started together);
  2. hold each kernel against its plain PyTorch version on the card at this
     slice's shapes (bf16; grouped_ffn and flash_mha_varlen also in fp32,
     flash_mha_varlen also windowed, on equal segments against flash_mha,
     under a perturbation of another sequence, and its gradient; a decode
     kernel (no backward) refusing an input that requires grad;
     flash_mha and flash_decode also at recurrentgemma-9b's D = 256,
     ssd_scan at mamba2-1.3b's widths, rglru_scan at recurrentgemma-9b's in
     fp32; paged_flash_decode also bit for bit against flash_decode on the
     gathered cache in bf16 and fp32) and time kernel (inputs warm in L2 as
     ``ms``, L2 flushed before each call as ``cold_ms``), plain version,
     bound and one PyTorch library call where one computes the same
     function (every kernel but rglru_scan, kernel and library call, from
     CUDA-graph replays: the wrappers' host work outlasts most kernels, so
     a loop of eager calls, kept as ``eager_ms``, reads the host; ssd_scan
     also at a 1-row admission); print the registers, spill bytes, shared
     memory and blocks per SM of the tensor-core bodies (the prefill
     attention tile body csrc/attn_tile.cuh, the split-KV body
     csrc/decode_split.cuh of flash_decode and paged_flash_decode,
     grouped_ffn's two wgmma launches, ssd_scan's bf16 body at each P
     split), the decode kernels' splits and ssd_scan's P splits at the main
     path's shapes; grouped_ffn's rows are also held bit-exact between an
     8192-row and a 64-row cohort, and timed over N beside
     torch._grouped_mm;
  3. full-width qwen2-0.5b and granite-moe-1b-a400m (24 layers each), then
     mamba2-1.3b (48 SSD layers) and recurrentgemma-9b (26 RG-LRU and 12
     local-attention layers), all at full depth, bf16, seeded random
     weights (the recurrent mixers' constant init leaves drawn at random):
     prefill last-position logits and 8
     teacher-forced decode steps under impl="cuda" against
     impl="reference" (for granite also the share of (token, layer) pairs
     whose top-k expert set agrees); then the same prompts admitted through
     ``paged_insert`` into a shuffled block table and 8 teacher-forced paged
     decode steps against the dense decode;
  4. ``BatchServer.serve`` on qwen2-0.5b: 8 ragged requests (prompts 16-400
     tokens), 64 new tokens, greedy then sampled, with the kernels' launch
     counts held to what the shapes predict;
  5. ``ContinuousBatchServer.serve``: 16 ragged requests (prompts 16-400
     tokens, 8-64 new tokens each), 8 slots, blocks of 16, greedy, sampled,
     then (qwen2-0.5b only) greedy on a pool too small for all rows
     (preemption), with the launch counts held to the prediction; then the
     bucketed server on the same traffic, its launches held too; qwen2-0.5b
     first, then granite-moe-1b-a400m, mamba2-1.3b and recurrentgemma-9b
     (one ssd_scan per SSM layer and one rglru_scan per RG-LRU layer per
     prefill, one flash_decode per local-attention layer per decode step);
  6. packed PPO training of full-width qwen2-0.5b: actor and reference, critic
     and reward models, two iterations of the executors (16 prompts of 128
     tokens, 256 new, each row's gen_mask cut at a seeded length, reference,
     critic and reward inference, then the packed actor and critic train
     steps with AdamW over 2 minibatches); on the first, the first
     minibatch's losses, grad norms, clip_frac and per-leaf gradients under
     impl="cuda" against impl="reference" (also in fp32 on 2 layers); the
     parameters finite and changed after each step, flash_mha_varlen's
     launches held to the prediction, no other kernel launched by the train
     steps;
  7. padded PPO training, and the training of every served model: two
     padded iterations of full qwen2-0.5b on phase 6's traffic (flash_mha
     under grad; the same checks, and in fp32 on 2 layers the packed step
     against the padded one on one rollout); then, on 8 prompts of 128
     tokens and 128 new, granite-moe-1b-a400m (24 layers) one packed and
     one padded iteration (grouped_ffn under grad), mamba2-1.3b (48 layers,
     ssd_scan under grad) and recurrentgemma-9b (5 of 38 layers, rglru_scan
     and flash_mha under grad) one padded iteration each; their bf16
     comparisons of the tiers printed, their fp32 2-layer ones held (where
     an MoE route parts between the runs, its near-tie held instead); each
     iteration's train launches held to the prediction; peak memory.
  8. the paper's runtime on the card: ``profile_model`` of qwen2-0.5b
     into a ``ProfileStore``; an ``RLHFExperiment`` of full qwen2-0.5b as
     actor and critic on ``Cluster(1, 1, chip=hw.H100)`` and phase 7's
     padded traffic, calibrated from that store, its plan searched (MCMC,
     300 iterations); one ``run_iteration`` through ``RuntimeEngine``
     against two hand-driven iterations of phase 7's loop on the same
     prompts and weights (rollout and inference outputs bit for bit, train
     stats within a limit set from the two hand runs' spread); each call's
     measured seconds beside the cost model's estimate, analytic, profiled
     and recalibrated from the records (read against a second
     iteration); ``run(steps=2)`` at pipeline depth 2 against depth 1
     (iteration 1 bit for bit, iteration 2's difference printed); launches
     per iteration held to the prediction; ``engine.stats()``; peak memory.
Each model's parameters are freed before the next is built.
Then one JSON line of kernel numbers, and last {"ok": true, "device": ...}.

Phases 3 to 8 are functions of (config, params or experiment, impl) so the
CPU tests rehearse them at the reduced size with impl="reference".
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import hw  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ATTN, LRU, SSM  # noqa: E402
from repro_torch.core import profiler as PROF  # noqa: E402
from repro_torch.core import simulator as SIM  # noqa: E402
from repro_torch.core.estimator import CostModel  # noqa: E402
from repro_torch.core.plan import Cluster  # noqa: E402
from repro_torch.kernels import (build, decode_attention, flash_attention,  # noqa: E402
                                 grouped_expert, paged_decode_attention, ref, varlen_attention)
from repro_torch.kernels import ssd_scan as ssd_scan_mod  # noqa: E402
from repro_torch.kernels.decode_attention import flash_decode  # noqa: E402
from repro_torch.kernels.flash_attention import flash_mha  # noqa: E402
from repro_torch.kernels.grouped_expert import grouped_ffn  # noqa: E402
from repro_torch.kernels.paged_decode_attention import paged_flash_decode  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.kernels.varlen_attention import flash_mha_varlen  # noqa: E402
from repro_torch.launch.serve import (BatchServer, ContinuousBatchServer,  # noqa: E402
                                      bucket_of)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as MDL  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import paged_cache as PC  # noqa: E402
from repro_torch.data import packing  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.rlhf import experiment as EXP  # noqa: E402
from repro_torch.rlhf import ppo as PPO  # noqa: E402

# Published H100 SXM peaks: dense bf16 tensor-core rate and HBM3 bandwidth.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# Kernel vs plain version, bf16 inputs, |err| <= KERNEL_TOL * (1 + |plain|):
# the plain version rounds the scores and probabilities to bf16 before its
# second product (as the JAX reference does), the decode kernels keep
# scores in fp32 and probabilities to ~2^-17 (fp32, or two bf16 terms), the
# prefill kernels keep scores in fp32 and round their unnormalised
# probabilities; 2e-2 is the JAX package's own bf16 tolerance for its
# kernels.
KERNEL_TOL = 2e-2
# grouped_ffn vs its plain version: both take fp32 products of the same
# values and differ in summation order (and, in bf16, in the kernel's
# intermediate H carried as two bf16 terms, ~2^-17 of |H|), so bf16 inputs
# are held to GROUPED_TOL (between the H100's reading, <= 1.1e-5 scaled, and
# the ~1e-3 that an intermediate rounded to bf16 once would cost) and fp32
# ones to FP32_TOL.
GROUPED_TOL = 1e-4
FP32_TOL = 1e-5
# ssd_scan vs its plain version run in fp32 on the same values: the fp32
# products are the same, summed in another order over other spans (the
# fp32 kernel's 64-row pieces against the plain version's 128-row chunks;
# the bf16 body's 128-row pieces take M, the state and X w as two bf16
# terms, ~2^-17 of each).
# FP32_SCAN_TOL lies between the H100's reading (5.7e-6 scaled) and that of
# the plain version with a bf16 state or a bf16 x * dt (1.1e-2, 2.0e-2;
# scripts/limit_controls.py, PERF.md).
FP32_SCAN_TOL = 1e-4
# In bf16 the kernel also rounds y once: bf16's unit roundoff 2^-8 of |y|
# more (H100: 3.4e-3; a bf16 state 1.2e-2).
SSD_BF16_TOL = 2.0 ** -8 + FP32_SCAN_TOL
# rglru_scan vs its plain version in fp32 (the model's gates are fp32):
# both carry fp32 and differ only in the scan's association order
# (FP32_TOL).
# Where greedy continuous and bucketed outputs of a model with recurrent
# mixers part, the larger of both tokens' distances below the top logit,
# over the top |logit|: between the H100's largest sound reading (1.5e-2)
# and the largest with the last recurrent layer of each admitted slot fed
# the next slot's state (4.9e-2 mamba2, 6.8e-2 recurrentgemma; > 1 with
# every layer so fed; scripts/limit_controls.py, PERF.md).
RECURRENT_TIE_TOL = 3e-2
# Full model, impl="cuda" vs impl="reference": max |logit difference| over
# max |reference logit|.  Both run bf16 through every layer and differ only
# in where attention rounds to bf16, in the order of the expert FFN's fp32
# sums (MoE) and of the scans' fp32 sums (SSD, RG-LRU).
LOGIT_TOL = 5e-2
# The same comparison in fp32 at full width and a few layers, for the models
# with recurrent mixers: both tiers then round nowhere to bf16, so what is
# left is summation order (the kernels' fp32 FMAs against cuBLAS and the
# plain versions), ~1e-6 of the largest logit; 1e-4 leaves room for the
# SSD's chunked decays (see FP32_SCAN_TOL).
FP32_LOGIT_TOL = 1e-4
# Packed PPO train step, first minibatch, impl="cuda" vs impl="reference" at
# full depth in bf16: the loss (over the mean |advantage| for the actor,
# whose loss is a sum of ratio * advantage terms near zero; over the loss
# for the critic), grad_norm and the whole gradient (Frobenius norm of the
# difference over that of the reference) within TRAIN_TOL, each parameter's
# gradient within TRAIN_LEAF_TOL.  Both tiers run the same bf16 ops and the
# same plain backward and part only where the forward attention rounds to
# bf16 (as LOGIT_TOL), which each gradient carries through 24 layers.  The
# H100 reads (scripts/train_controls.py, PERF.md): whole gradient 2.8e-2 /
# 2.1e-2 (actor / critic), worst leaf 4.3e-2 / 6.3e-2 (the k/v biases),
# loss and grad_norm <= 1e-3; the reference tier's own spread (query chunks
# of 64 against 128) 6.4e-3 and 1.7e-2; planted faults: every sequence
# boundary one token late in every layer 1.2 / 4.6 (whole gradient), a
# window of 64 keys 1.9 / 4.3.  A fault in one layer of 24 reads like the
# sound run here (2.8e-2, worst leaf 1.1e-1): FP32_GRAD_TOL's check is the
# tight one.  clip_frac may differ by CLIP_FRAC_TOL (a token whose ratio
# lies at a clip edge within that rounding falls either way; sound 0, the
# boundary fault 0.32).
TRAIN_TOL = 5e-2
TRAIN_LEAF_TOL = 2e-1
CLIP_FRAC_TOL = 1e-2
# The same comparison in fp32 at full width and 2 layers, for every number
# and every leaf: both tiers round nowhere to bf16, so only summation order
# is left (H100: 3.3e-6 worst; the boundaries one token late in the last
# layer only: 1.5e-2 whole gradient, 4.6e-2 worst leaf).
FP32_GRAD_TOL = 1e-4
# Where a route of an MoE model parts between two fp32 runs (tiers or
# layouts), the larger of both runs' gaps between the token's k-th and
# (k+1)-th router probabilities.  The runs' hidden states differ in
# summation order only (a few 1e-6 relative, FP32_GRAD_TOL's readings), so
# the probabilities move by less than that and a route may part only at
# such a near-tie; one expert swapped for a token moves the gradients past
# FP32_GRAD_TOL, so phase 7 holds the gap in place of the gradients where
# a route parts.
ROUTE_TIE_TOL = 1e-5
# The raw init (embedding std 1.0, tied unembedding) makes every next-token
# distribution almost one-hot; scaled by 0.05 the logits' spread is ~1.5.
EMBED_SCALE = 0.05
ITERS = 50
# Rewritten between timed calls to evict the inputs from L2 (50 MB on H100).
FLUSH_BYTES = 64 << 20


def check(ok, msg):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


KERNELS = (flash_mha, flash_decode, paged_flash_decode, grouped_ffn, ssd_scan, rglru_scan,
           flash_mha_varlen)


def reset_launches():
    for k in KERNELS:
        k.launches = 0


def launches():
    return {k.__name__: k.launches for k in KERNELS}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def make_params(cfg, *, seed, device):
    """``init_params`` with the embedding scaled by EMBED_SCALE and the
    recurrent mixers' constant leaves drawn at random (``randomize_mixers``)."""
    params = MDL.init_params(cfg, seed=seed, device=device)
    params["embed"]["table"].mul_(EMBED_SCALE)
    randomize_mixers(params, seed=seed)
    return params


def randomize_mixers(params, *, seed):
    """The JAX init gives every SSD head A = -1, D = 1, dt_bias = 0 and every
    RG-LRU channel lam = -1 with zero gates, so all heads and channels decay
    alike.  Draw them instead, in place: A = -exp(a_log) in [-16, -1],
    dt = softplus(dt_bias) in [1e-3, 1e-1] (log-uniform), D in [0.5, 1.5],
    conv biases at std 0.1, lam in [-2, 2], gate weights and biases at std
    0.5."""
    dev = params["embed"]["table"].device
    g = torch.Generator(device=dev).manual_seed(seed)

    def uniform(t, lo, hi):
        return torch.rand(t.shape, generator=g, device=dev) * (hi - lo) + lo

    def normal(t, std):
        return torch.randn(t.shape, generator=g, device=dev) * std
    for p in params["layers"]:
        m = p["mixer"]
        if "a_log" not in m and "lam" not in m:
            continue
        m["conv_b"].copy_(normal(m["conv_b"], 0.1))
        if "a_log" in m:
            m["a_log"].copy_(uniform(m["a_log"], 0.0, math.log(16.0)))
            dt = torch.exp(uniform(m["dt_bias"], math.log(1e-3), math.log(1e-1)))
            m["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))  # softplus^-1(dt)
            m["d"].copy_(uniform(m["d"], 0.5, 1.5))
        else:
            m["lam"].copy_(uniform(m["lam"], -2.0, 2.0))
            for name in ("gate_a_w", "gate_a_b", "gate_x_w", "gate_x_b"):
                m[name].copy_(normal(m[name], 0.5))


# ------------------------------------------------------------------ phase 2

def time_ms(fn, iters=ITERS):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_cold_ms(fn, iters=ITERS):
    """Mean time of one call with L2 flushed before it (the flush lies
    outside the timed interval), for comparison with the HBM-rate bound."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def _replay_ms(calls, iters):
    """Milliseconds of one replay of a CUDA graph of ``iters`` calls."""
    for _ in range(3):
        calls()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            calls()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def graph_ms(fn, iters=ITERS):
    """Mean device time of one call, the calls replayed from a CUDA graph:
    no host time lies between them, where ``time_ms`` of a call shorter
    than its wrapper's host work reads the host."""
    return _replay_ms(fn, iters) / iters


def graph_cold_ms(fn, iters=ITERS):
    """``graph_ms`` with L2 flushed before each call: the graph of (flush,
    call) pairs less the graph of the flushes alone."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def flushed():
        flush.zero_()
        fn()
    return (_replay_ms(flushed, iters) - _replay_ms(flush.zero_, iters)) / iters


def decode_splits(b, hkv, cap):
    """flash_decode's bf16 blocks per (row, KV head) at these shapes on
    this card."""
    return decode_attention.decode_splits(
        b, hkv, cap, torch.cuda.get_device_properties(0).multi_processor_count)


def ssd_p_splits(b, h=64):
    """ssd_scan's bf16 blocks per (row, head) at these shapes on this card."""
    return ssd_scan_mod.ssd_splits(b, h, build.sm_count(0))


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _max_err(got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    return err.max().item(), (err / (1 + want.abs())).max().item()


def phase_kernels(device):
    g = torch.Generator(device=device).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device).to(bf16)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}

    # flash_mha: the prefill shape of this slice, then a window, explicit
    # arange positions (the no-skip path) and verify-style positions with a
    # row that has no valid key
    b, s, hq, hkv, d = 4, 512, 14, 2, 64
    q, k, v = randn(b, s, hq, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
    pos = torch.arange(s, device=device)[None]
    kv_pos = torch.stack([torch.randperm(s, generator=g, device=device)
                          for _ in range(2)])
    q_pos = torch.tensor([[500, 501, 502, 503], [-1, 100, 200, 300]], device=device)
    cases = [
        ("causal", (q, k, v), dict(causal=True)),
        ("window128", (q, k, v), dict(causal=True, window=128)),
        ("arange-positions", (q, k, v), dict(causal=True, q_positions=pos, kv_positions=pos)),
        ("verify-positions", (randn(2, 4, hq, d), k[:2].contiguous(), v[:2].contiguous()),
         dict(causal=True, q_positions=q_pos, kv_positions=kv_pos)),
    ]
    errs = []
    for name, args, kw in cases:
        got = flash_mha(*args, **kw)
        want = ref.mha_ref(*args, **kw)
        torch.cuda.synchronize()
        abs_err, rel_err = _max_err(got, want)
        print(f"[kernels] flash_mha {name}: max_abs_err={abs_err:.3e} scaled_err={rel_err:.3e}")
        check(rel_err <= KERNEL_TOL, f"flash_mha {name}: err {rel_err} > {KERNEL_TOL}")
        errs.append(abs_err)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pairs = b * hq * s * (s + 1) // 2
    bms, by = bound_ms(4 * d * pairs, 2 * (2 * q.numel() + 2 * k.numel()))
    out["flash_mha"] = dict(
        max_abs_err=max(errs), library="scaled_dot_product_attention",
        ms=graph_ms(lambda: flash_mha(q, k, v, causal=True)),
        cold_ms=graph_cold_ms(lambda: flash_mha(q, k, v, causal=True)),
        eager_ms=time_ms(lambda: flash_mha(q, k, v, causal=True)),
        plain_ms=time_ms(lambda: ref.mha_ref(q, k, v, causal=True)),
        bound_ms=bms, bound_by=by,
        library_ms=graph_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)))
    out["flash_mha"]["d256"] = mha_d256_case(randn, device)

    # flash_decode: 8 rows over a 1088-slot linear cache with ragged
    # lengths, then a ring cache (window 256) with a row of length 0
    b, c = 8, 1088
    q, kc, vc = randn(b, hq, d), randn(b, c, hkv, d), randn(b, c, hkv, d)
    lens = torch.tensor([1, 17, 64, 65, 400, 777, 1000, 1088], dtype=torch.int32,
                        device=device)
    ring_k, ring_v = randn(b, 256, hkv, d), randn(b, 256, hkv, d)
    ring_lens = torch.tensor([0, 1, 100, 255, 256, 257, 1000, 3000], dtype=torch.int32,
                             device=device)
    cases = [("linear", (q, kc, vc), dict(cache_len=lens)),
             ("ring256", (q, ring_k, ring_v), dict(cache_len=ring_lens, window=256))]
    errs = []
    for name, args, kw in cases:
        got = flash_decode(*args, **kw)
        want = ref.decode_mha_ref(*args, **kw)
        torch.cuda.synchronize()
        abs_err, rel_err = _max_err(got, want)
        print(f"[kernels] flash_decode {name}: max_abs_err={abs_err:.3e} scaled_err={rel_err:.3e}")
        check(rel_err <= KERNEL_TOL, f"flash_decode {name}: err {rel_err} > {KERNEL_TOL}")
        errs.append(abs_err)
    n_keys = int(lens.sum())
    bms, by = bound_ms(4 * d * hq * n_keys, 2 * (2 * q.numel() + 2 * n_keys * hkv * d))
    qs = q[:, :, None]
    ks, vs = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = (torch.arange(c, device=device)[None] < lens[:, None])[:, None, None]
    out["flash_decode"] = dict(
        max_abs_err=max(errs), library="scaled_dot_product_attention",
        ms=graph_ms(lambda: flash_decode(q, kc, vc, cache_len=lens)),
        cold_ms=graph_cold_ms(lambda: flash_decode(q, kc, vc, cache_len=lens)),
        eager_ms=time_ms(lambda: flash_decode(q, kc, vc, cache_len=lens)),
        plain_ms=time_ms(lambda: ref.decode_mha_ref(q, kc, vc, cache_len=lens)),
        bound_ms=bms, bound_by=by, splits=decode_splits(b, hkv, c),
        library_ms=graph_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True)))
    out["flash_decode"]["d256"] = decode_d256_case(randn, device)
    out["paged_flash_decode"] = paged_kernel_case(randn, device, hq, hkv, d)
    out["grouped_ffn"] = grouped_kernel_case(device)
    out["ssd_scan"] = ssd_kernel_case(device)
    out["rglru_scan"] = rglru_kernel_case(device)
    out["flash_mha_varlen"] = varlen_kernel_case(device)
    for name, info in (("flash_mha D64 bf16 tile body", flash_attention.kernel_info(64)),
                       ("flash_mha D256 bf16 tile body", flash_attention.kernel_info(256)),
                       ("flash_mha_varlen D64 bf16 tile body", varlen_attention.kernel_info(64)),
                       ("flash_decode D64 bf16 split body", decode_attention.kernel_info(64)),
                       ("flash_decode D256 bf16 split body", decode_attention.kernel_info(256)),
                       ("grouped_ffn bf16 launch A (H)", grouped_expert.kernel_info(0)),
                       ("grouped_ffn bf16 launch B (out)", grouped_expert.kernel_info(1)),
                       ("paged_flash_decode D64 bf16 split body",
                        paged_decode_attention.kernel_info(64)),
                       *((f"ssd_scan bf16 tensor-core body, p_splits {ps}",
                          ssd_scan_mod.kernel_info(ps)) for ps in ssd_scan_mod.P_SPLITS)):
        print(f"[kernels] {name}: {info['registers']} registers, "
              f"{info['spill_bytes']} spill bytes, {info['smem_bytes']} bytes of shared "
              f"memory, {info['blocks_per_sm']} blocks per SM")
    for name, shape in (("qwen2-0.5b BatchServer (B 8, Hkv 2, C 1088)", (8, 2, 1088)),
                        ("qwen2-0.5b PPO rollout (B 16, Hkv 2, C 384)", (16, 2, 384)),
                        ("recurrentgemma-9b (B 8, Hkv 1, ring 576)", (8, 1, 576))):
        print(f"[kernels] flash_decode splits at {name}: {decode_splits(*shape)} blocks per "
              "(row, KV head)")
    for name, shape in (("qwen2-0.5b continuous (B 8, Hkv 2, M 36 x bs 16)", (8, 2, 576)),
                        ("granite-moe-1b-a400m continuous (B 8, Hkv 8, M 36 x bs 16)",
                         (8, 8, 576))):
        print(f"[kernels] paged_flash_decode splits at {name}: {decode_splits(*shape)} blocks "
              "per (row, KV head)")
    print("[kernels] ssd_scan p_splits at mamba2-1.3b's admissions (H 64): "
          + ", ".join(f"B {b}: {ssd_p_splits(b)}" for b in (1, 2, 4, 8)))
    guard_case(device)
    for name, r in out.items():
        for shape, t in [("", r)] + [(f" {k}", v) for k, v in r.items() if isinstance(v, dict)]:
            lib = ("none" if t["library_ms"] is None
                   else f"{t['library_ms']:.4f} ({t['library']})")
            eager = (f" eager_ms={t['eager_ms']:.4f} (host-paced loop)" if "eager_ms" in t
                     else "")
            eager += f" splits={t['splits']}" if "splits" in t else ""
            eager += f" p_splits={t['p_splits']}" if "p_splits" in t else ""
            print(f"[kernels] {name}{shape}: ms={t['ms']:.4f} (warm L2) cold_ms="
                  f"{t['cold_ms']:.4f} (L2 flushed){eager} plain_ms={t['plain_ms']:.4f} "
                  f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}) library_ms={lib}")
    return out


def held(name, got, want, tol=KERNEL_TOL):
    """Synchronise, print and check one kernel-vs-plain comparison; returns
    the max absolute error."""
    torch.cuda.synchronize()
    abs_err, rel_err = _max_err(got, want)
    print(f"[kernels] {name}: max_abs_err={abs_err:.3e} scaled_err={rel_err:.3e} (tol {tol})")
    check(rel_err <= tol, f"{name}: err {rel_err} > {tol}")
    return abs_err


def mha_d256_case(randn, device):
    """flash_mha at recurrentgemma-9b's prefill shape: B 4, S 512, 16 query
    heads on 1 KV head, D 256, the model's window 2048 (wider than S) and a
    window of 128; timed with the model's window."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, s, hq, hkv, d = 4, 512, 16, 1, 256
    q, k, v = randn(b, s, hq, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
    errs = [held(f"flash_mha d256 window{w}", flash_mha(q, k, v, causal=True, window=w),
                 ref.mha_ref(q, k, v, causal=True, window=w)) for w in (2048, 128)]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pairs = b * hq * s * (s + 1) // 2
    bms, by = bound_ms(4 * d * pairs, 2 * (2 * q.numel() + 2 * k.numel()))
    return dict(max_abs_err=max(errs), library="scaled_dot_product_attention",
                ms=graph_ms(lambda: flash_mha(q, k, v, causal=True, window=2048)),
                cold_ms=graph_cold_ms(lambda: flash_mha(q, k, v, causal=True, window=2048)),
                eager_ms=time_ms(lambda: flash_mha(q, k, v, causal=True, window=2048)),
                plain_ms=time_ms(lambda: ref.mha_ref(q, k, v, causal=True, window=2048)),
                bound_ms=bms, bound_by=by,
                library_ms=graph_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True)))


def decode_d256_case(randn, device):
    """flash_decode at recurrentgemma-9b's decode shape: 8 rows of 16 query
    heads on 1 KV head (G = 16), D 256, over the 576-slot ring of a
    576-token budget (window 2048), ragged lengths with a row of 0 and rows
    past the ring's length."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, c, hq, d = 8, 576, 16, 256
    q, kc, vc = randn(b, hq, d), randn(b, c, 1, d), randn(b, c, 1, d)
    lens = torch.tensor([0, 1, 64, 200, 333, 575, 576, 900], dtype=torch.int32,
                        device=device)
    err = held("flash_decode d256 ring576", flash_decode(q, kc, vc, cache_len=lens, window=2048),
               ref.decode_mha_ref(q, kc, vc, cache_len=lens, window=2048))
    n_keys = int(torch.where(lens > 0, lens.clamp(max=c), c).sum())
    bms, by = bound_ms(4 * d * hq * n_keys, 2 * (2 * q.numel() + 2 * n_keys * d))
    ks, vs = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    valid = torch.arange(c, device=device)[None] < lens.clamp(max=c)[:, None]
    mask = (valid | (lens[:, None] == 0))[:, None, None]

    def kernel():
        return flash_decode(q, kc, vc, cache_len=lens, window=2048)
    return dict(max_abs_err=err, library="scaled_dot_product_attention",
                ms=graph_ms(kernel), cold_ms=graph_cold_ms(kernel), eager_ms=time_ms(kernel),
                plain_ms=time_ms(lambda: ref.decode_mha_ref(q, kc, vc, cache_len=lens,
                                                            window=2048)),
                bound_ms=bms, bound_by=by, splits=decode_splits(b, 1, c),
                library_ms=graph_ms(lambda: sdpa(q[:, :, None], ks, vs, attn_mask=mask,
                                                 enable_gqa=True)))


SSD_H, SSD_P, SSD_N, SSD_CHUNK = 64, 64, 128, 128  # mamba2-1.3b
# (name, B, S, dtype): an admission of 4 rows of 512 tokens; 1 row of 200
# tokens padded to 256 (a ragged last piece); fp32
SSD_CASES = (("bf16-B4-S512", 4, 512, torch.bfloat16), ("bf16-B1-S256", 1, 256, torch.bfloat16),
             ("fp32-B2-S384", 2, 384, torch.float32))


def ssd_inputs(g, b, s, dtype, device):
    """ssd_scan's inputs at mamba2-1.3b's widths with the layer's
    distributions: dt log-uniform in [1e-3, 1e-1], A in [-16, -1]."""
    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)
    dt = torch.exp(torch.rand((b, s, SSD_H), generator=g, device=device)
                   * math.log(100.0) + math.log(1e-3))
    a_log = torch.rand((SSD_H,), generator=g, device=device) * math.log(16.0)
    return (randn(b, s, SSD_H, SSD_P).to(dtype), dt, a_log, randn(b, s, SSD_N).to(dtype),
            randn(b, s, SSD_N).to(dtype),
            torch.rand((SSD_H,), generator=g, device=device) + 0.5)


def ssd_cases(device):
    """SSD_CASES' inputs, drawn in order from one seed; rows past 200 of the
    ragged case are the pad's exact no-ops (dt = 0)."""
    g = torch.Generator(device=device).manual_seed(3)
    out = {}
    for name, b, s, dtype in SSD_CASES:
        args = ssd_inputs(g, b, s, dtype, device)
        if name == "bf16-B1-S256":
            args = (args[0], torch.where(torch.arange(s, device=device)[None, :, None] < 200,
                                         args[1], 0.0)) + args[2:]
        out[name] = args
    return out, g


def ssd_kernel_case(device):
    """ssd_scan at mamba2-1.3b's widths on SSD_CASES, each held against the
    plain version in fp32 on the same values: y within SSD_BF16_TOL in bf16
    (it rounds once) and FP32_SCAN_TOL in fp32, the state within
    FP32_SCAN_TOL.  Timed at an admission of 4 rows of 512 tokens and, as
    ``b1_s256``, of 1 row of 256, kernel from CUDA-graph replays (the
    eager loop kept as ``eager_ms``).  Bound: the bytes of x, dt, B, C, y
    and the final state, against the flops of the chunked algorithm at the
    model's chunk (C.B^T, its product with x, C.state and the state update
    per chunk)."""
    cases, g = ssd_cases(device)
    errs = []
    for name, args in cases.items():
        y, st = ssd_scan(*args, chunk=SSD_CHUNK, return_state=True)
        want_y, want_st = ref.ssd_ref(*(t.float() for t in args), chunk=SSD_CHUNK,
                                      return_state=True)
        tol = SSD_BF16_TOL if args[0].dtype == torch.bfloat16 else FP32_SCAN_TOL
        errs.append(held(f"ssd_scan {name} y", y, want_y, tol))
        held(f"ssd_scan {name} state", st, want_st, FP32_SCAN_TOL)

    def timed(b, s):
        h, p, n, chunk = SSD_H, SSD_P, SSD_N, SSD_CHUNK
        args = ssd_inputs(g, b, s, torch.bfloat16, device)
        nc = s // chunk
        flops = 2 * b * nc * h * (chunk * chunk * n + chunk * chunk * p + 2 * chunk * n * p)
        nbytes = (2 * 2 * b * s * h * p + 4 * b * s * h + 2 * 2 * b * s * n + 4 * 2 * h
                  + 4 * b * h * p * n)
        bms, by = bound_ms(flops, nbytes)

        def kernel():
            return ssd_scan(*args, chunk=chunk, return_state=True)
        return dict(library=None, library_ms=None, ms=graph_ms(kernel),
                    cold_ms=graph_cold_ms(kernel), eager_ms=time_ms(kernel),
                    plain_ms=time_ms(lambda: ref.ssd_ref(*args, chunk=chunk,
                                                         return_state=True)),
                    bound_ms=bms, bound_by=by, p_splits=ssd_p_splits(b))
    out = dict(max_abs_err=max(errs), **timed(4, 512))
    out["b1_s256"] = timed(1, 256)
    return out


def rglru_kernel_case(device):
    """rglru_scan at recurrentgemma-9b's width (W 4096) on an admission of 4
    rows of 512 tokens, fp32 (the model's gates are fp32), with decays drawn
    as the layer draws them; then a ragged 3 x 77 x 1000.  Bound: a, bx
    read and h written once, plus the final state."""
    g = torch.Generator(device=device).manual_seed(4)

    def inputs(b, s, w):
        a = torch.exp(-8.0 * torch.rand((b, s, w), generator=g, device=device)
                      * math.log1p(math.e ** 2))  # log a = -8 r softplus(lam), lam <= 2
        return a, torch.randn((b, s, w), generator=g, device=device)

    errs = []
    for name, shape in (("fp32-B4-S512", (4, 512, 4096)), ("fp32-B3-S77-W1000", (3, 77, 1000))):
        a, bx = inputs(*shape)
        h, final = rglru_scan(a, bx)
        want_h, want_final = ref.rglru_scan_ref(a, bx)
        errs.append(held(f"rglru_scan {name} h", h, want_h, FP32_TOL))
        held(f"rglru_scan {name} final", final, want_final, FP32_TOL)
    b, s, w = 4, 512, 4096
    a, bx = inputs(b, s, w)
    bms, by = bound_ms(2 * b * s * w, 4 * 3 * b * s * w + 4 * b * w)
    return dict(max_abs_err=max(errs), library=None, library_ms=None,
                ms=time_ms(lambda: rglru_scan(a, bx)),
                cold_ms=time_cold_ms(lambda: rglru_scan(a, bx)),
                plain_ms=time_ms(lambda: ref.rglru_scan_ref(a, bx)),
                bound_ms=bms, bound_by=by)


def varlen_lengths(rng, n=8, longest=512, bucket=64):
    """``n`` seeded sequence lengths in [1, longest], one of them 1 and all
    but that one off the 64-row grid, and the bucketed token total with a
    phantom tail, as ``pack_minibatches`` makes it."""
    lens = rng.integers(2, longest + 1, n)
    lens[rng.integers(n)] = 1
    lens = np.where((lens % 64 == 0) & (lens > 1), lens - 1, lens)
    t = packing.bucket_total(int(lens.sum()), bucket)
    return lens, t if t > lens.sum() else t + bucket


def varlen_kernel_case(device):
    """flash_mha_varlen at qwen2-0.5b's attention shapes (Hq 14, Hkv 2, D
    64) on a packed minibatch of 8 seeded sequences of 1-512 tokens with a
    phantom tail: causal and window 128 in bf16 (KERNEL_TOL) and fp32
    (FP32_TOL) against the plain version; equal segments against flash_mha
    on the (B, S) layout (the same bits); one sequence perturbed, every
    other row the same bits; the Function's dq, dk, dv against autograd of
    the plain version (FP32_TOL in fp32, KERNEL_TOL in bf16).  Timed on the
    bf16 causal case.  Bound: 4 D Hq flops per causal pair of every segment
    (the phantom segment too), q, k, v read and o written once.  Library:
    SDPA with the dense (T, T) block-diagonal causal boolean mask."""
    g = torch.Generator(device=device).manual_seed(5)
    hq, hkv, d = 14, 2, 64
    lens, t = varlen_lengths(np.random.default_rng(5))
    longest = int(max(lens.max(), t - lens.sum()))
    cu = torch.from_numpy(packing.cu_seqlens_of(lens)).to(device)
    print(f"[kernels] flash_mha_varlen lengths {lens.tolist()} in T {t} "
          f"({t - int(lens.sum())} phantom tokens)")

    def inputs(dtype, tokens=t):
        return tuple(torch.randn((tokens, h, d), generator=g, device=device).to(dtype)
                     for h in (hq, hkv, hkv))

    qkv = {dt: inputs(dt) for dt in (torch.bfloat16, torch.float32)}
    errs = []
    for dt, tol in ((torch.bfloat16, KERNEL_TOL), (torch.float32, FP32_TOL)):
        for window in (None, 128):
            got = flash_mha_varlen(*qkv[dt], cu, window=window)
            want = ref.mha_varlen_ref(*qkv[dt], cu, window=window, max_seqlen=longest)
            errs.append(held(f"flash_mha_varlen {str(dt)[6:]} window{window}", got, want, tol))

    b, s = 4, 512  # equal segments: the tiles flash_mha walks on (B, S)
    q, k, v = inputs(torch.bfloat16, b * s)
    cu_eq = torch.arange(0, b * s + 1, s, dtype=torch.int32, device=device)
    diff = (flash_mha_varlen(q, k, v, cu_eq).view(b, s, hq, d).float()
            - flash_mha(q.view(b, s, hq, d), k.view(b, s, hkv, d), v.view(b, s, hkv, d),
                        causal=True).float()).abs().max().item()
    print(f"[kernels] flash_mha_varlen 4 equal segments of 512 vs flash_mha on (4, 512): "
          f"max_abs_diff={diff:.3e}")
    check(diff == 0.0, "flash_mha_varlen: equal segments differ from flash_mha")

    q, k, v = qkv[torch.bfloat16]
    j = 2
    sl = slice(int(cu[j]), int(cu[j + 1]))
    q2, k2, v2 = q.clone(), k.clone(), v.clone()
    q2[sl] += 3.0
    k2[sl] -= 2.0
    v2[sl] *= 5.0
    base, pert = flash_mha_varlen(q, k, v, cu), flash_mha_varlen(q2, k2, v2, cu)
    keep = torch.ones(t, dtype=torch.bool, device=device)
    keep[sl] = False
    torch.cuda.synchronize()
    same = bool(torch.equal(base[keep], pert[keep]))
    print(f"[kernels] flash_mha_varlen leakage: sequence {j} ({sl.stop - sl.start} tokens) "
          f"perturbed, the other {int(keep.sum())} rows bit-identical: {same}")
    check(same and not torch.equal(base[sl], pert[sl]), "flash_mha_varlen leaks across "
          "sequences")

    w = torch.randn((t, hq, d), generator=g, device=device)
    for dt, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, KERNEL_TOL)):
        grads = []
        for fn in (flash_mha_varlen, ref.mha_varlen_ref):
            leaves = [x.clone().requires_grad_(True) for x in qkv[dt]]
            (fn(*leaves, cu, max_seqlen=longest).float() * w).sum().backward()
            grads.append([x.grad for x in leaves])
        for name, got, want in zip("qkv", *grads):
            held(f"flash_mha_varlen {str(dt)[6:]} d{name} (the Function vs autograd of the "
                 "plain version)", got, want, tol)

    q, k, v = qkv[torch.bfloat16]
    seg = packing.segment_ids_of(cu, t)
    pos = torch.arange(t, device=device)
    pairs = sum(n * (n + 1) // 2 for n in lens.tolist() + [t - int(lens.sum())])
    bms, by = bound_ms(4 * d * hq * pairs, 2 * (2 * q.numel() + 2 * k.numel()))
    mask = (seg[:, None] == seg[None, :]) & (pos[None, :] <= pos[:, None])
    qt, kt, vt = (x.transpose(0, 1)[None].contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return dict(max_abs_err=max(errs), equal_segment_max_abs_diff=diff,
                library="scaled_dot_product_attention, dense (T, T) block-diagonal causal mask",
                ms=graph_ms(lambda: flash_mha_varlen(q, k, v, cu)),
                cold_ms=graph_cold_ms(lambda: flash_mha_varlen(q, k, v, cu)),
                eager_ms=time_ms(lambda: flash_mha_varlen(q, k, v, cu)),
                plain_ms=time_ms(lambda: ref.mha_varlen_ref(q, k, v, cu, max_seqlen=longest)),
                bound_ms=bms, bound_by=by,
                library_ms=graph_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)),
                tokens=t, causal_pairs=pairs)


def guard_case(device):
    """A kernel without a backward (flash_decode) refuses an input that
    requires grad under grad mode (NotImplementedError), and runs under
    no_grad."""
    x = torch.randn((1, 14, 64), device=device, requires_grad=True)
    kv = torch.randn((1, 64, 2, 64), device=device)
    cl = torch.tensor([64], dtype=torch.int32, device=device)
    before = flash_decode.launches
    try:
        flash_decode(x, kv, kv, cache_len=cl)
        raised = False
    except NotImplementedError as exc:
        raised = True
        print(f"[kernels] guard: flash_decode under grad raises NotImplementedError: {exc}")
    with torch.no_grad():
        flash_decode(x, kv, kv, cache_len=cl)
    check(raised and flash_decode.launches == before + 1,
          "flash_decode launched on an input that requires grad")


def paged_kernel_case(randn, device, hq, hkv, d):
    """paged_flash_decode at the continuous engine's decode shapes: 8 rows,
    blocks of 16, a 36-block table into a shuffled pool of 1 + 8 * 36
    blocks, ragged cache lengths with a row of 0 and one of M * bs; then
    the table past each live prefix pointed at a poisoned block 0, and
    blocks of 8.  Each held against the plain version (KERNEL_TOL) and, in
    bf16 and on the same values in fp32, bit for bit against flash_decode
    on the gathered cache: with M * bs == C both run the same body (bf16:
    the split-KV grid with the same splits; fp32: the FMA walk) on the same
    key values.  Kernel and library call timed from CUDA-graph replays (the
    eager loop kept as ``eager_ms``)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=device).manual_seed(1)
    b, bs, m = 8, 16, 36
    q = randn(b, hq, d)
    lens = torch.tensor([0, 1, 17, 64, 100, 333, 500, m * bs], dtype=torch.int32,
                        device=device)

    def pool(bs, m):
        n = 1 + b * m
        table = (torch.randperm(n - 1, generator=g, device=device) + 1).reshape(b, m)
        return randn(n, bs, hkv, d), randn(n, bs, hkv, d), table.to(torch.int32)

    k_pool, v_pool, table = pool(bs, m)
    live = torch.arange(m, device=device)[None] < (lens[:, None] + bs - 1) // bs
    k_poison, v_poison = k_pool.clone(), v_pool.clone()
    k_poison[0], v_poison[0] = 1e4, -1e4
    k8, v8, table8 = pool(8, 2 * m)
    cases = [("shuffled", (q, k_pool, v_pool, table)),
             ("poisoned-block0", (q, k_poison, v_poison,
                                  torch.where(live, table, 0).to(torch.int32))),
             ("bs8", (q, k8, v8, table8))]
    errs = []
    for name, args in cases:
        got = paged_flash_decode(*args, cache_len=lens)
        want = ref.paged_decode_mha_ref(*args, cache_len=lens)
        torch.cuda.synchronize()
        abs_err, rel_err = _max_err(got, want)
        print(f"[kernels] paged_flash_decode {name}: max_abs_err={abs_err:.3e} "
              f"scaled_err={rel_err:.3e} (tol {KERNEL_TOL})")
        check(rel_err <= KERNEL_TOL, f"paged_flash_decode {name}: err {rel_err} > {KERNEL_TOL}")
        errs.append(abs_err)
        qq, kp, vp, tbl = args
        for dtype in (torch.bfloat16, torch.float32):
            qd, kd, vd = (t.to(dtype) for t in (qq, kp, vp))
            paged = got if dtype == torch.bfloat16 else paged_flash_decode(qd, kd, vd, tbl,
                                                                           cache_len=lens)
            gathered = [p[tbl.long()].reshape(b, -1, hkv, d) for p in (kd, vd)]
            dense = flash_decode(qd, *gathered, cache_len=lens)
            torch.cuda.synchronize()
            diff = (paged.float() - dense.float()).abs().max().item()
            print(f"[kernels] paged_flash_decode {name} {str(dtype)[6:]} vs flash_decode on "
                  f"the gathered cache: max_abs_diff={diff:.3e} (must be 0: the same bits)")
            check(torch.equal(paged, dense), f"paged_flash_decode {name} {dtype}: not "
                  "flash_decode's bits on the gathered cache")
    # keys walked: a row of length 0 averages all M * bs slots
    n_keys = int(torch.where(lens > 0, lens, m * bs).sum())
    nbytes = (2 * (2 * q.numel() + 2 * n_keys * hkv * d)
              + 4 * (table.numel() + lens.numel()))
    bms, by = bound_ms(4 * d * hq * n_keys, nbytes)
    mask = (torch.arange(m * bs, device=device)[None] < lens[:, None])[:, None, None]
    tl = table.long()

    def library():  # gather the table's blocks, then SDPA with a length mask
        kg = k_pool[tl].reshape(b, m * bs, hkv, d).transpose(1, 2)
        vg = v_pool[tl].reshape(b, m * bs, hkv, d).transpose(1, 2)
        return sdpa(q[:, :, None], kg, vg, attn_mask=mask, enable_gqa=True)

    def kernel():
        return paged_flash_decode(q, k_pool, v_pool, table, cache_len=lens)
    return dict(
        max_abs_err=max(errs), library="table gather + scaled_dot_product_attention",
        ms=graph_ms(kernel), cold_ms=graph_cold_ms(kernel), eager_ms=time_ms(kernel),
        plain_ms=time_ms(lambda: ref.paged_decode_mha_ref(q, k_pool, v_pool, table,
                                                          cache_len=lens)),
        bound_ms=bms, bound_by=by, splits=decode_splits(b, hkv, m * bs),
        library_ms=graph_ms(library))


def routed_rows(x, router_w, k):
    """Tokens ``x`` (T, D) under a top-``k`` router ``router_w`` (D, E),
    fp32: (expert-sorted rows (T*k, D), group_sizes (E,) int32, the token
    of each sorted row), as the dropless dispatch builds them."""
    top_i = torch.topk(x.float() @ router_w, k, dim=-1).indices
    _, st = MOE._sort_by_expert(top_i, k)
    return x[st].contiguous(), MOE._group_sizes(top_i, router_w.shape[1]), st


def grouped_library(xs, gs, wg, wi, wo):
    """The closest PyTorch yardstick of grouped_ffn (no single call computes
    the fused function): ``torch._grouped_mm`` for the three products with
    silu between, in bf16, where this torch has it and takes these inputs;
    else a loop of per-expert bf16 matmuls.  Timed only.  Returns (fn,
    name)."""
    silu = torch.nn.functional.silu
    if hasattr(torch, "_grouped_mm"):
        offs = torch.cumsum(gs, 0, dtype=torch.int32)

        def fn():
            h = (silu(torch._grouped_mm(xs, wg, offs=offs))
                 * torch._grouped_mm(xs, wi, offs=offs))
            return torch._grouped_mm(h, wo, offs=offs)
        try:
            fn()
            torch.cuda.synchronize()
            return fn, "torch._grouped_mm x3 + silu, bf16"
        except RuntimeError as exc:
            print(f"[kernels] torch._grouped_mm refuses the inputs: "
                  f"{str(exc).splitlines()[0][:120]}")
    sizes = gs.tolist()

    def loop():
        outs, lo = [], 0
        for e, n in enumerate(sizes):
            if n:
                x = xs[lo:lo + n]
                outs.append((silu(x @ wg[e]) * (x @ wi[e])) @ wo[e])
            lo += n
        return torch.cat(outs)
    return loop, "per-expert torch.matmul loop + silu, bf16"


def grouped_kernel_case(device):
    """grouped_ffn at granite-moe-1b-a400m's widths (32 experts, D 1024,
    F 512, silu) with rows routed by a random fp32 router, top-8: a decode
    step of 8 slots (N 64) and an admission prefill of 4 x 256 tokens
    (N 8192) in bf16, the decode step in fp32, and edge cases (all rows to
    one expert, groups straddling 64-row tiles with empty experts, N not a
    multiple of the tile, rows past the total).  Then rows of the prefill
    cohort alone in a 64-row cohort: their outputs must be the same bits.
    Times the decode shape (the JSON row) and the prefill shape, then the
    sweep over N."""
    g = torch.Generator(device=device).manual_seed(2)
    bf16 = torch.bfloat16
    e, d, f, k = 32, 1024, 512, 8

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale

    w32 = (randn(e, d, f, scale=d ** -0.5), randn(e, d, f, scale=d ** -0.5),
           randn(e, f, d, scale=f ** -0.5))
    wb = tuple(w.to(bf16) for w in w32)
    router = randn(d, e, scale=d ** -0.5)
    x_dec, x_pre = randn(8, d), randn(4 * 256, d)
    xs_dec, gs_dec, _ = routed_rows(x_dec.to(bf16), router, k)
    xs_pre, gs_pre, st_pre = routed_rows(x_pre.to(bf16), router, k)
    xs_dec32, gs_dec32, _ = routed_rows(x_dec, router, k)

    def sizes(n, parts):
        gs = torch.zeros(e, dtype=torch.int32, device=device)
        for i, m in parts.items():
            gs[i] = m
        return randn(n, d).to(bf16), gs

    spread = {i: 0 if i % 5 == 2 else 11 + 13 * (i % 7) for i in range(e)}
    straddle = sizes(sum(spread.values()), spread)  # 64-row tiles, empty experts
    tail = sizes(100, {0: 15, 3: 50, 31: 30})       # 100 rows, 95 in groups
    cases = [("decode-N64", xs_dec, gs_dec, wb, GROUPED_TOL),
             ("prefill-N8192", xs_pre, gs_pre, wb, GROUPED_TOL),
             ("decode-N64-fp32", xs_dec32, gs_dec32, w32, FP32_TOL),
             ("all-to-one-N40", *sizes(40, {17: 40}), wb, GROUPED_TOL),
             (f"straddle-N{int(straddle[1].sum())}", *straddle, wb, GROUPED_TOL),
             ("tail-N100", *tail, wb, GROUPED_TOL)]
    errs, outs = [], {}
    for name, xs, gs, ws, tol in cases:
        got = grouped_ffn(xs, gs, *ws)
        want = ref.grouped_ffn_ref(xs, gs, *ws)
        torch.cuda.synchronize()
        abs_err, rel_err = _max_err(got, want)
        print(f"[kernels] grouped_ffn {name} (empty experts {int((gs == 0).sum())}): "
              f"max_abs_err={abs_err:.3e} scaled_err={rel_err:.3e} (tol {tol})")
        check(rel_err <= tol, f"grouped_ffn {name}: err {rel_err} > {tol}")
        errs.append(abs_err)
        outs[name] = got
    total = int(tail[1].sum())
    check(bool((outs["tail-N100"][total:] == 0).all()), "grouped_ffn: rows past the total "
          "are not zero")

    # the rows of the prefill cohort's first 8 tokens, alone
    rows = torch.nonzero(st_pre < 8)[:, 0]
    eid = ref.expert_ids_of(gs_pre, xs_pre.shape[0])[rows].long()
    gs_sub = torch.zeros(e, dtype=torch.int32, device=device).scatter_add_(
        0, eid, torch.ones_like(eid, dtype=torch.int32))
    alone = grouped_ffn(xs_pre[rows].contiguous(), gs_sub, *wb)
    cohort_diff = (alone - outs["prefill-N8192"][rows]).abs().max().item()
    print(f"[kernels] grouped_ffn cohort independence: {rows.numel()} rows in the "
          f"{xs_pre.shape[0]}-row cohort vs alone, max_abs_diff={cohort_diff:.3e}")
    check(cohort_diff == 0.0, "grouped_ffn: a row's output depends on its cohort")

    def timed(xs, gs):
        hit = int((gs > 0).sum())
        n = xs.shape[0]
        nbytes = hit * 3 * d * f * 2 + n * d * 2 + n * d * 4 + e * 4
        bms, by = bound_ms(6 * n * d * f, nbytes)
        lib, lib_name = grouped_library(xs, gs, *wb)

        def kernel():
            return grouped_ffn(xs, gs, *wb)
        return dict(ms=graph_ms(kernel), cold_ms=graph_cold_ms(kernel), eager_ms=time_ms(kernel),
                    plain_ms=time_ms(lambda: ref.grouped_ffn_ref(xs, gs, *wb)),
                    bound_ms=bms, bound_by=by, library_ms=graph_ms(lib), library=lib_name,
                    n_rows=n, experts_hit=hit)

    out = timed(xs_dec, gs_dec)
    out["prefill"] = timed(xs_pre, gs_pre)
    out.update(max_abs_err=max(errs), cohort_max_abs_diff=cohort_diff)
    n_sweep(x_pre, router, k, wb)
    return out


def n_sweep(x, router, k, wb):
    """Print grouped_ffn's time over the first t tokens' routed rows (N = k
    * t, 8 to 1,024 tokens) beside the library call's, both from CUDA-graph
    replays, with the rate at which the kernel reads the hit experts'
    weights (each read once: the bound's bytes)."""
    e, d, f = wb[0].shape
    for t in (8, 32, 128, 256, 512, 1024):
        xs, gs, _ = routed_rows(x[:t].to(torch.bfloat16), router, k)
        hit = int((gs > 0).sum())
        lib, lib_name = grouped_library(xs, gs, *wb)
        ms = graph_ms(lambda: grouped_ffn(xs, gs, *wb))
        print(f"[kernels] grouped_ffn at N {xs.shape[0]} ({t} tokens, {hit} experts hit): "
              f"{ms:.4f} ms, {hit * 3 * d * f * 2 / ms / 1e9:.3f} TB/s of weights; "
              f"{lib_name} {graph_ms(lib):.4f} ms")


# ------------------------------------------------------------------ phase 3

def phase_slice(cfg, params, *, impl, batch=4, prompt_len=256, steps=8, seed=0):
    """Prefill last-position logits and ``steps`` teacher-forced decode
    steps under ``impl`` and under "reference", on the same tokens.
    Returns the scaled errors and the argmax agreement."""
    device = params["embed"]["table"].device
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (batch, prompt_len))).to(device)
    feed = torch.from_numpy(rng.integers(1, cfg.vocab_size, (batch, steps))).to(device)
    logits = {}
    for name in dict.fromkeys((impl, "reference")):
        last, caches = MDL.prefill(params, cfg, {"tokens": toks}, prompt_len + steps,
                                   impl=name)
        out = [MDL.logits_of(params, cfg, last[:, None])[:, 0]]
        for i in range(steps):
            lg, caches = MDL.decode_step(params, cfg, feed[:, i], caches,
                                         prompt_len + i, impl=name)
            out.append(lg)
        logits[name] = torch.stack(out, dim=1)  # (B, steps + 1, V)
        del caches
    got, want = logits[impl], logits["reference"]
    check(bool(torch.isfinite(got).all()), "non-finite logits")
    scale = want.abs().amax().item()
    err = (got - want).abs()
    return {"prefill_err": err[:, 0].max().item() / scale,
            "decode_err": err[:, 1:].max().item() / scale,
            "logit_scale": scale,
            "argmax_agreement": (got.argmax(-1) == want.argmax(-1)).float().mean().item()}


def phase_paged_slice(cfg, params, *, impl, batch=4, prompt_len=256, steps=8,
                      block_size=16, seed=0):
    """Prompts admitted through ``paged_insert`` into a shuffled block
    table, then ``steps`` teacher-forced paged decode steps under ``impl``
    against the dense ``decode_step`` under ``impl`` on the same tokens.
    Returns the scaled error and the argmax agreement."""
    device = params["embed"]["table"].device
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (batch, prompt_len))).to(device)
    feed = torch.from_numpy(rng.integers(1, cfg.vocab_size, (batch, steps))).to(device)
    max_len = prompt_len + steps
    _, dense = MDL.prefill(params, cfg, {"tokens": toks}, max_len, impl=impl)
    m = PC.needed_blocks(max_len, block_size)
    n_blocks = PC.RESERVED_BLOCKS + batch * m
    table = (rng.permutation(n_blocks - PC.RESERVED_BLOCKS) + PC.RESERVED_BLOCKS)
    table = table.reshape(batch, m).astype(np.int32)
    pools = PC.paged_cache_init(cfg, batch, n_blocks, block_size, max_len,
                                L.dtype_of(cfg), device)
    PC.paged_insert(cfg, pools, dense, np.arange(batch), table[:, :PC.needed_blocks(
        prompt_len, block_size)], prompt_len, n_slots=batch)
    tbl = torch.from_numpy(table).to(device)
    paged, want = [], []
    for i in range(steps):
        pos = torch.full((batch,), prompt_len + i, dtype=torch.int32, device=device)
        lg, _ = MDL.paged_decode_step(params, cfg, feed[:, i], pools, tbl, pos, impl=impl)
        paged.append(lg)
        lg, _ = MDL.decode_step(params, cfg, feed[:, i], dense, prompt_len + i, impl=impl)
        want.append(lg)
    got, want = torch.stack(paged, dim=1), torch.stack(want, dim=1)
    check(bool(torch.isfinite(got).all()), "non-finite paged logits")
    scale = want.abs().amax().item()
    return {"paged_err": (got - want).abs().max().item() / scale, "logit_scale": scale,
            "argmax_agreement": (got.argmax(-1) == want.argmax(-1)).float().mean().item()}


@contextlib.contextmanager
def recorded_routes():
    """Record every router call while the block runs: its top-k expert set
    (sorted) and the gap between its k-th and (k+1)-th router
    probabilities, per row, into the yielded list."""
    calls = []
    router = MOE._router

    def recording(p, cfg, xf):
        out = router(p, cfg, xf)
        with torch.no_grad():
            probs = torch.softmax(L.dense_apply(p["router"], xf.float()), dim=-1)
            top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
        calls.append((torch.sort(out[1], dim=-1).values,
                      top[:, cfg.top_k - 1] - top[:, cfg.top_k]))
        return out
    MOE._router = recording
    try:
        yield calls
    finally:
        MOE._router = router


def route_diff(got, want, got_rows=None, want_rows=None):
    """Two runs' ``recorded_routes`` call by call, over ``got_rows`` and
    ``want_rows`` of each call (the same tokens in the same order; None:
    all rows): the share of (token, call) pairs whose expert set agrees,
    and the larger of both runs' probability gaps at each pair that does
    not."""
    check(len(got) == len(want) and got, "router calls differ between the runs")
    same, gaps = [], []
    for (ga, gg), (wa, wg) in zip(got, want):
        if got_rows is not None:
            ga, gg = (t[got_rows.to(t.device)] for t in (ga, gg))
            wa, wg = (t[want_rows.to(t.device)] for t in (wa, wg))
        agree = (ga == wa).all(dim=-1)
        same.append(agree)
        gaps.append(torch.maximum(gg, wg)[~agree])
    gaps = torch.cat(gaps)
    return {"agreement": torch.cat(same).float().mean().item(), "flips": gaps.numel(),
            "worst_gap": gaps.max().item() if gaps.numel() else 0.0}


def route_agreement(cfg, params, *, impl, **kw):
    """``phase_slice`` with every router call's top-k expert set recorded:
    adds the share of (token, layer) pairs whose set agrees between
    ``impl`` and "reference" (a near-tie in the router may fall the other
    way under bf16 attention rounding)."""
    with recorded_routes() as routes:
        sl = phase_slice(cfg, params, impl=impl, **kw)
    if not routes:  # no MoE layer
        sl["route_agreement"] = None
        return sl
    if impl == "reference":  # one run: nothing to compare
        sl["route_agreement"] = 1.0
        return sl
    half = len(routes) // 2
    check(len(routes) == 2 * half, "router calls differ between the tiers")
    sl["route_agreement"] = route_diff(routes[:half], routes[half:])["agreement"]
    return sl


# ------------------------------------------------------------------ phase 4

def serve_prompts(cfg, *, requests=8, min_prompt=16, max_prompt=400, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n)
            for n in rng.integers(min_prompt, max_prompt + 1, requests)]


def moe_layers(cfg):
    """Layers whose FFN is a dropless MoE: one grouped_ffn per forward."""
    return sum(s.has_ffn for s in cfg.layers) if cfg.ffn_kind == "moe" else 0


def attn_layers(cfg, *, local=None):
    """Attention layers; ``local`` True/False counts only window/full ones."""
    return sum(s.kind == ATTN and (local is None or (s.window is not None) == local)
               for s in cfg.layers)


def scan_launches(cfg, prefills):
    """One ssd_scan per SSM layer and one rglru_scan per RG-LRU layer per
    prefill (decode steps the recurrent states in plain PyTorch).  A scan
    kernel's key is present only for a model with that mixer."""
    out = {}
    for name, kind in (("ssd_scan", SSM), ("rglru_scan", LRU)):
        n = sum(s.kind == kind for s in cfg.layers)
        if n:
            out[name] = n * prefills
    return out


def same_launches(got, want):
    """Counts equal kernel by kernel, a kernel missing from either side
    counting 0."""
    return all(got.get(k, 0) == want.get(k, 0) for k in set(got) | set(want))


def predicted_launches(cfg, prompts, new):
    """One flash_mha per attention layer per bucket (the prefill), one
    flash_decode per attention layer per decode step (new - 1 steps per
    bucket), no paged decode; one grouped_ffn per MoE layer per prefill and
    per decode step; the scans of ``scan_launches`` per bucket."""
    n_buckets = len({bucket_of(len(p)) for p in prompts})
    return {"flash_mha": attn_layers(cfg) * n_buckets,
            "flash_decode": attn_layers(cfg) * (new - 1) * n_buckets,
            "paged_flash_decode": 0,
            "grouped_ffn": moe_layers(cfg) * new * n_buckets,
            **scan_launches(cfg, n_buckets)}


def phase_serve(cfg, params, prompts, *, impl, new=64, seed=0):
    """Serve ``prompts`` greedy, then sampled.  Returns per run the wall
    time, tokens/s, the kernels' launch counts and the outputs."""
    device = params["embed"]["table"].device
    server = BatchServer(cfg, params, max_new=new, impl=impl)
    runs = {}
    for mode, s in (("greedy", None), ("sampled", seed + 1)):
        sync(device)
        reset_launches()
        t0 = time.perf_counter()
        outs = server.serve(prompts, s)
        sync(device)
        dt = time.perf_counter() - t0
        counts = launches()
        for o in outs:
            check(o.shape == (new,), f"output shape {tuple(o.shape)} != ({new},)")
            check(bool(((o >= 0) & (o < cfg.vocab_size)).all()), "token out of range")
        runs[mode] = {"seconds": dt, "tokens_per_s": len(outs) * new / dt,
                      "launches": counts, "outputs": outs}
    return runs


# ------------------------------------------------------------------ phase 5

def continuous_traffic(cfg, *, requests=16, min_prompt=16, max_prompt=400, min_new=8,
                       max_new=64, seed=0):
    """Ragged prompts and a per-request number of new tokens, from ``seed``."""
    rng = np.random.default_rng(seed + 100)
    prompts = [rng.integers(1, cfg.vocab_size, n)
               for n in rng.integers(min_prompt, max_prompt + 1, requests)]
    return prompts, [int(n) for n in rng.integers(min_new, max_new + 1, requests)]


def phase_continuous(cfg, params, prompts, new, *, impl, n_slots=8, block_size=16,
                     sync_every=4, seed=0, modes=("greedy", "sampled", "preempt")):
    """Serve with ``ContinuousBatchServer`` in each of ``modes``: greedy,
    sampled, greedy on a pool of room for two full-length rows (preemption;
    after a greedy run).  Each run counts its admission dispatches by
    wrapping the server's ``_admit``, and the kernels' launches from just
    before ``serve`` to just after.  Returns per run the server's numbers,
    the launches and their prediction."""
    device = params["embed"]["table"].device
    kw = dict(n_slots=n_slots, kv_block_size=block_size, max_prompt=max(map(len, prompts)),
              max_new=max(new), impl=impl, sync_every=sync_every)
    runs, full_row = {}, None
    seeds = {"greedy": None, "sampled": seed + 1, "preempt": None}
    for mode in modes:
        s = seeds[mode]
        pool = PC.RESERVED_BLOCKS + 2 * full_row if mode == "preempt" else 0
        server = ContinuousBatchServer(cfg, params, max_kv_blocks=pool, **kw)
        full_row = server.max_blocks
        admits = [0]

        def counted(*a, _admit=server._admit, **k):
            admits[0] += 1
            return _admit(*a, **k)
        server._admit = counted
        sync(device)
        reset_launches()
        t0 = time.perf_counter()
        toks, lps = server.serve(prompts, seed=s, max_new=new)
        sync(device)
        dt = time.perf_counter() - t0
        counts = launches()
        st = server.stats()
        for t, lp, n in zip(toks, lps, new):
            check(t.shape == (n,), f"{mode}: {t.shape} tokens for max_new {n}")
            check(bool(((t >= 0) & (t < cfg.vocab_size)).all()), "token out of range")
            check(bool(np.isfinite(lp).all() and (lp <= 1e-4).all()), "bad logprob")
        runs[mode] = dict(
            seconds=dt, tokens_per_s=sum(new) / dt, p50_s=st["latency_s"]["p50"],
            p99_s=st["latency_s"]["p99"], steps=st["steps"],
            preemptions=st["preemptions"], peak_blocks=st["peak_blocks"],
            pool_blocks=server.alloc.n_blocks, admissions=admits[0],
            kv_peak_bytes=server.kv_peak_bytes(),
            full_buffer_bytes=PC.full_buffer_bytes(cfg, len(prompts), server.max_len),
            launches=counts,
            predicted={"flash_mha": attn_layers(cfg) * admits[0],
                       "flash_decode": attn_layers(cfg, local=True) * sync_every * st["steps"],
                       "paged_flash_decode": (attn_layers(cfg, local=False) * sync_every
                                              * st["steps"]),
                       "grouped_ffn": moe_layers(cfg) * (admits[0] + sync_every * st["steps"]),
                       **scan_launches(cfg, admits[0])},
            outputs=toks)
    return runs


def tie_gaps(cfg, params, prompts, outs_a, outs_b, impl="cuda"):
    """For each request whose greedy outputs ``outs_a`` and ``outs_b``
    part, the logits at the first step where they part, recomputed from the
    prompt (left-padded to its bucket, as both engines run it) and the
    common prefix: returns {request: (the larger distance of the two
    chosen tokens below the top logit, max |logit|)}."""
    device = params["embed"]["table"].device
    out = {}
    for i, (a, b) in enumerate(zip(outs_a, outs_b)):
        a, b = np.asarray(a), np.asarray(b)
        if np.array_equal(a, b):
            continue
        j = int(np.argmax(a != b))
        pr = np.asarray(prompts[i])
        seq = np.zeros(bucket_of(len(pr)) + j, np.int64)
        seq[bucket_of(len(pr)) - len(pr):bucket_of(len(pr))] = pr
        seq[bucket_of(len(pr)):] = a[:j]
        toks = torch.from_numpy(seq)[None].to(device)
        last, _ = MDL.prefill(params, cfg, {"tokens": toks}, len(seq), impl=impl)
        lg = MDL.logits_of(params, cfg, last[:, None])[0, 0]
        top = lg.max()
        out[i] = (max(float(top - lg[a[j]]), float(top - lg[b[j]])), float(lg.abs().max()))
    return out


def bucketed_on(cfg, params, prompts, new, *, impl):
    """The bucketed server on the same traffic: it generates max(new) tokens
    for every request; useful tokens/s counts only each request's own.
    Returns also its launches and their prediction."""
    device = params["embed"]["table"].device
    server = BatchServer(cfg, params, max_new=max(new), impl=impl)
    sync(device)
    reset_launches()
    t0 = time.perf_counter()
    outs = server.serve(prompts)
    sync(device)
    dt = time.perf_counter() - t0
    return {"seconds": dt, "useful_tokens_per_s": sum(new) / dt, "launches": launches(),
            "predicted": predicted_launches(cfg, prompts, max(new)),
            "outputs": [o[:n].cpu().numpy() for o, n in zip(outs, new)]}


# ------------------------------------------------------------------ phase 6

def train_experiment(*, batch=16, prompt_len=128, new=256, n_minibatches=2, impl="cuda",
                     seed=0, packed=True, opt=None):
    """The PPO experiment of phase 6 (packed) and phase 7 (padded, or
    packed); ``opt`` the AdamW config (None: the default)."""
    return EXP.ExperimentConfig(batch=batch, prompt_len=prompt_len, gen_len=new, seed=seed,
                                ppo=PPO.PPOHyperparameters(n_minibatches=n_minibatches),
                                opt=opt or adamw.AdamWConfig(), impl=impl,
                                packed_training=packed)


def train_models(cfg, exp, device):
    """``build_models`` with every embedding scaled by EMBED_SCALE (and the
    recurrent mixers' constant leaves drawn), ``scale_models``."""
    return scale_models(EXP.build_models(cfg, cfg, exp, device=device), exp)


def scale_models(models, exp):
    """Scale every model's embedding by EMBED_SCALE and draw the recurrent
    mixers' constant leaves (``randomize_mixers``), in place; the trained
    models' AdamW state is taken after.  Returns ``models``."""
    seeds = {"actor": 0, "ref": 0, "critic": 2, "reward": 3}  # the reference is the actor
    for name, ms in models.items():
        with torch.no_grad():
            ms.params["embed"]["table"].mul_(EMBED_SCALE)
            randomize_mixers(ms.params, seed=exp.seed + seeds[name])
        if ms.opt_state is not None:
            ms.opt_state = adamw.init(exp.opt, ms.params)
    return models


def train_rollout(cfg, exp, ex, models, rng, *, min_valid=16):
    """One rollout: seeded prompts through ``actor_gen``, each row's
    gen_mask cut at a seeded valid length in [min_valid, gen_len] (as an
    EOS there would cut it), then reference, critic and reward inference.
    Returns the rollout and the valid lengths."""
    device = models["actor"].params["embed"]["table"].device
    prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                            (exp.batch, exp.prompt_len))).to(device)
    roll = ex["actor_gen"](models["actor"], {"prompts": {"tokens": prompts}})
    valid = rng.integers(min_valid, exp.gen_len + 1, exp.batch)
    roll["gen_mask"] = (torch.arange(exp.gen_len, device=device)[None]
                        < torch.from_numpy(valid).to(device)[:, None]).float()
    for name in ("ref", "critic", "reward"):
        roll |= ex[f"{name}_inf"](models[name], roll)
    return roll, valid


def leaf_names(tree, prefix=""):
    """Names of ``adamw.leaves(tree)``, in its order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def first_rows(exp, roll):
    """The first minibatch's real tokens (each sequence's prompt, valid
    generated tokens and one bootstrap token, as ``_packed_prep`` keeps
    them), in sequence order, as rows of its train forward: the packed
    cohort's first sum(lens) rows, or the first lens[i] of padded row i's S.
    No other row reaches a loss."""
    b = exp.batch // exp.ppo.n_minibatches
    g_valid = roll["gen_mask"][:b].sum(-1).long().cpu()
    lens = (exp.prompt_len + torch.clamp(g_valid + 1, max=exp.gen_len)).tolist()
    if exp.packed_training:
        return torch.arange(sum(lens))
    s = exp.prompt_len + exp.gen_len
    return torch.cat([i * s + torch.arange(n) for i, n in enumerate(lens)])


def model_minibatch(cfg, exp, ms, roll, name, *, impl):
    """Model ``name``'s ("actor" or "critic") loss, stats, grad_norm and
    gradients on the first minibatch of ``roll`` in ``exp``'s layout
    (padded or packed) under ``impl``, from its current state (no update);
    for an MoE model also every router call's ``recorded_routes`` and the
    rows of the minibatch's real tokens (``first_rows``)."""
    make = EXP.actor_train_batch if name == "actor" else EXP.critic_train_batch
    batch = make(exp, roll)
    if exp.packed_training:
        fn = PPO.packed_actor_grads if name == "actor" else PPO.packed_critic_grads
        kw = dict(max_seqlen=EXP.max_seqlen(exp))
    else:
        batch = PPO.split_minibatches(batch, exp.ppo.n_minibatches)
        fn = PPO.actor_grads if name == "actor" else PPO.critic_grads
        kw = dict(gen_start=exp.prompt_len)
    mb = {k: v[0] for k, v in batch.items()}
    with recorded_routes() as routes:
        loss, st, grads = fn(ms.params, cfg, exp.ppo, mb, impl=impl, **kw)
    n = max(mb["mask"].sum().item(), 1.0)
    return dict(loss=loss.item(), grad_norm=adamw.global_norm(grads).item(), grads=grads,
                names=leaf_names(ms.params),
                clip_frac=st["clip_frac"].item() if "clip_frac" in st else 0.0,
                adv_scale=(mb["adv"].abs() * mb["mask"]).sum().item() / n
                if name == "actor" else None,
                routes=routes, rows=first_rows(exp, roll))


def first_minibatch(cfg, exp, models, roll, *, impl):
    """``model_minibatch`` of the actor and the critic."""
    return {name: model_minibatch(cfg, exp, models[name], roll, name, impl=impl)
            for name in ("actor", "critic")}


def square_norms(a, b):
    """(|a - b|^2, |b|^2) in fp32, slice by slice along the first axis: a
    whole fp32 copy of recurrentgemma's embedding gradient is 4.2 GB."""
    d2 = r2 = 0.0
    rows = max(1, (1 << 24) * b.shape[0] // b.numel()) if b.dim() else 1
    for x, y in zip(a.split(rows) if a.dim() else [a], b.split(rows) if b.dim() else [b]):
        y = y.float()
        d2 += (x.float() - y).square().sum().item()
        r2 += y.square().sum().item()
    return d2, r2


def agreement(name, g, w):
    """Model ``name``'s ``model_minibatch`` result ``g`` against a reference
    run's ``w``.  A leaf's error is |g - g_ref| / |g_ref| (Frobenius);
    "global" the same over all leaves; the actor loss's error is over the
    minibatch's mean |advantage| (its loss is a sum of ratio * advantage
    terms near zero after whitening), the critic's over its reference loss.
    For an MoE model, "routes" is ``route_diff`` over the real tokens (else
    None)."""
    sq = [square_norms(a, b) for a, b in zip(g["grads"], w["grads"])]
    errs = [math.sqrt(d2 / max(r2, 1e-60)) for d2, r2 in sq]
    diff2 = sum(d2 for d2, _ in sq)
    worst = sorted(zip(errs, g["names"]), reverse=True)[:3]
    scale = w["adv_scale"] if name == "actor" else abs(w["loss"])
    routes = (route_diff(g["routes"], w["routes"], g["rows"], w["rows"])
              if g.get("routes") else None)
    return dict(loss=g["loss"], ref_loss=w["loss"],
                loss_err=abs(g["loss"] - w["loss"]) / max(scale, 1e-12),
                grad_norm=g["grad_norm"], ref_grad_norm=w["grad_norm"],
                grad_norm_err=abs(g["grad_norm"] - w["grad_norm"]) / max(w["grad_norm"], 1e-12),
                global_err=math.sqrt(diff2) / max(w["grad_norm"], 1e-30),
                clip_frac=g["clip_frac"], ref_clip_frac=w["clip_frac"],
                worst_leaf_err=worst[0][0], worst_leaves=worst, n_leaves=len(errs),
                routes=routes)


def grad_agreement(got, want):
    """``agreement`` of each model in two ``first_minibatch`` results."""
    return {name: agreement(name, g, want[name]) for name, g in got.items()}


def compare_runs(cfg, models, roll, run, ref_run):
    """``agreement`` of each trained model's first minibatch under ``run``
    against ``ref_run``, each an (experiment, impl) pair, from one state and
    one rollout; one model at a time, so two sets of gradients are alive at
    once.  Equal runs compute once."""
    out = {}
    for name in ("actor", "critic"):
        got = model_minibatch(cfg, run[0], models[name], roll, name, impl=run[1])
        want = got if run == ref_run else model_minibatch(cfg, ref_run[0], models[name], roll,
                                                          name, impl=ref_run[1])
        out[name] = agreement(name, got, want)
        del got, want
    return out


def compare_tiers(cfg, exp, models, roll, *, impl):
    """``compare_runs`` of ``impl`` against "reference" in ``exp``'s layout,
    before any update."""
    return compare_runs(cfg, models, roll, (exp, impl), (exp, "reference"))


def compare_layouts(cfg, exp, models, roll):
    """``compare_runs`` of the packed train step against the padded one on
    the same rollout, both under ``exp.impl``: the first minibatch's losses
    and gradients are one function of the same tokens (the JAX package's
    ``test_packed_ppo_loss_and_grads_match_padded``)."""
    packed, padded = (dataclasses.replace(exp, packed_training=p) for p in (True, False))
    return compare_runs(cfg, models, roll, (packed, exp.impl), (padded, exp.impl))


def fp32_train_models(cfg, device, layers=2):
    """An fp32 actor and critic of ``cfg`` at full width and ``layers``
    layers (``shallow``), embeddings scaled by EMBED_SCALE and the recurrent
    mixers' constant leaves drawn."""
    small = shallow(cfg, layers, dtype="float32")
    models = {}
    for name, head, seed in (("actor", "lm", 1), ("critic", "value", 2)):
        params = MDL.init_params(small, seed=seed, device=device, head=head)
        with torch.no_grad():
            params["embed"]["table"].mul_(EMBED_SCALE)
            randomize_mixers(params, seed=seed)
        models[name] = EXP.ModelState(params)
    return small, models


def train_step_predicted(cfg, exp):
    """Launches of one PPO iteration's two train calls: per minibatch, the
    actor's and the critic's train forward and its recompute (remat) run
    flash_mha_varlen (packed) or flash_mha (padded) in every attention
    layer, grouped_ffn in every MoE layer and one scan in every recurrent
    layer (padded only); the plain backwards launch nothing."""
    per_layer = exp.ppo.n_minibatches * 2 * 2
    attn = "flash_mha_varlen" if exp.packed_training else "flash_mha"
    out = {attn: attn_layers(cfg) * per_layer, "grouped_ffn": moe_layers(cfg) * per_layer,
           **scan_launches(cfg, per_layer)}
    return {k: v for k, v in out.items() if v}


def train_predicted(cfg, exp):
    """Launches of one PPO iteration: the rollout's (flash_mha in the prefill
    of generation and the three padded inference forwards, flash_decode in
    each of the gen_len - 1 decode steps, grouped_ffn in the prefill, each
    decode step and the three forwards, one scan per recurrent layer in the
    prefill and the three forwards) and ``train_step_predicted``."""
    n = attn_layers(cfg)
    out = {"flash_mha": 4 * n, "flash_decode": n * (exp.gen_len - 1)}
    if moe_layers(cfg):
        out["grouped_ffn"] = moe_layers(cfg) * (exp.gen_len + 3)
    out.update(scan_launches(cfg, 4))
    for k, v in train_step_predicted(cfg, exp).items():
        out[k] = out.get(k, 0) + v
    return out


def phase_train(cfg, exp, device, *, iters=2, min_valid=16, seed=0, fp32_layers=2,
                layouts=False, models=None):
    """``iters`` PPO iterations of ``build_executors`` (padded or packed as
    ``exp`` says): rollout (``train_rollout``), then the actor and critic
    train steps.  On the first, before training, ``compare_tiers`` on this
    state and rollout; after the last, with the models freed (unless the
    caller gave ``models``), on fp32 models of ``fp32_layers`` layers on
    the first rollout, and with ``layouts`` ``compare_layouts`` on them.
    The comparisons' launches are not counted.  Returns per iteration the
    times, real train tokens, stats, the kernels launched during the train
    calls, and whether every trained parameter is finite and some changed;
    the comparisons; and the run's launches beside their prediction."""
    own = models is None
    if own:
        models = train_models(cfg, exp, device)
    ex = EXP.build_executors(cfg, cfg, exp)
    rng = np.random.default_rng(seed + 300)
    trained = ("actor", "critic")
    out = {"iters": [], "compare": None, "compare_fp32": None, "compare_layouts": None}
    sync(device)
    reset_launches()
    for it in range(iters):
        t0 = time.perf_counter()
        roll, valid = train_rollout(cfg, exp, ex, models, rng, min_valid=min_valid)
        sync(device)
        rollout_s = time.perf_counter() - t0
        if it == 0:
            first_roll = roll
            held_counts = launches()
            out["compare"] = compare_tiers(cfg, exp, models, roll, impl=exp.impl)
            for kern in KERNELS:  # the comparisons' launches do not count
                kern.launches = held_counts[kern.__name__]
        # on the host: on the card these copies would add two models' bytes
        before = {n: [p.detach().to("cpu", copy=True) for p in adamw.leaves(models[n].params)]
                  for n in trained}
        counts0 = launches()
        t0 = time.perf_counter()
        stats = ex["actor_train"](models["actor"], roll)
        sync(device)
        actor_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats |= ex["critic_train"](models["critic"], roll)
        sync(device)
        critic_s = time.perf_counter() - t0
        counts1 = launches()
        state = {}
        for n in trained:
            now = adamw.leaves(models[n].params)
            state[n] = dict(finite=all(bool(torch.isfinite(p).all()) for p in now),
                            changed=sum(bool((p.cpu() != q).any())
                                        for p, q in zip(now, before[n])),
                            leaves=len(now))
        del before
        lens = exp.prompt_len + np.minimum(valid + 1, exp.gen_len)
        out["iters"].append(dict(
            rollout_s=rollout_s, actor_s=actor_s, critic_s=critic_s, tokens=int(lens.sum()),
            padded_tokens=exp.batch * (exp.prompt_len + exp.gen_len), state=state, **stats,
            train_launches={k: counts1[k] - counts0[k] for k in counts1
                            if counts1[k] != counts0[k]}))
    out["launches"] = launches()
    if own:
        del models, ex
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    if fp32_layers:
        small, m32 = fp32_train_models(cfg, device, fp32_layers)
        out["fp32_layers"] = small.num_layers
        out["compare_fp32"] = compare_tiers(small, exp, m32, first_roll, impl=exp.impl)
        if layouts:
            out["compare_layouts"] = compare_layouts(small, exp, m32, first_roll)
        del m32
        for kern in KERNELS:
            kern.launches = out["launches"][kern.__name__]
    out["predicted"] = {k: v * iters for k, v in train_predicted(cfg, exp).items()}
    out["per_iter"] = train_predicted(cfg, exp)
    out["train_per_iter"] = train_step_predicted(cfg, exp)
    return out


def report_compare(tag, label, cmp, tol, leaf_tol, *, gate=True):
    """Print ``grad_agreement``'s result and, with ``gate``, fail past the
    limits: loss, grad_norm and whole gradient within ``tol``, each leaf
    within ``leaf_tol``, clip_frac within CLIP_FRAC_TOL.  Where an MoE
    model's routes part between the runs, the gap of each parting pair is
    held to ROUTE_TIE_TOL in place of the gradients (one token's expert
    swapped moves them past any summation-order limit)."""
    for name, c in cmp.items():
        r = c["routes"]
        routes = ("" if r is None else f"; routes agree on {r['agreement']:.6f} of (token, "
                  f"router call) pairs, {r['flips']} part (largest probability gap "
                  f"{r['worst_gap']:.3e}, tol {ROUTE_TIE_TOL})")
        print(f"{tag} {name} {label}: loss {c['loss']:.6e} vs {c['ref_loss']:.6e} (err "
              f"{c['loss_err']:.3e}), grad_norm {c['grad_norm']:.6e} vs "
              f"{c['ref_grad_norm']:.6e} (err {c['grad_norm_err']:.3e}), clip_frac "
              f"{c['clip_frac']:.4f} vs {c['ref_clip_frac']:.4f}, gradient err "
              f"{c['global_err']:.3e}, worst leaves "
              + ", ".join(f"{n} {e:.3e}" for e, n in c["worst_leaves"])
              + f" of {c['n_leaves']}"
              + (f" (tol {tol}, per leaf {leaf_tol})" if gate else " (not gated)") + routes)
        if not gate:
            continue
        if r is not None and r["flips"]:
            check(r["worst_gap"] <= ROUTE_TIE_TOL,
                  f"{tag} {name} {label}: a route parts {r['worst_gap']:.3e} from a tie")
            continue
        check(max(c["loss_err"], c["grad_norm_err"], c["global_err"]) <= tol
              and c["worst_leaf_err"] <= leaf_tol, f"{tag} {name} {label}: runs disagree")
        check(abs(c["clip_frac"] - c["ref_clip_frac"]) <= CLIP_FRAC_TOL,
              f"{tag} {name} {label}: clip_frac disagrees")


def report_train(cfg, exp, device, total, *, tag="[train]", gate_bf16=True, **kw):
    """One ``phase_train`` run on the card and every check of its results:
    the bf16 comparison of the tiers (gated with ``gate_bf16``, else
    printed), the fp32 ones (and the layouts'), finite and changed
    parameters, each iteration's train launches and the run's launches
    against the prediction; adds the run's launches to ``total``."""
    layers = f"{cfg.num_layers} layers" + ("" if cfg.num_layers == get_config(
        cfg.name).num_layers else f" (cut from {get_config(cfg.name).num_layers})")
    layout = "packed" if exp.packed_training else "padded"
    print(f"{tag} {cfg.name} {layers}, {layout}: {exp.batch} prompts of {exp.prompt_len} "
          f"tokens, {exp.gen_len} new, {exp.ppo.n_minibatches} minibatches, AdamW m/v "
          f"{exp.opt.state_dtype}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = phase_train(cfg, exp, device, **kw)
    wall = time.perf_counter() - t0
    report_compare(tag, f"bf16, {cfg.num_layers} layers, first minibatch cuda vs reference",
                   tr["compare"], TRAIN_TOL, TRAIN_LEAF_TOL, gate=gate_bf16)
    if tr["compare_fp32"] is not None:
        report_compare(tag, f"fp32, {tr['fp32_layers']} layers, first minibatch cuda vs "
                       "reference", tr["compare_fp32"], FP32_GRAD_TOL, FP32_GRAD_TOL)
    if tr["compare_layouts"] is not None:
        report_compare(tag, f"fp32, {tr['fp32_layers']} layers, first minibatch packed vs "
                       "padded, both cuda", tr["compare_layouts"], FP32_GRAD_TOL,
                       FP32_GRAD_TOL)
    for i, r in enumerate(tr["iters"]):
        a, c = r["actor_stats"], r["critic_stats"]
        print(f"{tag} {cfg.name} {layout} iteration {i}: rollout {r['rollout_s']:.3f}s; "
              f"actor step {r['actor_s']:.3f}s, critic step {r['critic_s']:.3f}s on "
              f"{r['tokens']} real tokens ({r['padded_tokens']} padded): "
              f"{r['tokens'] / r['actor_s']:.1f} / {r['tokens'] / r['critic_s']:.1f} train "
              f"tokens/s; actor {a}; critic {c}; launches during the train steps "
              f"{r['train_launches']} (predicted {tr['train_per_iter']}); parameters "
              f"{r['state']}")
        check(all(math.isfinite(v) for v in (*a.values(), *c.values())), "non-finite train stats")
        for n, st in r["state"].items():
            check(st["finite"] and st["changed"] > 0, f"iteration {i}: {n} parameters "
                  f"{'not finite' if not st['finite'] else 'unchanged'}")
        # the differentiable kernels ran in every train forward and its
        # recompute, and the decode kernels (no backward) never
        check(same_launches(r["train_launches"], tr["train_per_iter"])
              and all(v > 0 for v in tr["train_per_iter"].values()),
              f"iteration {i}: train launches {r['train_launches']}")
    print(f"{tag} {cfg.name} {layout}: launches {tr['launches']} (predicted "
          f"{tr['predicted']}); phase wall {wall:.1f}s; max_memory_allocated="
          f"{torch.cuda.max_memory_allocated()} bytes")
    check(same_launches(tr["launches"], tr["predicted"]),
          f"train: launches {tr['launches']} != {tr['predicted']}")
    for k in total:
        total[k] += tr["launches"][k]


# Phase 7's models beside qwen2-0.5b: (config name, layers kept, AdamW m/v
# dtype).  8 prompts of 128 tokens, 128 new (S 256, two of mamba2's
# 128-token chunks), 2 minibatches.  recurrentgemma-9b keeps one
# superblock and the tail (5 of 38 layers) and bf16 m/v: four 9B models
# do not fit on one card, and at 5 layers its 256,000-row tied embedding
# is half of each model.
PHASE7_MODELS = (("granite-moe-1b-a400m", None, "float32"), ("mamba2-1.3b", None, "float32"),
                 ("recurrentgemma-9b", 5, "bfloat16"))


def report_phase7(device, total):
    """Phase 7: two padded PPO iterations of full qwen2-0.5b (phase 6's
    traffic; bf16 comparison gated as phase 6's, fp32 on 2 layers, packed
    against padded in fp32); granite-moe-1b-a400m one packed and one padded
    iteration on one set of models; mamba2-1.3b and recurrentgemma-9b one
    padded iteration each.  The extra models' bf16 comparisons are printed,
    their fp32 ones gated."""
    report_train(get_config("qwen2-0.5b"), train_experiment(packed=False), device, total,
                 tag="[train7]", layouts=True)
    for name, layers, state_dtype in PHASE7_MODELS:
        cfg = get_config(name)
        if layers is not None:
            cfg = shallow(cfg, layers)
        t0 = time.perf_counter()
        kw = dict(batch=8, new=128, opt=adamw.AdamWConfig(state_dtype=state_dtype))
        runs = [train_experiment(packed=False, **kw)]
        if all(s.kind == ATTN for s in cfg.layers):
            runs.insert(0, train_experiment(packed=True, **kw))
        models = train_models(cfg, runs[0], device) if len(runs) > 1 else None
        for exp in runs:
            report_train(cfg, exp, device, total, tag="[train7]", gate_bf16=False, iters=1,
                         layouts=not exp.packed_training and len(runs) > 1, models=models)
        del models
        torch.cuda.empty_cache()
        print(f"[train7] {name}: {time.perf_counter() - t0:.1f}s")


# ------------------------------------------------------------------ phase 8

# The engine's train stats against the hand-driven loop's: each stat's
# |a - b| / max(|a|, |b|), its largest over the actor's and the critic's
# stats, within ENGINE_SPREAD_FACTOR times the same reading between two
# identical hand-driven runs in this script, plus ENGINE_STATS_FLOOR (so a
# deterministic pair of hand runs, spread 0, still leaves room for one
# reordered fp32 sum in the engine's run).
ENGINE_SPREAD_FACTOR = 4.0
ENGINE_STATS_FLOOR = 1e-6
# The rollout and inference outputs of a PPO iteration, held bit for bit.
POOL_KEYS = ("seq", "logp", "gen_mask", "ref_logp", "values", "rewards")
STAT_KEYS = ("actor_stats", "critic_stats")


def host_pool(pool):
    """A data pool's tensors on the host (the prompts left out)."""
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v
            for k, v in pool.items() if k != "prompts"}


def free(device):
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def hand_iteration(cfg, exp, device, prompts):
    """Phase 7's loop without its gen_mask cut, on fresh models
    (``train_models``) and executors: one PPO iteration in dataflow order on
    ``prompts``.  Returns (pool on the host, seconds, launches)."""
    models = train_models(cfg, exp, device)
    ex = EXP.build_executors(cfg, cfg, exp)
    sync(device)
    reset_launches()
    t0 = time.perf_counter()
    roll = ex["actor_gen"](models["actor"], {"prompts": {"tokens": prompts}})
    for name in ("ref", "critic", "reward"):
        roll |= ex[f"{name}_inf"](models[name], roll)
    for name in ("actor", "critic"):
        roll |= ex[f"{name}_train"](models[name], roll)
    sync(device)
    secs, counts = time.perf_counter() - t0, launches()
    out = host_pool(roll)
    del models, ex, roll
    free(device)
    return out, secs, counts


def engine_experiment(cfg, exp, device, **kw):
    """``RLHFExperiment`` of ``cfg`` as actor and critic on one H100
    (``Cluster(1, 1, chip=hw.H100)``), ``exp`` with the fields ``kw``
    replaced, its models scaled as ``train_models`` scales them before any
    call."""
    e = EXP.RLHFExperiment(cfg, cfg, Cluster(1, 1, chip=hw.H100),
                           dataclasses.replace(exp, **kw), device=device)
    scale_models(e.models, e.exp)
    return e


def pools_equal(a, b):
    """The keys of POOL_KEYS on which two host pools differ."""
    return [k for k in POOL_KEYS if not torch.equal(a[k], b[k])]


def stats_spread(a, b):
    """The largest |x - y| / max(|x|, |y|) over both trained models' stats
    of two pools."""
    worst = 0.0
    for key in STAT_KEYS:
        for name, x in a[key].items():
            y = b[key][name]
            worst = max(worst, abs(x - y) / max(abs(x), abs(y), 1e-30))
    return worst


def phase_engine(cfg, exp, device, *, profile_batches=(4, 16), profile_seqs=(128, 384),
                 search_iters=300, seed=0):
    """Phase 8: ``profile_model`` into a ``ProfileStore``; an
    ``RLHFExperiment`` calibrated from it, its plan searched, one
    ``run_iteration`` held against two hand-driven iterations on the same
    prompts and weights, the cost model recalibrated from that iteration's
    records and a second iteration read against it; then ``run(steps=2)``
    at pipeline depth 2 and at depth 1 from the same seeds.  Each
    experiment is freed before the next is built.  Returns the readings."""
    out = {}
    cluster = Cluster(1, 1, chip=hw.H100)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "profile.json")
        entry = PROF.profile_and_store(cfg, PROF.ProfileStore(path), cluster,
                                       batches=profile_batches, seqs=profile_seqs,
                                       device=device)
        free(device)
        out["profile"] = dict(fingerprint=entry.fingerprint, entries=dict(entry.table.entries),
                              scales=dict(entry.type_scales), profile=entry.profile,
                              seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        e = engine_experiment(cfg, exp, device, search_iters=search_iters, profile_path=path)
    out["search_s"] = time.perf_counter() - t0  # the plan search and the models' build
    out["plan"] = str(e.plan)
    out["estimated_s"] = SIM.simulate(e.graph, e.plan, e.cost).total_time
    prompts = e.make_prompts(seed)["tokens"]

    hands = [hand_iteration(cfg, exp, device, prompts) for _ in range(2)]
    out["hand_s"] = [h[1] for h in hands]
    out["hand_launches"] = [h[2] for h in hands]
    out["hand_parts"] = pools_equal(hands[0][0], hands[1][0])
    out["spread"] = stats_spread(hands[0][0], hands[1][0])
    out["limit"] = ENGINE_SPREAD_FACTOR * out["spread"] + ENGINE_STATS_FLOOR

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    analytic = CostModel(cluster)
    profiled = {c.name: e.cost.call_time(c, e.plan.assignments[c.name]) for c in e.graph.calls}
    sync(device)
    reset_launches()
    t0 = time.perf_counter()
    pool = host_pool(e.run_iteration(seed))
    out["engine_s"] = [time.perf_counter() - t0]
    out["engine_launches"] = launches()
    out["engine_parts"] = pools_equal(pool, hands[0][0])
    out["engine_spread"] = stats_spread(pool, hands[0][0])
    first = {r.name: r.end - r.start for r in e.engine.records}
    e.engine.recalibrate()
    recal = {c.name: e.cost.call_time(c, e.plan.assignments[c.name]) for c in e.graph.calls}
    n = len(e.engine.records)
    reset_launches()
    t0 = time.perf_counter()
    e.run_iteration(seed + 1)
    out["engine_s"].append(time.perf_counter() - t0)
    out["engine_launches_2"] = launches()
    second = {r.name: r.end - r.start for r in e.engine.records[n:]}
    out["calls"] = {c.name: dict(measured=first[c.name], analytic=analytic.call_time(
        c, e.plan.assignments[c.name]), profiled=profiled[c.name], held_out=second[c.name],
        recalibrated=recal[c.name]) for c in e.graph.calls}
    out["stats"] = e.engine.stats()
    out["peak_bytes"] = (torch.cuda.max_memory_allocated()
                         if torch.device(device).type == "cuda" else 0)
    del e, pool
    free(device)

    runs = {}
    for depth in (2, 1):
        e = engine_experiment(cfg, exp, device, search_iters=search_iters,
                              pipeline_depth=depth)
        reset_launches()
        t0 = time.perf_counter()
        runs[depth] = [host_pool(p) for p in e.run(seed + 2, steps=2)]
        out[f"depth{depth}_s"] = time.perf_counter() - t0
        out[f"depth{depth}_launches"] = launches()
        out[f"depth{depth}_stats"] = e.engine.stats()
        del e
        free(device)
    out["pipelined_parts"] = pools_equal(runs[2][0], runs[1][0])
    out["pipelined_spread"] = stats_spread(runs[2][0], runs[1][0])
    out["pipelined_2"] = {k: (runs[2][1][k].float() - runs[1][1][k].float()).abs().max().item()
                          for k in POOL_KEYS}
    out["pipelined_2_spread"] = stats_spread(runs[2][1], runs[1][1])
    return out


def report_engine(device, total):
    """Phase 8 on the card: print and check ``phase_engine``'s readings of
    full-depth qwen2-0.5b on phase 7's padded traffic; adds its launches to
    ``total``."""
    cfg = get_config("qwen2-0.5b")
    exp = train_experiment(packed=False)
    t_phase = time.perf_counter()
    r = phase_engine(cfg, exp, device)
    pr = r["profile"]
    print(f"[engine] profile of {cfg.name} on {pr['fingerprint']} in {pr['seconds']:.1f}s: "
          + ", ".join(f"{k} b{b} s{s} {t:.4f}s" for (k, b, s), t in sorted(pr["entries"].items()))
          + f"; fitted {pr['profile']}, type scales {pr['scales']}")
    print(f"[engine] {r['plan']}; search and build {r['search_s']:.2f}s, estimated iteration "
          f"{r['estimated_s']:.4f}s")
    print(f"[engine] two hand-driven iterations: {r['hand_s'][0]:.3f}s, {r['hand_s'][1]:.3f}s; "
          f"pools part on {r['hand_parts'] or 'nothing'}; stats spread {r['spread']:.3e}")
    check(not r["hand_parts"], f"two identical hand-driven iterations part on {r['hand_parts']}")
    print(f"[engine] run_iteration {r['engine_s'][0]:.3f}s (then {r['engine_s'][1]:.3f}s) vs "
          f"the hand-driven loop {r['hand_s'][0]:.3f}s; rollout and inference outputs part "
          f"from the hand-driven loop's on {r['engine_parts'] or 'nothing'}; stats "
          f"{r['engine_spread']:.3e} (limit {r['limit']:.3e} = {ENGINE_SPREAD_FACTOR} x "
          f"spread {r['spread']:.3e} + {ENGINE_STATS_FLOOR})")
    check(not r["engine_parts"], f"engine iteration parts from the hand-driven loop on "
          f"{r['engine_parts']}")
    check(r["engine_spread"] <= r["limit"], "engine train stats disagree with the hand loop")
    for name, c in r["calls"].items():
        print(f"[engine] {name}: measured {c['measured']:.4f}s; estimated analytic "
              f"{c['analytic']:.4f}s ({c['measured'] / c['analytic']:.3f}x), profiled "
              f"{c['profiled']:.4f}s ({c['measured'] / c['profiled']:.3f}x); after "
              f"recalibration {c['recalibrated']:.4f}s against the next iteration's "
              f"{c['held_out']:.4f}s ({c['held_out'] / c['recalibrated']:.3f}x)")
        check(all(math.isfinite(v) and v > 0 for v in c.values()), f"{name}: bad times")
    print(f"[engine] stats {r['stats']}")
    print(f"[engine] run(steps=2) at depth 2 {r['depth2_s']:.3f}s, depth 1 {r['depth1_s']:.3f}s; "
          f"iteration 1 parts on {r['pipelined_parts'] or 'nothing'} (stats "
          f"{r['pipelined_spread']:.3e}); iteration 2 largest differences "
          f"{r['pipelined_2']} (stats {r['pipelined_2_spread']:.3e}); depth 2 stats "
          f"{r['depth2_stats']}")
    check(not r["pipelined_parts"], f"depth 2's iteration 1 parts from depth 1's on "
          f"{r['pipelined_parts']}")
    check(r["pipelined_spread"] <= r["limit"], "depth 2's iteration 1 stats disagree")
    want = train_predicted(cfg, exp)
    for key, got in (("hand", r["hand_launches"][0]), ("hand", r["hand_launches"][1]),
                     ("engine", r["engine_launches"]), ("engine", r["engine_launches_2"])):
        check(same_launches(got, want), f"{key} iteration: launches {got} != {want}")
    for depth in (2, 1):
        got, want2 = r[f"depth{depth}_launches"], {k: 2 * v for k, v in want.items()}
        check(same_launches(got, want2), f"depth {depth}: launches {got} != {want2}")
    print(f"[engine] launches per engine iteration {r['engine_launches']} (predicted {want}); "
          f"max_memory_allocated={r['peak_bytes']} bytes; phase 8 "
          f"{time.perf_counter() - t_phase:.1f}s")
    for counts in (*r["hand_launches"], r["engine_launches"], r["engine_launches_2"],
                   r["depth2_launches"], r["depth1_launches"]):
        for k in total:
            total[k] += counts[k]


# ------------------------------------------------------------------ main

def shallow(cfg, layers=4, *, dtype=None):
    """``cfg`` at full width with about ``layers`` layers (whole
    superblocks, at least one, and the tail), in ``dtype`` (None: its
    own)."""
    n_sb = max(1, layers // len(cfg.superblock))
    return dataclasses.replace(cfg, dtype=dtype or cfg.dtype, n_superblocks=n_sb,
                               num_layers=n_sb * len(cfg.superblock) + len(cfg.tail))


def report_slice(cfg, params):
    """Phase 3 on the card for one model: cuda vs reference logits (and the
    router's agreement for MoE; for a model with recurrent mixers also in
    fp32 on a few layers), then paged vs dense decode."""
    sl = route_agreement(cfg, params, impl="cuda")
    routes = (f" route_agreement={sl['route_agreement']:.4f}" if moe_layers(cfg) else "")
    print(f"[slice] {cfg.name} {cfg.num_layers} layers bf16: prefill_err="
          f"{sl['prefill_err']:.3e} decode_err={sl['decode_err']:.3e} "
          f"(of max |logit| {sl['logit_scale']:.3f}; tol {LOGIT_TOL}) "
          f"argmax_agreement={sl['argmax_agreement']:.3f}{routes}")
    check(sl["prefill_err"] <= LOGIT_TOL and sl["decode_err"] <= LOGIT_TOL,
          f"{cfg.name}: cuda logits disagree with the reference")
    if any(s.kind != ATTN for s in cfg.layers):
        small = shallow(cfg, dtype="float32")
        p32 = make_params(small, seed=1, device=params["embed"]["table"].device)
        sl = phase_slice(small, p32, impl="cuda")
        del p32
        torch.cuda.empty_cache()
        print(f"[slice] {cfg.name} fp32, {small.num_layers} layers: prefill_err="
              f"{sl['prefill_err']:.3e} decode_err={sl['decode_err']:.3e} (of max |logit| "
              f"{sl['logit_scale']:.3f}; tol {FP32_LOGIT_TOL}) "
              f"argmax_agreement={sl['argmax_agreement']:.3f}")
        check(sl["prefill_err"] <= FP32_LOGIT_TOL and sl["decode_err"] <= FP32_LOGIT_TOL,
              f"{cfg.name}: fp32 cuda logits disagree with the reference")
    pg = phase_paged_slice(cfg, params, impl="cuda")
    print(f"[slice] {cfg.name} paged decode vs dense decode, both cuda: paged_err="
          f"{pg['paged_err']:.3e} (of max |logit| {pg['logit_scale']:.3f}; tol {LOGIT_TOL}) "
          f"argmax_agreement={pg['argmax_agreement']:.3f}")
    check(pg["paged_err"] <= LOGIT_TOL, f"{cfg.name}: paged logits disagree with the dense "
          "decode")


def report_continuous(cfg, params, total, modes):
    """Phase 5 on the card for one model; adds each run's launches to
    ``total``.  The kernels of the path are those the prediction launches."""
    prompts, new = continuous_traffic(cfg)
    torch.cuda.reset_peak_memory_stats()
    cruns = phase_continuous(cfg, params, prompts, new, impl="cuda", modes=modes)
    for mode, r in cruns.items():
        print(f"[continuous] {cfg.name} {mode}: {len(prompts)} requests (prompt lengths "
              f"{sorted(len(p) for p in prompts)}, new {sum(new)} tokens), "
              f"{r['tokens_per_s']:.1f} tokens/s in {r['seconds']:.3f}s, latency "
              f"p50={r['p50_s']:.3f}s p99={r['p99_s']:.3f}s; steps={r['steps']} "
              f"admissions={r['admissions']} preemptions={r['preemptions']} "
              f"peak_blocks={r['peak_blocks']}/{r['pool_blocks'] - PC.RESERVED_BLOCKS} "
              f"kv_peak_bytes={r['kv_peak_bytes']} "
              f"full_buffer_bytes={r['full_buffer_bytes']}; launches {r['launches']} "
              f"(predicted {r['predicted']})")
        check(same_launches(r["launches"], r["predicted"]),
              f"continuous {mode}: launches {r['launches']} != {r['predicted']}")
        check(all(r["launches"][k] > 0 for k, n in r["predicted"].items() if n),
              f"continuous {mode}: a kernel of the path never launched")
        for k in total:
            total[k] += r["launches"][k]
    bk = bucketed_on(cfg, params, prompts, new, impl="cuda")
    check(same_launches(bk["launches"], bk["predicted"]),
          f"bucketed: launches {bk['launches']} != {bk['predicted']}")
    for k in total:
        total[k] += bk["launches"][k]
    same_bk = sum(bool((a == b).all()) for a, b in zip(cruns["greedy"]["outputs"],
                                                       bk["outputs"]))
    agree = ""
    if "preempt" in cruns:
        check(cruns["preempt"]["preemptions"] >= 1, "the small pool preempted nothing")
        n_agree = sum(bool((a == b).all()) for a, b in zip(cruns["greedy"]["outputs"],
                                                           cruns["preempt"]["outputs"]))
        agree = f"the preempted greedy run on {n_agree}/{len(prompts)} requests and "
        # the runs batch rows differently, so in bf16 a near-tie may fall
        # the other way in one request; more than one disagreeing is a fault
        check(n_agree >= len(prompts) - 1, "greedy and preempted continuous runs disagree")
    print(f"[continuous] {cfg.name} greedy equals {agree}the bucketed server on "
          f"{same_bk}/{len(prompts)}; bucketed on the same traffic: "
          f"{bk['useful_tokens_per_s']:.1f} useful tokens/s in {bk['seconds']:.3f}s, "
          f"launches {bk['launches']} (predicted {bk['predicted']}); "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} bytes")
    if all(s.kind == ATTN for s in cfg.layers):
        check(same_bk >= len(prompts) - 1, "continuous and bucketed greedy outputs disagree")
        return
    # a recurrent state carries each bf16 rounding difference between the
    # engines' batches on to every later token, so greedy runs part at more
    # near-ties than attention's; each request where they part must be one
    gaps = tie_gaps(cfg, params, prompts, cruns["greedy"]["outputs"], bk["outputs"])
    worst = max((g / sc for g, sc in gaps.values()), default=0.0)
    print(f"[continuous] {cfg.name} where greedy continuous and bucketed part, the two "
          "tokens' larger distance below the top logit, over the top |logit|: "
          + (", ".join(f"request {i} {g / sc:.3e}" for i, (g, sc) in gaps.items()) or "none")
          + f" (tol {RECURRENT_TIE_TOL})")
    check(worst <= RECURRENT_TIE_TOL,
          f"{cfg.name}: continuous and bucketed greedy outputs part at {worst:.3e} below the "
          f"top logit, past a near-tie ({RECURRENT_TIE_TOL})")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = build.build()
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f}s")
    device = torch.device("cuda")

    kern = phase_kernels(device)

    cfg = get_config("qwen2-0.5b")
    params = make_params(cfg, seed=0, device=device)
    report_slice(cfg, params)

    prompts = serve_prompts(cfg)
    want = predicted_launches(cfg, prompts, 64)
    torch.cuda.reset_peak_memory_stats()
    runs = phase_serve(cfg, params, prompts, impl="cuda", new=64)
    total = {k: 0 for k in launches()}
    for mode, r in runs.items():
        print(f"[serve] {mode}: {len(prompts)} requests (prompt lengths "
              f"{sorted(len(p) for p in prompts)}), {r['tokens_per_s']:.1f} tokens/s "
              f"in {r['seconds']:.3f}s; launches {r['launches']} (predicted {want})")
        check(same_launches(r["launches"], want), f"{mode}: launches {r['launches']} != {want}")
        for k in total:
            total[k] += r["launches"][k]
    same = sum(bool((a == b).all()) for a, b in zip(runs["greedy"]["outputs"],
                                                     runs["sampled"]["outputs"]))
    print(f"[serve] sampled equals greedy on {same}/{len(prompts)} requests; "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} bytes")
    report_continuous(cfg, params, total, ("greedy", "sampled", "preempt"))
    del params
    torch.cuda.empty_cache()

    for name in ("granite-moe-1b-a400m", "mamba2-1.3b", "recurrentgemma-9b"):
        cfg = get_config(name)
        t0 = time.perf_counter()
        params = make_params(cfg, seed=0, device=device)
        n_params = sum(t.numel() for p in params["layers"] for t in _leaves(p))
        print(f"[model] {name}: {cfg.num_layers} layers, {n_params} layer parameters "
              f"(+ {params['embed']['table'].numel()} embedding), built in "
              f"{time.perf_counter() - t0:.1f}s; memory_allocated="
              f"{torch.cuda.memory_allocated()} bytes")
        report_slice(cfg, params)
        report_continuous(cfg, params, total, ("greedy", "sampled"))
        del params
        torch.cuda.empty_cache()

    report_train(get_config("qwen2-0.5b"), train_experiment(), device, total)
    report_phase7(device, total)
    report_engine(device, total)

    source = "src/repro_torch/kernels/csrc/"
    rows = [dict(name="flash_mha", route="cuda", source=source + "flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention.py:91",
                 launches=total["flash_mha"], **kern["flash_mha"]),
            dict(name="flash_decode", route="cuda", source=source + "decode_attention.cu",
                 replaces="src/repro/kernels/decode_attention.py:82",
                 launches=total["flash_decode"], **kern["flash_decode"]),
            dict(name="paged_flash_decode", route="cuda",
                 source=source + "paged_decode_attention.cu",
                 replaces="src/repro/kernels/paged_decode_attention.py:43",
                 launches=total["paged_flash_decode"], **kern["paged_flash_decode"]),
            dict(name="grouped_ffn", route="cuda", source=source + "grouped_expert.cu",
                 replaces="src/repro/kernels/grouped_expert.py:73",
                 launches=total["grouped_ffn"], **kern["grouped_ffn"]),
            dict(name="ssd_scan", route="cuda", source=source + "ssd_scan.cu",
                 replaces="src/repro/kernels/ssd_scan.py:76",
                 launches=total["ssd_scan"], **kern["ssd_scan"]),
            dict(name="rglru_scan", route="cuda", source=source + "rglru_scan.cu",
                 replaces="src/repro/kernels/rglru_scan.py:48",
                 launches=total["rglru_scan"], **kern["rglru_scan"]),
            dict(name="flash_mha_varlen", route="cuda", source=source + "varlen_attention.cu",
                 replaces="src/repro/kernels/varlen_attention.py:117",
                 launches=total["flash_mha_varlen"], **kern["flash_mha_varlen"])]
    for r in rows:
        check(all(math.isfinite(r[k]) for k in ("ms", "cold_ms", "plain_ms", "bound_ms")),
              f"{r['name']}: non-finite time")
        check(r["library_ms"] is None or math.isfinite(r["library_ms"]),
              f"{r['name']}: non-finite library time")
        check(r["launches"] > 0, f"{r['name']}: never launched on the main path")
    print(f"[time] chip_smoke wall time {time.perf_counter() - t_start:.1f}s")
    print(smi)  # again, so that the card stays beside the numbers in a tail of the output
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
