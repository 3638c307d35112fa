#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. print the card's name and power limit; build the CUDA kernels from
     src/repro_torch/kernels/csrc (one nvcc per source, started together);
  2. hold each kernel against its plain PyTorch version on the card at this
     slice's shapes (bf16) and time kernel (inputs warm in L2 as ``ms``,
     L2 flushed before each call as ``cold_ms``), plain version, bound and
     ``scaled_dot_product_attention``;
  3. full-width qwen2-0.5b (24 layers, bf16, seeded random weights):
     prefill last-position logits and 8 teacher-forced decode steps under
     impl="cuda" against impl="reference"; then the same prompts admitted
     through ``paged_insert`` into a shuffled block table and 8
     teacher-forced paged decode steps against the dense decode;
  4. ``BatchServer.serve``: 8 ragged requests (prompts 16-400 tokens), 64
     new tokens, greedy then sampled, with the kernels' launch counts held
     to what the shapes predict;
  5. ``ContinuousBatchServer.serve``: 16 ragged requests (prompts 16-400
     tokens, 8-64 new tokens each), 8 slots, blocks of 16, greedy, sampled,
     then greedy on a pool too small for all rows (preemption), with the
     launch counts held to the prediction; then the bucketed server on the
     same traffic for comparison.
Then one JSON line of kernel numbers, and last {"ok": true, "device": ...}.

Phases 3 to 5 are functions of (config, params, impl) so the CPU tests
rehearse them at the reduced size with impl="reference".
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.decode_attention import flash_decode  # noqa: E402
from repro_torch.kernels.flash_attention import flash_mha  # noqa: E402
from repro_torch.kernels.paged_decode_attention import paged_flash_decode  # noqa: E402
from repro_torch.launch.serve import (BatchServer, ContinuousBatchServer,  # noqa: E402
                                      bucket_of)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as MDL  # noqa: E402
from repro_torch.models import paged_cache as PC  # noqa: E402

# Published H100 SXM peaks: dense bf16 tensor-core rate and HBM3 bandwidth.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# Kernel vs plain version, bf16 inputs, |err| <= KERNEL_TOL * (1 + |plain|):
# the plain version rounds the scores and probabilities to bf16 before its
# second product (as the JAX reference does), the kernels keep them in fp32;
# 2e-2 is the JAX package's own bf16 tolerance for its kernels.
KERNEL_TOL = 2e-2
# Full model, impl="cuda" vs impl="reference": max |logit difference| over
# max |reference logit|.  Both run bf16 through 24 layers and differ only in
# where attention rounds to bf16.
LOGIT_TOL = 5e-2
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


KERNELS = (flash_mha, flash_decode, paged_flash_decode)


def reset_launches():
    for k in KERNELS:
        k.launches = 0


def launches():
    return {k.__name__: k.launches for k in KERNELS}


def make_params(cfg, *, seed, device):
    params = MDL.init_params(cfg, seed=seed, device=device)
    params["embed"]["table"].mul_(EMBED_SCALE)
    return params


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
        max_abs_err=max(errs),
        ms=time_ms(lambda: flash_mha(q, k, v, causal=True)),
        cold_ms=time_cold_ms(lambda: flash_mha(q, k, v, causal=True)),
        plain_ms=time_ms(lambda: ref.mha_ref(q, k, v, causal=True)),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)))

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
        max_abs_err=max(errs),
        ms=time_ms(lambda: flash_decode(q, kc, vc, cache_len=lens)),
        cold_ms=time_cold_ms(lambda: flash_decode(q, kc, vc, cache_len=lens)),
        plain_ms=time_ms(lambda: ref.decode_mha_ref(q, kc, vc, cache_len=lens)),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True)))
    out["paged_flash_decode"] = paged_kernel_case(randn, device, hq, hkv, d)
    for name, r in out.items():
        print(f"[kernels] {name}: ms={r['ms']:.4f} (warm L2) cold_ms={r['cold_ms']:.4f} "
              f"(L2 flushed) plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms={r['library_ms']:.4f}")
    return out


def paged_kernel_case(randn, device, hq, hkv, d):
    """paged_flash_decode at the continuous engine's decode shapes: 8 rows,
    blocks of 16, a 36-block table into a shuffled pool of 1 + 8 * 36
    blocks, ragged cache lengths with a row of 0 and one of M * bs; then
    the table past each live prefix pointed at a poisoned block 0, and
    blocks of 8."""
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
        qq, kp, vp, tbl = args
        gathered = [p[tbl.long()].reshape(b, -1, hkv, d) for p in (kp, vp)]
        same = flash_decode(qq, *gathered, cache_len=lens)
        torch.cuda.synchronize()
        abs_err, rel_err = _max_err(got, want)
        vs_dense = (got.float() - same.float()).abs().max().item()
        print(f"[kernels] paged_flash_decode {name}: max_abs_err={abs_err:.3e} "
              f"scaled_err={rel_err:.3e}; vs flash_decode on the gathered cache "
              f"max_abs_diff={vs_dense:.3e}")
        check(rel_err <= KERNEL_TOL, f"paged_flash_decode {name}: err {rel_err} > {KERNEL_TOL}")
        errs.append(abs_err)
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

    return dict(
        max_abs_err=max(errs),
        ms=time_ms(lambda: paged_flash_decode(q, k_pool, v_pool, table, cache_len=lens)),
        cold_ms=time_cold_ms(lambda: paged_flash_decode(q, k_pool, v_pool, table,
                                                        cache_len=lens)),
        plain_ms=time_ms(lambda: ref.paged_decode_mha_ref(q, k_pool, v_pool, table,
                                                          cache_len=lens)),
        bound_ms=bms, bound_by=by, library_ms=time_ms(library))


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


# ------------------------------------------------------------------ phase 4

def serve_prompts(cfg, *, requests=8, min_prompt=16, max_prompt=400, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n)
            for n in rng.integers(min_prompt, max_prompt + 1, requests)]


def predicted_launches(cfg, prompts, new):
    """One flash_mha per layer per bucket (the prefill), one flash_decode
    per layer per decode step (new - 1 steps per bucket), no paged decode."""
    n_buckets = len({bucket_of(len(p)) for p in prompts})
    return {"flash_mha": cfg.num_layers * n_buckets,
            "flash_decode": cfg.num_layers * (new - 1) * n_buckets,
            "paged_flash_decode": 0}


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
                     sync_every=4, seed=0):
    """Serve with ``ContinuousBatchServer`` greedy, sampled, then greedy on a
    pool of room for two full-length rows (preemption).  Each run counts
    its admission dispatches by wrapping the server's ``_admit``, and the
    kernels' launches from just before ``serve`` to just after.  Returns per
    run the server's numbers, the launches and their prediction."""
    device = params["embed"]["table"].device
    kw = dict(n_slots=n_slots, kv_block_size=block_size, max_prompt=max(map(len, prompts)),
              max_new=max(new), impl=impl, sync_every=sync_every)
    runs, full_row = {}, None
    for mode, s in (("greedy", None), ("sampled", seed + 1), ("preempt", None)):
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
            predicted={"flash_mha": cfg.num_layers * admits[0], "flash_decode": 0,
                       "paged_flash_decode": cfg.num_layers * sync_every * st["steps"]},
            outputs=toks)
    return runs


def bucketed_on(cfg, params, prompts, new, *, impl):
    """The bucketed server on the same traffic: it generates max(new) tokens
    for every request; useful tokens/s counts only each request's own."""
    device = params["embed"]["table"].device
    server = BatchServer(cfg, params, max_new=max(new), impl=impl)
    sync(device)
    t0 = time.perf_counter()
    outs = server.serve(prompts)
    sync(device)
    dt = time.perf_counter() - t0
    return {"seconds": dt, "useful_tokens_per_s": sum(new) / dt,
            "outputs": [o[:n].cpu().numpy() for o, n in zip(outs, new)]}


# ------------------------------------------------------------------ main

def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 1
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
    sl = phase_slice(cfg, params, impl="cuda")
    print(f"[slice] {cfg.name} {cfg.num_layers} layers bf16: prefill_err="
          f"{sl['prefill_err']:.3e} decode_err={sl['decode_err']:.3e} "
          f"(of max |logit| {sl['logit_scale']:.3f}; tol {LOGIT_TOL}) "
          f"argmax_agreement={sl['argmax_agreement']:.3f}")
    check(sl["prefill_err"] <= LOGIT_TOL and sl["decode_err"] <= LOGIT_TOL,
          "cuda logits disagree with the reference")
    pg = phase_paged_slice(cfg, params, impl="cuda")
    print(f"[slice] paged decode vs dense decode, both cuda: paged_err={pg['paged_err']:.3e} "
          f"(of max |logit| {pg['logit_scale']:.3f}; tol {LOGIT_TOL}) "
          f"argmax_agreement={pg['argmax_agreement']:.3f}")
    check(pg["paged_err"] <= LOGIT_TOL, "paged logits disagree with the dense decode")

    prompts = serve_prompts(cfg)
    want = predicted_launches(cfg, prompts, 64)
    torch.cuda.reset_peak_memory_stats()
    runs = phase_serve(cfg, params, prompts, impl="cuda", new=64)
    total = {k: 0 for k in launches()}
    for mode, r in runs.items():
        print(f"[serve] {mode}: {len(prompts)} requests (prompt lengths "
              f"{sorted(len(p) for p in prompts)}), {r['tokens_per_s']:.1f} tokens/s "
              f"in {r['seconds']:.3f}s; launches {r['launches']} (predicted {want})")
        check(r["launches"] == want, f"{mode}: launches {r['launches']} != {want}")
        for k in total:
            total[k] += r["launches"][k]
    same = sum(bool((a == b).all()) for a, b in zip(runs["greedy"]["outputs"],
                                                     runs["sampled"]["outputs"]))
    print(f"[serve] sampled equals greedy on {same}/{len(prompts)} requests; "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} bytes")

    prompts, new = continuous_traffic(cfg)
    torch.cuda.reset_peak_memory_stats()
    cruns = phase_continuous(cfg, params, prompts, new, impl="cuda")
    for mode, r in cruns.items():
        print(f"[continuous] {mode}: {len(prompts)} requests (prompt lengths "
              f"{sorted(len(p) for p in prompts)}, new {sum(new)} tokens), "
              f"{r['tokens_per_s']:.1f} tokens/s in {r['seconds']:.3f}s, latency "
              f"p50={r['p50_s']:.3f}s p99={r['p99_s']:.3f}s; steps={r['steps']} "
              f"admissions={r['admissions']} preemptions={r['preemptions']} "
              f"peak_blocks={r['peak_blocks']}/{r['pool_blocks'] - PC.RESERVED_BLOCKS} "
              f"kv_peak_bytes={r['kv_peak_bytes']} "
              f"full_buffer_bytes={r['full_buffer_bytes']}; launches {r['launches']} "
              f"(predicted {r['predicted']})")
        check(r["launches"] == r["predicted"],
              f"continuous {mode}: launches {r['launches']} != {r['predicted']}")
        check(r["launches"]["flash_mha"] > 0 and r["launches"]["paged_flash_decode"] > 0,
              f"continuous {mode}: a kernel of the path never launched")
        for k in total:
            total[k] += r["launches"][k]
    check(cruns["preempt"]["preemptions"] >= 1, "the small pool preempted nothing")
    agree = sum(bool((a == b).all()) for a, b in zip(cruns["greedy"]["outputs"],
                                                     cruns["preempt"]["outputs"]))
    bk = bucketed_on(cfg, params, prompts, new, impl="cuda")
    same_bk = sum(bool((a == b).all()) for a, b in zip(cruns["greedy"]["outputs"],
                                                       bk["outputs"]))
    print(f"[continuous] greedy equals the preempted greedy run on {agree}/{len(prompts)} "
          f"requests and the bucketed server on {same_bk}/{len(prompts)}; bucketed on "
          f"the same traffic: {bk['useful_tokens_per_s']:.1f} useful tokens/s in "
          f"{bk['seconds']:.3f}s; max_memory_allocated="
          f"{torch.cuda.max_memory_allocated()} bytes")
    # the three runs batch rows differently, so in bf16 a near-tie may fall
    # the other way in one request; more than one disagreeing is a fault
    check(agree >= len(prompts) - 1, "greedy and preempted continuous runs disagree")
    check(same_bk >= len(prompts) - 1, "continuous and bucketed greedy outputs disagree")

    source ="src/repro_torch/kernels/csrc/"
    rows = [dict(name="flash_mha", route="cuda", source=source + "flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention.py:91",
                 launches=total["flash_mha"], **kern["flash_mha"]),
            dict(name="flash_decode", route="cuda", source=source + "decode_attention.cu",
                 replaces="src/repro/kernels/decode_attention.py:82",
                 launches=total["flash_decode"], **kern["flash_decode"]),
            dict(name="paged_flash_decode", route="cuda",
                 source=source + "paged_decode_attention.cu",
                 replaces="src/repro/kernels/paged_decode_attention.py:43",
                 launches=total["paged_flash_decode"], **kern["paged_flash_decode"])]
    for r in rows:
        check(all(math.isfinite(r[k]) for k in ("ms", "cold_ms", "plain_ms", "bound_ms",
                                                "library_ms")),
              f"{r['name']}: non-finite time")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
