#!/usr/bin/env python3
"""The readings behind ``chip_smoke.py``'s scan and engine-agreement
limits, each beside that of a planted fault the limit has to fail, on a
CUDA card.

1. ``ssd_scan`` on ``chip_smoke.SSD_CASES`` against the plain version run in
   fp32 on the same values (the sound reading, as ``chip_smoke`` holds it),
   and the plain version with a planted loss of precision against the same:
   its state rounded to bf16 between 64-row pieces; x * dt rounded to bf16;
   for fp32 inputs also B and C rounded to bf16.
2. For mamba2-1.3b and recurrentgemma-9b on ``chip_smoke``'s continuous
   traffic: where greedy ``ContinuousBatchServer`` and ``BatchServer``
   outputs part, each request's gap (``chip_smoke.tie_gaps``), sound and
   with a planted fault: after every admission, each admitted slot's
   recurrent state is replaced by the next slot's, in every recurrent layer
   and then in the last one only.
3. mamba2-1.3b's full-depth bf16 logits (``chip_smoke.phase_slice``'s
   tokens): the plain version at chunk 64 against chunk 128, the spread of
   the plain version alone (the kernel walks pieces of its own whatever
   the chunk: 128 rows in bf16, 64 in fp32).
4. For phase 12's dense configs (qwen3-1.7b, gemma3-1b, qwen2.5-14b) on
   their continuous traffic: the same gaps, sound and with a planted
   paged-decode fault: each row's own new key left out of its attention
   (``cache_len`` one short), in every global (paged) layer and then in
   the last one only; and under each, phase 3's paged-vs-dense decode
   error (``chip_smoke.phase_paged_slice``).
5. For arctic-480b as phase 14 runs it (full width, ``chip_smoke.ARCTIC_LAYERS``
   layers, bf16), the largest router probability gap at a route parting
   that no earlier one reaches (``chip_smoke.first_partings``), which
   ``chip_smoke.BF16_ROUTE_TIE_TOL`` holds: the tiers
   (``chip_smoke.phase_slice``) sound and with the cuda run given a
   planted fault (the last layer's router column 0 scaled by 1.5; every
   router weight scaled by 1.05; layer 0's dense residual left out); the
   capacity dispatch's tiers and its 4-token cohorts against the dropless
   dispatch (``chip_smoke.phase_capacity``); the engines
   (``chip_smoke.engine_partings``) sound and with part 4's paged-decode
   fault in every layer and in the last one; then on layer 0 alone the
   gradient's tokens (``chip_smoke.parted_tokens``) and the expert split
   (``chip_smoke.phase_ep``).

    PYTHONPATH=src python scripts/limit_controls.py [ssd] [recurrent] [dense] [routes]

runs the named parts (all without arguments).  Prints the card's name and
power limit first.  Fails without a card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.base import ATTN  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.models import attention as ATT  # noqa: E402
from repro_torch.models import model as MDL  # noqa: E402
from repro_torch.models import paged_cache as PC  # noqa: E402

PIECE = 64  # the kernel's rows per piece


def scaled_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs() / (1 + want.abs())).max().item()


def bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def ssd_bf16_state(x, dt, a_log, bm, cm, d):
    """The plain version piece by piece with its state rounded to bf16
    between pieces; y in x's dtype."""
    ys, st = [], None
    for i in range(0, x.shape[1], PIECE):
        s = slice(i, i + PIECE)
        y, st = ref.ssd_ref(x[:, s], dt[:, s], a_log, bm[:, s], cm[:, s], d, chunk=PIECE,
                            init_state=st, return_state=True)
        st = bf16(st)
        ys.append(y)
    return torch.cat(ys, dim=1)


def ssd_bf16_xdt(x, dt, a_log, bm, cm, d):
    """The plain version with x * dt rounded to bf16 (the fp32 product
    carried in bf16); y in x's dtype."""
    xf, dtp = x.float(), dt[..., None]
    xdt = bf16(xf * dtp)
    y = ref.ssd_ref(torch.where(dtp > 0, xdt / dtp, xf), dt, a_log, bm.float(), cm.float(), d,
                    chunk=cs.SSD_CHUNK)
    return y.to(x.dtype)


def ssd_readings():
    device = torch.device("cuda")
    cases, _ = cs.ssd_cases(device)
    for name, args in cases.items():
        f32 = tuple(t.float() for t in args)
        want = ref.ssd_ref(*f32, chunk=cs.SSD_CHUNK)
        tol = cs.SSD_BF16_TOL if args[0].dtype == torch.bfloat16 else cs.FP32_SCAN_TOL
        rows = {"kernel (sound)": cs.ssd_scan(*args, chunk=cs.SSD_CHUNK),
                "plain, bf16 state": ssd_bf16_state(*args),
                "plain, bf16 x*dt": ssd_bf16_xdt(*args)}
        if args[0].dtype == torch.float32:
            x, dt, a_log, bm, cm, d = args
            rows["plain, bf16 B and C"] = ref.ssd_ref(x, dt, a_log, bf16(bm), bf16(cm), d,
                                                      chunk=cs.SSD_CHUNK)
        torch.cuda.synchronize()
        for what, y in rows.items():
            print(f"[ssd] {name} y, {what}: scaled_err={scaled_err(y, want):.3e} (tol {tol})")


def neighbour_state(layers):
    """``paged_insert`` that then gives each admitted slot the state of the
    next slot in ``layers``."""
    real = PC.paged_insert

    def insert(cfg, caches, dense, slots, table_rows, prompt_len, *, n_slots):
        out = real(cfg, caches, dense, slots, table_rows, prompt_len, n_slots=n_slots)
        slots = torch.as_tensor(slots).to("cpu", torch.int64)
        dst = slots[slots < n_slots]
        for i in layers:
            for t in caches[i].values():
                d = dst.to(t.device)
                t[d] = t[(d + 1) % n_slots].clone()
        return out
    return insert


def gap_readings(name):
    device = torch.device("cuda")
    cfg = cs.get_config(name)
    params = cs.make_params(cfg, seed=0, device=device)
    prompts, new = cs.continuous_traffic(cfg)
    bk = cs.bucketed_on(cfg, params, prompts, new, impl="cuda")
    rec = [i for i, s in enumerate(cfg.layers) if s.kind != ATTN]
    real = PC.paged_insert
    for what, layers in (("sound", []), ("every recurrent layer fed the next slot's state", rec),
                         ("last recurrent layer fed the next slot's state", rec[-1:])):
        PC.paged_insert = neighbour_state(layers) if layers else real
        try:
            run = cs.phase_continuous(cfg, params, prompts, new, impl="cuda",
                                      modes=("greedy",))["greedy"]
        finally:
            PC.paged_insert = real
        gaps = cs.tie_gaps(cfg, params, prompts, run["outputs"], bk["outputs"])
        scaled = {i: g / sc for i, (g, sc) in gaps.items()}
        worst = max(scaled.values(), default=0.0)
        print(f"[gaps] {name} {what}: {len(gaps)}/{len(prompts)} requests part; largest "
              f"{worst:.3e} (tol {cs.RECURRENT_TIE_TOL}); "
              + ", ".join(f"request {i} {g:.3e}" for i, g in sorted(scaled.items())))
    if name == "mamba2-1.3b":
        chunk_spread(cfg, params)
    del params
    torch.cuda.empty_cache()


def own_key_dropped(n_global, faulty):
    """``attention.paged_attn_decode_apply`` that, in the global layers of
    ``faulty`` (indices among the model's ``n_global`` global layers, which
    each decode step calls in order), attends with ``cache_len`` one short:
    the row's own new key, written at its position, is left out."""
    real = ATT.paged_attn_decode_apply
    calls = [0]

    def apply(p, cfg, x, cache, block_table, dest, rope, cache_len, **kw):
        i = calls[0] % n_global
        calls[0] += 1
        return real(p, cfg, x, cache, block_table, dest, rope,
                    cache_len - 1 if i in faulty else cache_len, **kw)
    return apply


def dense_gap_readings(name):
    device = torch.device("cuda")
    cfg = cs.get_config(name)
    params = cs.make_dense_params(cfg, seed=0, device=device)
    prompts, new = cs.continuous_traffic(cfg, max_prompt=cs.DENSE_MAX_PROMPT[name])
    bk = cs.bucketed_on(cfg, params, prompts, new, impl="cuda")
    n_global = cs.attn_layers(cfg, local=False)
    real = ATT.paged_attn_decode_apply
    for what, faulty in (("sound", ()),
                         ("own key left out in every global layer", range(n_global)),
                         ("own key left out in the last global layer", (n_global - 1,))):
        ATT.paged_attn_decode_apply = own_key_dropped(n_global, set(faulty)) if faulty else real
        try:
            run = cs.phase_continuous(cfg, params, prompts, new, impl="cuda",
                                      modes=("greedy",))["greedy"]
            pg = cs.phase_paged_slice(cfg, params, impl="cuda",
                                      prompt_len=cs.DENSE_SLICE_PROMPT[name])
        finally:
            ATT.paged_attn_decode_apply = real
        gaps = cs.tie_gaps(cfg, params, prompts, run["outputs"], bk["outputs"])
        scaled = {i: g / sc for i, (g, sc) in gaps.items()}
        worst = max(scaled.values(), default=0.0)
        print(f"[dense gaps] {name} ({n_global} global layers) {what}: {len(gaps)}/"
              f"{len(prompts)} requests part; largest {worst:.3e} (tol "
              f"{cs.RECURRENT_TIE_TOL}); "
              + ", ".join(f"request {i} {g:.3e}" for i, g in sorted(scaled.items())))
        print(f"[dense paged] {name} {what}: phase 3's paged vs dense decode paged_err="
              f"{pg['paged_err']:.3e} (tol {0.0 if pg['same_grid'] else cs.LOGIT_TOL})")
    del params, bk
    cs.free(device)


def scaled_router(params, layer, column, factor):
    """``params`` with layer ``layer``'s router weight scaled by ``factor``
    (only its column ``column``; None: all of it); the experts are shared."""
    layers = list(params["layers"])
    ffn = layers[layer]["ffn"]
    w = ffn["router"]["w"].clone()
    if column is None:
        w *= factor
    else:
        w[:, column] *= factor
    layers[layer] = dict(layers[layer], ffn=dict(ffn, router={**ffn["router"], "w": w}))
    return {**params, "layers": layers}


@contextlib.contextmanager
def cuda_run_on(params):
    """``chip_smoke.compare_routed``'s cuda run on ``params``."""
    real = cs.routed_logits

    def routed(c, p, *a, impl, **kw):
        return real(c, params if impl == "cuda" else p, *a, impl=impl, **kw)
    cs.routed_logits = routed
    try:
        yield
    finally:
        cs.routed_logits = real


def route_readings(cfg, device):
    params = cs.make_dense_params(cfg, seed=0, device=device)
    tol = cs.BF16_ROUTE_TIE_TOL
    last = cfg.num_layers - 1
    no_dense = {**params, "layers": [dict(params["layers"][0], ffn={
        k: v for k, v in params["layers"][0]["ffn"].items() if k != "dense"}),
        *params["layers"][1:]]}
    for what, faulty in (("sound", None),
                         ("last router's column 0 x 1.5", scaled_router(params, last, 0, 1.5)),
                         ("every router weight x 1.05", scaled_router(
                             scaled_router(params, 0, None, 1.05), last, None, 1.05)),
                         ("layer 0's dense residual left out", no_dense)):
        with cuda_run_on(faulty or params):
            r = cs.phase_slice(cfg, params, impl="cuda")
        print(f"[routes] {cfg.name} tiers, {what}: largest gap at a first parting "
              f"{r['held_gap']:.3e} (tol {tol}); {r['parted']} of {r['entries']} compared "
              f"tokens parted, route agreement {r['route_agreement']:.4f}, error over the "
              f"others {r['agreed_err']:.3e} (tol {cs.LOGIT_TOL})")
    r = cs.phase_capacity(cfg, params, impl="cuda")
    for key, x in (("capacity dispatch tiers", r), ("capacity vs dropless, 4-token cohorts",
                                                     r["small"])):
        print(f"[routes] {cfg.name} {key}, sound: largest gap at a first parting "
              f"{x['held_gap']:.3e} (tol {tol}); {x['parted']} of {x['entries']} parted")
    prompts, new = cs.continuous_traffic(cfg)
    n_global = cs.attn_layers(cfg, local=False)
    real = ATT.paged_attn_decode_apply
    for what, faulty in (("sound", ()),
                         ("own key left out in every layer", range(n_global)),
                         ("own key left out in the last layer", (n_global - 1,))):
        ATT.paged_attn_decode_apply = own_key_dropped(n_global, set(faulty)) if faulty else real
        try:
            ties, routes = cs.engine_partings(cfg, params, prompts, new)
        finally:
            ATT.paged_attn_decode_apply = real
        past = [i for i, g in ties.items() if g > cs.RECURRENT_TIE_TOL]
        print(f"[routes] {cfg.name} engines, {what}: outputs part on {len(ties)}/{len(prompts)} "
              f"requests, {len(past)} past the logit near-tie, "
              f"{sum(not routes[i][0] for i in past)} of those with no route parted before; "
              f"largest gap at a first parting {max(h for _, h in routes.values()):.3e} "
              f"(tol {tol}); per request (partings, gap): {routes}")
    del params["layers"][1:], no_dense
    cfg = cs.shallow(cfg, 1)
    cs.free(device)
    batch = cs.lm_batch(cfg, device, **cs.ARCTIC_TRAIN)
    parted, gap = cs.parted_tokens(cfg, params, batch["tokens"], impl="cuda")
    print(f"[routes] {cfg.name} 1 layer, the gradient's tokens, sound: largest gap at a first "
          f"parting {gap:.3e} (tol {tol}); {int(parted.sum())} of {parted.numel()} parted")
    r = cs.phase_ep(cfg, params, cs.ARCTIC_EP, impl="cuda")
    print(f"[routes] {cfg.name} 1 layer, the expert split over {cs.ARCTIC_EP}, sound: largest "
          f"gap at a first parting {r['held_gap']:.3e} (tol {tol}); {r['parted']} of "
          f"{r['tokens']} parted")
    del params
    cs.free(device)


def chunk_spread(cfg, params, batch=4, prompt_len=256, steps=8, seed=0):
    """Reference logits at chunk 64 against chunk 128 on ``phase_slice``'s
    tokens."""
    device = params["embed"]["table"].device
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (batch, prompt_len))).to(device)
    feed = torch.from_numpy(rng.integers(1, cfg.vocab_size, (batch, steps))).to(device)
    logits = []
    for c in (dataclasses.replace(cfg, ssm_chunk=64), cfg):
        last, caches = MDL.prefill(params, c, {"tokens": toks}, prompt_len + steps,
                                   impl="reference")
        out = [MDL.logits_of(params, c, last[:, None])[:, 0]]
        for i in range(steps):
            lg, caches = MDL.decode_step(params, c, feed[:, i], caches, prompt_len + i,
                                         impl="reference")
            out.append(lg)
        logits.append(torch.stack(out, dim=1))
        del caches
    got, want = logits
    scale = want.abs().amax().item()
    err = (got - want).abs()
    print(f"[chunk] {cfg.name} reference at chunk 64 vs chunk {cfg.ssm_chunk}: prefill_err="
          f"{err[:, 0].max().item() / scale:.3e} decode_err="
          f"{err[:, 1:].max().item() / scale:.3e} (of max |logit| {scale:.3f}; chip_smoke "
          f"holds cuda vs reference to {cs.LOGIT_TOL})")


def main():
    if not torch.cuda.is_available():
        print("limit_controls: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    parts = set(sys.argv[1:]) or {"ssd", "recurrent", "dense", "routes"}
    build.build()
    if "ssd" in parts:
        ssd_readings()
    if "recurrent" in parts:
        for name in ("mamba2-1.3b", "recurrentgemma-9b"):
            gap_readings(name)
    if "dense" in parts:
        for name in cs.DENSE:
            dense_gap_readings(name)
    if "routes" in parts:
        route_readings(cs.shallow(cs.get_config(cs.ARCTIC), cs.ARCTIC_LAYERS),
                       torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
