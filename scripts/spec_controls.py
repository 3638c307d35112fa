#!/usr/bin/env python3
"""The readings behind ``chip_smoke.py``'s ``SPEC_TIE_TOL`` and
``SPEC_LOGPROB_TOL``, each beside that of a planted fault the limits have to
fail, on a CUDA card.

    PYTHONPATH=src python scripts/spec_controls.py

Full-width qwen2-0.5b (24 layers, bf16) with its 2-layer draft
(``chip_smoke.spec_draft``: the target's embedding and first two layers),
``chip_smoke.py`` phase 9's traffic:
1. greedy ``spec_generate`` on 16 prompts of 128 tokens, 256 new, against
   greedy ``generate``: the rows that agree and, where they part, each
   row's near-tie (``chip_smoke.spec_partings``); the spec logprobs against
   a teacher-forced forward and against ``generate``'s on the rows that
   agree (``chip_smoke.logprob_errors``, held to ``SPEC_LOGPROB_TOL``); the
   seconds of both;
2. the speculative ``ContinuousBatchServer`` on phase 5's traffic against
   the plain one, the same readings (``chip_smoke.tie_gaps``,
   ``logprob_errors`` over the bucket-padded prompts);
3. the fp32 check on 2 layers (draft 1): rows that agree, largest logprob
   difference.
Each sound, then with a planted fault in the verify's attention
(``ops.paged_verify_mha``): ``late``, every query one position later (query
j also attends the next token's key); ``no-positions``, ``flash_mha``
without positions over the gathered pool (query j attends slots 0 .. j).
4. Sound only: phase 9's ``RLHFExperiment`` with the 2-layer draft, two
   ``run_iteration``s (``chip_smoke.phase_spec_engine``) in this process,
   where no model was trained before: each iteration's seconds and calls,
   the memory allocated before and after it and its peak.

Prints the card's name and power limit first.  Fails without a card.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import ops as OPS  # noqa: E402
from repro_torch.kernels.flash_attention import flash_mha  # noqa: E402

SOUND = OPS.paged_verify_mha


def late(q, k_pool, v_pool, block_table, *, q_positions, impl):
    return SOUND(q, k_pool, v_pool, block_table, q_positions=q_positions + 1, impl=impl)


def no_positions(q, k_pool, v_pool, block_table, *, q_positions, impl):
    return flash_mha(q.contiguous(), ref.gather_pool(k_pool, block_table),
                     ref.gather_pool(v_pool, block_table), causal=True)


FAULTS = {"sound": SOUND, "late": late, "no-positions": no_positions}


@contextlib.contextmanager
def verify_as(fn):
    OPS.paged_verify_mha = fn
    try:
        yield
    finally:
        OPS.paged_verify_mha = SOUND


def gaps_line(gaps):
    worst = max(gaps.values(), default=0.0)
    return (f"worst {worst:.3e}; " + (", ".join(f"{i}: {g:.3e}" for i, g in gaps.items())
                                      or "no parting"))


def errs_line(errs):
    return (f"logprobs against a teacher-forced forward {errs['teacher_forced']:.3e}, against "
            f"the plain run's on the {errs['n_agree']} that agree {errs['agree']:.3e}, of max "
            f"|logit| {errs['scale']:.3f} (SPEC_LOGPROB_TOL {cs.SPEC_LOGPROB_TOL})")


def engine_readings(cfg, dcfg, device):
    en = cs.phase_spec_engine(cfg, dcfg, cs.train_experiment(packed=False), device)
    print(f"[spec-controls] engine with a {dcfg.num_layers}-layer draft, {en['plan']}; "
          f"memory_allocated before it was built {en['before_bytes']} bytes")
    for it, r in enumerate(en["iters"]):
        print(f"[spec-controls] engine run_iteration {it}: {r['seconds']:.3f}s (calls "
              + ", ".join(f"{n} {s:.3f}s" for n, s in r["calls"].items())
              + f"); accept_rate {r['spec_stats']['accept_rate']:.4f}; memory_allocated "
              f"{r['held_bytes']} bytes before, {r['after_bytes']} after, "
              f"max_memory_allocated {r['peak_bytes']} during it")


def rollout_readings(cfg, params, dcfg, dparams, prompts, new, tag, faults):
    t0 = time.perf_counter()
    plain = cs.MDL.generate(params, cfg, {"tokens": prompts}, num_new_tokens=new, impl="cuda")
    cs.sync("cuda")
    plain_s = time.perf_counter() - t0
    for name in faults:
        with verify_as(FAULTS[name]):
            t0 = time.perf_counter()
            out = cs.SPEC.spec_generate(params, cfg, dparams, dcfg, {"tokens": prompts},
                                        num_new_tokens=new, spec_k=cs.SPEC_K, impl="cuda",
                                        controller=cs.SPEC.SpecController(init_k=cs.SPEC_K))
            cs.sync("cuda")
            spec_s = time.perf_counter() - t0
        same, gaps = cs.spec_partings(cfg, params, prompts, out["tokens"].cpu(),
                                      plain["tokens"].cpu())
        lp = (out["logprobs"] - plain["logprobs"]).abs().max().item()
        errs = cs.logprob_errors(cfg, params, prompts, (out["tokens"].cpu(),
                                                        out["logprobs"].cpu()),
                                 (plain["tokens"].cpu(), plain["logprobs"].cpu()), impl="cuda")
        st = out["stats"]
        print(f"[spec-controls] {tag} {name}: {same}/{len(prompts)} rows equal generate's, "
              f"largest logprob difference {lp:.3e}; {errs_line(errs)}; near-ties "
              f"{gaps_line(gaps)}; "
              f"accept_rate {st['accept_rate']:.4f}, cycles {st['cycles']}; spec "
              f"{spec_s:.3f}s, generate {plain_s:.3f}s")


def server_readings(cfg, params, dcfg, dparams, faults):
    prompts, new = cs.continuous_traffic(cfg)
    base = cs.phase_spec_server(cfg, params, dcfg, dparams, prompts, new, impl="cuda")
    for name in faults:
        with verify_as(FAULTS[name]):
            r = cs.phase_spec_server(cfg, params, dcfg, dparams, prompts, new, impl="cuda")
        outs_s, outs_p = r["spec"]["outputs"], base["plain"]["outputs"]
        same = sum(bool((a == b).all()) for a, b in zip(outs_s, outs_p))
        gaps = {i: g / sc for i, (g, sc) in cs.tie_gaps(cfg, params, prompts, outs_s,
                                                         outs_p).items()}
        errs = cs.logprob_errors(cfg, params, prompts, (outs_s, r["spec"]["logprobs"]),
                                 (outs_p, base["plain"]["logprobs"]), impl="cuda",
                                 bucketed=True)
        print(f"[spec-controls] server {name}: {same}/{len(prompts)} requests equal the plain "
              f"server's; {errs_line(errs)}; near-ties {gaps_line(gaps)}; accept_rate "
              f"{r['spec']['stats']['spec_accept_rate']:.4f}; spec {r['spec']['seconds']:.3f}s, "
              f"plain {base['plain']['seconds']:.3f}s")


def main():
    if not torch.cuda.is_available():
        print("spec_controls: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    build.build()
    device = torch.device("cuda")
    cfg = cs.get_config("qwen2-0.5b")
    dcfg = cs.spec_draft(cfg)
    params = cs.make_params(cfg, seed=0, device=device)
    dparams = cs.make_params(dcfg, seed=0, device=device)
    prompts = cs.spec_prompts(cfg, device)
    rollout_readings(cfg, params, dcfg, dparams, prompts, 256, "bf16 24 layers", FAULTS)
    server_readings(cfg, params, dcfg, dparams, ("sound", "late"))
    del params, dparams
    cs.free(device)
    small = cs.shallow(cfg, 2, dtype="float32")
    dsmall = cs.spec_draft(small, 1)
    rollout_readings(small, cs.make_params(small, seed=1, device=device), dsmall,
                     cs.make_params(dsmall, seed=1, device=device), prompts, 64,
                     "fp32 2 layers", ("sound", "late"))
    cs.free(device)
    engine_readings(cfg, dcfg, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
