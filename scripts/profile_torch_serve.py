#!/usr/bin/env python3
"""Where the time of one serve goes, on a CUDA card.

    PYTHONPATH=src python scripts/profile_torch_serve.py [--engine bucketed|continuous] \
        [--arch qwen2-0.5b|granite-moe-1b-a400m|mamba2-1.3b|recurrentgemma-9b]

``--engine bucketed`` (the default) serves the requests of ``chip_smoke.py``
phase 4 with ``BatchServer`` (``--requests``, ``--new`` tokens each);
``--engine continuous`` serves phase 5's traffic (16 ragged requests, 8-64
new tokens each) with ``ContinuousBatchServer`` (8 slots, blocks of 16).
Full-width ``--arch`` (default qwen2-0.5b), seeded random weights
(``chip_smoke.make_params``: the recurrent mixers' constant leaves drawn at
random), greedy: once to warm up, then once under ``torch.profiler``.  Prints the wall time,
the device's busy time (the union of the intervals of its kernels, copies
and fills) and idle share,
and the device events that took the most time, with their counts.  Fails
without a card, or when the trace holds no device activity.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import BatchServer, ContinuousBatchServer  # noqa: E402


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new", type=int, default=64)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--engine", default="bucketed", choices=["bucketed", "continuous"])
    ap.add_argument("--arch", default="qwen2-0.5b")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    cfg = get_config(args.arch)
    params = chip_smoke.make_params(cfg, seed=0, device="cuda")
    if args.engine == "bucketed":
        prompts = chip_smoke.serve_prompts(cfg, requests=args.requests)
        server = BatchServer(cfg, params, max_new=args.new, impl="cuda")

        def serve():
            server.serve(prompts)
        what = f"{args.new} new tokens"
    else:
        prompts, new = chip_smoke.continuous_traffic(cfg)
        server = ContinuousBatchServer(cfg, params, n_slots=8, kv_block_size=16,
                                       max_prompt=max(map(len, prompts)),
                                       max_new=max(new), impl="cuda")

        def serve():
            server.serve(prompts, max_new=new)
        what = f"{sum(new)} new tokens"
    serve()
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("profile_torch_serve: the trace holds no device activity", file=sys.stderr)
        return 1
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    print(f"[profile] {torch.cuda.get_device_name(0)}; {cfg.name}, {args.engine}, "
          f"{len(prompts)} requests, {what}, greedy")
    print(f"[profile] wall_us={wall_us:.0f} device_busy_us={busy:.0f} "
          f"idle_share={1 - busy / wall_us:.4f} device_events={len(kernels)}")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]:
        print(f"[profile] {us:12.0f} us {100 * us / busy:6.2f}% {n:7d} x  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
