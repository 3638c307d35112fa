#!/usr/bin/env python3
"""ssd_scan's bf16 body over its P splits on the card: for each of
mamba2-1.3b's admission shapes (B rows of S tokens, H 64, P 64, N 128), the
time of the tensor-core body at every p_splits in ``ssd_scan.P_SPLITS``,
from CUDA-graph replays, beside the split ``ssd_splits`` picks from the
shapes and the card's SM count.  Every split gives the same bits (checked
here too), so the choice is one of time alone.

    PYTHONPATH=src python scripts/ssd_splits_sweep.py
"""

from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build, ssd_scan  # noqa: E402

H, P, N, CHUNK = 64, 64, 128, 128
BATCHES = (1, 2, 4, 8)
LENGTHS = (128, 256, 512)
ITERS = 50


def inputs(g, b, s, device):
    """chip_smoke.py's SSD distributions: dt log-uniform in [1e-3, 1e-1],
    A in [-16, -1], D in [0.5, 1.5]."""
    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)
    dt = torch.exp(torch.rand((b, s, H), generator=g, device=device) * math.log(100.0)
                   + math.log(1e-3))
    a_log = torch.rand((H,), generator=g, device=device) * math.log(16.0)
    return (randn(b, s, H, P).bfloat16(), dt, a_log, randn(b, s, N).bfloat16(),
            randn(b, s, N).bfloat16(), torch.rand((H,), generator=g, device=device) + 0.5)


def graph_ms(fn, iters=ITERS):
    """Mean device time of one call, ``iters`` calls replayed from a CUDA graph."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main():
    if not torch.cuda.is_available():
        print("ssd_splits_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    device = torch.device("cuda")
    sms = build.sm_count(0)
    g = torch.Generator(device=device).manual_seed(0)
    for b in BATCHES:
        for s in LENGTHS:
            args = inputs(g, b, s, device)
            outs, times = {}, {}
            for ps in ssd_scan.P_SPLITS:
                outs[ps] = ssd_scan.ssd_scan(*args, chunk=CHUNK, return_state=True,
                                             p_splits=ps)
                times[ps] = graph_ms(lambda: ssd_scan.ssd_scan(*args, chunk=CHUNK,
                                                               return_state=True, p_splits=ps))
            torch.cuda.synchronize()
            same = all(torch.equal(outs[ps][i], outs[1][i]) for ps in outs for i in (0, 1))
            if not same:
                raise SystemExit(f"ssd_splits_sweep: B {b} S {s}: the splits' bits differ")
            best = min(times, key=times.get)
            pick = ssd_scan.ssd_splits(b, H, sms)
            print(f"B {b} S {s}: " + " ".join(f"p_splits {ps} {t:.4f} ms"
                                             for ps, t in times.items())
                  + f"; fastest {best}, ssd_splits picks {pick} ({sms} SMs); bits equal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
