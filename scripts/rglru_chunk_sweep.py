#!/usr/bin/env python3
"""rglru_scan's chunk length and carry handoff on the card.

For each shape of recurrentgemma-9b's scans (W 4096; the continuous
server's 1-2-row admissions of 32-400 tokens, the bucketed server's and
phase 7's wider batches, and a long S), fp32 as the model runs it: the time
of ``csrc/rglru_scan.cu`` (chunks handing on their carries through a
thread-block cluster) at every chunk length in ``rglru_scan.CHUNKS``,
beside the same chunk body with a decoupled look-back in place of the
cluster (``scripts/rglru_lookback.cu``, built here), all from CUDA-graph
replays, with the chunk ``rglru_chunks`` picks from the shapes and the
card's SM count, the bound (a, bx read and h written once) and ``copy_ms``
(one ``torch.mul`` of two (B, S, W) tensors into a third: the bytes of the
scan, as an attainable-bandwidth yardstick).  Every variant is held to the
plain version (1e-5 scaled), two launches of each to the same bits, and the
two handoffs to each other's bits at one chunk length (both compose the
same fmaf chain).

    PYTHONPATH=src python scripts/rglru_chunk_sweep.py

With ``--src DIR`` (another tree's ``src``, e.g. a ``git archive`` of the
parent unpacked under ``build/``) it imports that tree's ``repro_torch``
instead and times its ``rglru_scan`` as it is called on the main path, at
the two headline shapes only (warm and L2-flushed from CUDA-graph replays,
and the eager loop).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (B, S): the headline shapes first (chip_smoke.py's phase 2), then the rest
HEADLINE = ((4, 512), (1, 256))
SHAPES = HEADLINE + ((1, 32), (1, 128), (1, 400), (2, 64), (2, 256), (2, 400), (4, 128),
                     (8, 256), (8, 512), (1, 4096))
W = 4096
ITERS = 50
FP32_TOL = 1e-5
PEAK_BYTES = 3.35e12
FLUSH_BYTES = 64 << 20


def graph_ms(torch, fn, iters=ITERS, flush=None):
    """Mean device time of one call, ``iters`` calls replayed from a CUDA
    graph; with ``flush``, the graph of (flush, call) pairs less that of
    the flushes alone."""
    def replay(calls):
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
    if flush is None:
        return replay(fn) / iters

    def flushed():
        flush.zero_()
        fn()
    return (replay(flushed) - replay(flush.zero_)) / iters


def eager_ms(torch, fn, iters=ITERS):
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


def inputs(torch, g, b, s, device):
    """chip_smoke.py's decays: log a = -8 r softplus(lam), lam <= 2."""
    import math
    a = torch.exp(-8.0 * torch.rand((b, s, W), generator=g, device=device)
                  * math.log1p(math.e ** 2))
    return a, torch.randn((b, s, W), generator=g, device=device)


def bound_ms(b, s):
    return 1e3 * (12 * b * s * W + 4 * b * W) / PEAK_BYTES


def build_lookback(build):
    """The look-back variant's entry points, compiled from this tree."""
    out = ROOT / "build" / "rglru_lookback"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "rglru_lookback.so"
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib),
           str(ROOT / "scripts" / "rglru_lookback.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for rglru_lookback.cu:\n{proc.stdout}{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] rglru_lookback: {line.strip()}")
    dll = ctypes.CDLL(str(lib))
    scan = dll.repro_rglru_lookback
    scan.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    scan.restype = ctypes.c_int
    size = dll.repro_rglru_lookback_scratch
    size.argtypes = [ctypes.c_int] * 4
    size.restype = ctypes.c_longlong
    return scan, size


def baseline(torch, rglru_scan, device):
    """Another tree's kernel as the main path calls it."""
    g = torch.Generator(device=device).manual_seed(0)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    for b, s in HEADLINE:
        a, bx = inputs(torch, g, b, s, device)

        def kernel():
            return rglru_scan.rglru_scan(a, bx)
        print(f"[baseline] B {b} S {s} W {W} fp32: ms={graph_ms(torch, kernel):.4f} (graph, "
              f"warm L2) cold_ms={graph_ms(torch, kernel, flush=flush):.4f} (graph, L2 "
              f"flushed) eager_ms={eager_ms(torch, kernel):.4f} bound_ms={bound_ms(b, s):.4f}")


def sweep(torch, rglru_scan, ref, build, device):
    for line in build.build(("rglru_scan",)).get("rglru_scan", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] rglru_scan: {line.strip()}")
    for dtype in (torch.float32, torch.bfloat16):
        for chunk in rglru_scan.CHUNKS:
            info = rglru_scan.kernel_info(dtype, chunk)
            print(f"[body] {str(dtype)[6:]} chunk {chunk}: {info['registers']} registers, "
                  f"{info['spill_bytes']} spill bytes, {info['smem_bytes']} bytes of shared "
                  f"memory (one stage), {info['blocks_per_sm']} blocks per SM")
    scan_lb, scratch_bytes = build_lookback(build)
    sms = build.sm_count(0)
    g = torch.Generator(device=device).manual_seed(0)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)

    def scaled(got, want):
        return float(((got - want).abs() / (1 + want.abs())).max())

    for b, s in SHAPES:
        a, bx = inputs(torch, g, b, s, device)
        want_h, want_final = ref.rglru_scan_ref(a, bx)
        pick = rglru_scan.rglru_chunks(b, s, W, sms)
        scratch = torch.empty(int(scratch_bytes(b, s, W, min(rglru_scan.CHUNKS))),
                              dtype=torch.uint8, device=device)
        h_lb = torch.empty_like(bx)
        f_lb = torch.empty((b, W), dtype=torch.float32, device=device)
        prod = torch.empty_like(bx)
        rows = []
        for chunk in sorted({min(c, -(-s // 8) * 8) for c in rglru_scan.CHUNKS}):

            def cluster_call(chunk=chunk):
                return rglru_scan.rglru_scan(a, bx, chunk=chunk)

            def lookback_call(chunk=chunk):
                err = scan_lb(a.data_ptr(), bx.data_ptr(), h_lb.data_ptr(), f_lb.data_ptr(),
                              scratch.data_ptr(), b, s, W, 0, chunk,
                              torch.cuda.current_stream(device).cuda_stream)
                if err:
                    raise RuntimeError(f"rglru_lookback failed with CUDA error {err}")
            h1, f1 = cluster_call()
            h2, f2 = cluster_call()
            lookback_call()
            torch.cuda.synchronize()
            errs = (scaled(h1, want_h), scaled(f1, want_final), scaled(h_lb, want_h))
            if max(errs) > FP32_TOL:
                raise SystemExit(f"rglru_chunk_sweep: B {b} S {s} chunk {chunk}: err {errs}")
            if not (torch.equal(h1, h2) and torch.equal(f1, f2)):
                raise SystemExit(f"rglru_chunk_sweep: B {b} S {s} chunk {chunk}: two launches "
                                 "differ")
            if not (torch.equal(h1, h_lb) and torch.equal(f1, f_lb)):
                raise SystemExit(f"rglru_chunk_sweep: B {b} S {s} chunk {chunk}: the handoffs' "
                                 "bits differ")
            cluster, windows = rglru_scan.rglru_grid(s, chunk)
            rows.append((chunk, cluster, windows, graph_ms(torch, cluster_call),
                         graph_ms(torch, lookback_call), max(errs)))
        copy = graph_ms(torch, lambda: torch.mul(a, bx, out=prod))
        best = min(rows, key=lambda r: r[3])
        print(f"B {b} S {s} W {W} fp32, bound {bound_ms(b, s):.4f} ms, copy_ms {copy:.4f}: "
              + "; ".join(f"chunk {c} (cluster {cl}, windows {wn}) {t:.4f} ms, look-back "
                          f"{tl:.4f} ms" for c, cl, wn, t, tl, _ in rows)
              + f"; fastest {best[0]} ({best[3]:.4f} ms), rglru_chunks picks {pick} ({sms} "
              f"SMs); errs <= {max(r[5] for r in rows):.2e}, bits equal")
        if (b, s) in HEADLINE:
            cold = graph_ms(torch, lambda: rglru_scan.rglru_scan(a, bx, chunk=pick), flush=flush)
            copy_cold = graph_ms(torch, lambda: torch.mul(a, bx, out=prod), flush=flush)
            print(f"  picked chunk {pick}: cold_ms={cold:.4f} (graph, L2 flushed) copy "
                  f"cold_ms={copy_cold:.4f}")
        del a, bx, want_h, want_final, scratch, h_lb, prod, rows
        torch.cuda.empty_cache()


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=Path, default=None,
                        help="time another tree's rglru_scan (its src directory)")
    args = parser.parse_args()
    sys.path.insert(0, str((args.src or ROOT / "src").resolve()))
    import torch
    from repro_torch.kernels import build, ref, rglru_scan
    if not torch.cuda.is_available():
        print("rglru_chunk_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    device = torch.device("cuda")
    if args.src is not None:
        baseline(torch, rglru_scan, device)
    else:
        sweep(torch, rglru_scan, ref, build, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
