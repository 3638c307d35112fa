#!/usr/bin/env python3
"""grouped_ffn's bf16 tiling on the card: the time of each launch of the
wgmma body at granite-moe-1b-a400m's widths, and the kernel rebuilt with
other block widths and ring depths.

``csrc/grouped_expert.cu`` fixes three constants: ``kSlabsA`` and
``kSlabsB`` (64-column slabs of F and D a launch-A or launch-B block
computes) and ``kStages`` (k-chunks in the cp.async ring).  This script
compiles one copy of the source per (kSlabsA, kSlabsB, kStages) in
VARIANTS into ``build/grouped_tiling/`` (one nvcc each, started together),
holds each against the plain version (GROUPED_TOL), and times each from
CUDA-graph replays on rows routed top-8 by a random router over N = 8 *
tokens; then a torch.profiler pass over the built library at N 8192 gives
the device time of launch A (H) and launch B (the output) apart.  Every
variant computes the same bits: the instruction (m64n64k16) and the
k-chunk order do not depend on them.

    PYTHONPATH=src python scripts/grouped_tiling.py
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build, grouped_expert, ref  # noqa: E402

# (kSlabsA, kSlabsB, kStages); the first is the source as committed
VARIANTS = ((1, 2, 3), (2, 2, 3), (1, 4, 3), (2, 4, 3), (2, 4, 2), (1, 2, 2), (1, 2, 4))
TOKENS = (8, 64, 256, 1024)  # N = 8 tokens: 64 .. 8192 rows
E, D, F, TOP_K = 32, 1024, 512, 8
GROUPED_TOL = 1e-4
OUT = ROOT / "build" / "grouped_tiling"


def variant_source(slabs_a: int, slabs_b: int, stages: int) -> str:
    src = (build.CSRC / "grouped_expert.cu").read_text()
    for name, value in (("kSlabsA", slabs_a), ("kSlabsB", slabs_b), ("kStages", stages)):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"grouped_expert.cu: no single {name} to set")
    return src


def build_variants():
    """{variant: the loaded entry point}; the variants compile together."""
    shutil.rmtree(OUT, ignore_errors=True)
    procs = {}
    for v in VARIANTS:
        d = OUT / "v{}{}{}".format(*v)
        shutil.copytree(build.CSRC, d)
        (d / "grouped_expert.cu").write_text(variant_source(*v))
        lib = d / "grouped_expert.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(d / "grouped_expert.cu")]
        procs[v] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), lib)
    entries = {}
    for v, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {v}:\n{log[-4000:]}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"variant (kSlabsA, kSlabsB, kStages) = {v}: registers per kernel {regs}, "
              f"spill bytes {spills}")
        fn = ctypes.CDLL(str(lib)).repro_grouped_ffn
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[v] = fn
    return entries


def graph_ms(fn, iters=50):
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
        print("grouped_tiling: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    entries = build_variants()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    ws = tuple((torch.randn(shape, generator=g, device=dev) * shape[1] ** -0.5).bfloat16()
               for shape in ((E, D, F), (E, D, F), (E, F, D)))
    router = torch.randn((D, E), generator=g, device=dev) * D ** -0.5
    x = torch.randn((max(TOKENS), D), generator=g, device=dev).bfloat16()

    def routed(t):
        top = torch.topk(x[:t].float() @ router, TOP_K, dim=-1).indices.reshape(-1)
        order = torch.sort(top, stable=True).indices
        return x[order // TOP_K].contiguous(), torch.bincount(top, minlength=E).int()

    def call(fn, xs, gs):
        n = xs.shape[0]
        out = torch.empty((n, D), dtype=torch.float32, device=dev)
        h = torch.empty((2, n, F), dtype=torch.bfloat16, device=dev)
        err = fn(xs.data_ptr(), gs.data_ptr(), *(w.data_ptr() for w in ws), h.data_ptr(),
                 out.data_ptr(), n, D, F, E, 1, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"grouped_ffn variant launch failed with CUDA error {err}")
        return out

    cases = {t: routed(t) for t in TOKENS}
    wants = {t: ref.grouped_ffn_ref(xs, gs, *ws) for t, (xs, gs) in cases.items()}
    for rep in range(2):  # the whole table twice, to show its spread
        for v, fn in entries.items():
            row = []
            for t, (xs, gs) in cases.items():
                got = call(fn, xs, gs)
                torch.cuda.synchronize()
                err = ((got - wants[t]).abs() / (1 + wants[t].abs())).max().item()
                if err > GROUPED_TOL:
                    raise SystemExit(f"variant {v} N {xs.shape[0]}: err {err} > {GROUPED_TOL}")
                row.append(f"N {xs.shape[0]} {graph_ms(lambda: call(fn, xs, gs)):.4f} ms")
            print(f"pass {rep} variant {v}: " + ", ".join(row))

    xs, gs = cases[max(TOKENS)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            grouped_expert.grouped_ffn(xs, gs, *ws)
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        if "wgmma_gemm_kernel" in evt.key:
            launch = "A (H)" if "<1, 2," in evt.key else "B (out)"
            print(f"N {xs.shape[0]} launch {launch}: {evt.count} calls, device time "
                  f"{evt.device_time:.1f} us each")
    return 0


if __name__ == "__main__":
    sys.exit(main())
