"""Where the runtime engine's time over the hand-driven PPO loop goes, on
one card (``chip_smoke.py`` phase 8's experiment: full qwen2-0.5b as actor
and critic, 16 prompts of 128 tokens, 256 new, padded training).

    PYTHONPATH=src python scripts/engine_overhead.py [--rounds 2]

On one set of models it alternates, ``rounds`` times each way round:
  * the actor's generation call (``actor_gen``) on the main thread against
    the same call in a worker thread of a thread pool (where the engine
    runs executors), the device synchronized after each;
  * one PPO iteration driven by hand (the six executors in dataflow order
    on the main thread) against one through ``RuntimeEngine.run_iteration``.
The weights move with every iteration, so the rollouts differ; each pair
times the same work.  Prints every reading, the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke as CS  # noqa: E402


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("engine_overhead: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cfg = CS.get_config("qwen2-0.5b")
    exp = CS.train_experiment(packed=False)
    e = CS.engine_experiment(cfg, exp, torch.device("cuda"), search_iters=50)
    prompts = {"prompts": e.make_prompts(0)}
    gen = e.executors["actor_gen"]
    pool = ThreadPoolExecutor(1)

    def main_thread():
        gen(e.models["actor"], prompts)

    def worker_thread():
        pool.submit(gen, e.models["actor"], prompts).result()

    def by_hand():
        roll = e.executors["actor_gen"](e.models["actor"], prompts)
        for name in ("ref", "critic", "reward"):
            roll |= e.executors[f"{name}_inf"](e.models[name], roll)
        for name in ("actor", "critic"):
            roll |= e.executors[f"{name}_train"](e.models[name], roll)

    def engine():
        e.engine.run_iteration(dict(prompts))

    main_thread()  # warm-up: the first call builds the kernels and the allocator's blocks
    for first, second, label in ((main_thread, worker_thread, "actor_gen main / worker thread"),
                                 (by_hand, engine, "iteration by hand / through the engine")):
        got = {first: [], second: []}
        for r in range(args.rounds):
            order = (first, second) if r % 2 == 0 else (second, first)
            for fn in order + order[::-1]:
                got[fn].append(timed(fn))
        a, b = sorted(got[first]), sorted(got[second])
        print(f"[overhead] {label}: {', '.join(f'{t:.3f}' for t in got[first])} s / "
              f"{', '.join(f'{t:.3f}' for t in got[second])} s; medians "
              f"{a[len(a) // 2]:.3f} / {b[len(b) // 2]:.3f} s")
    recs = e.engine.records[-6:]
    print("[overhead] last engine iteration's calls: "
          + ", ".join(f"{r.name} {r.end - r.start:.4f}s" for r in recs)
          + f"; span {max(r.end for r in recs) - min(r.start for r in recs):.3f}s")
    pool.shutdown()


if __name__ == "__main__":
    main()
