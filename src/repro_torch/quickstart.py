"""Quickstart: search an execution plan for a PPO experiment and run RLHF
iterations end to end through the runtime engine, the counterpart of the
JAX package's ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.quickstart            # the card
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu

On the card it runs full-width qwen2-0.5b as actor and critic on one H100
(16 prompts of 128 tokens, 256 new, the CUDA kernels); ``--device cpu``
runs the reduced config on the reference tier.  With ``device="cuda"`` and
no card it raises: nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import hw
from repro_torch.configs import get_config
from repro_torch.core.plan import Cluster
from repro_torch.rlhf.experiment import ExperimentConfig, RLHFExperiment
from repro_torch.rlhf.ppo import PPOHyperparameters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--search-iters", type=int, default=100)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("quickstart --device cuda: no CUDA device is available; pass "
                               "--device cpu to run the reduced config on the host")
        actor, chip = get_config("qwen2-0.5b"), hw.H100
        exp_cfg = ExperimentConfig(batch=16, prompt_len=128, gen_len=256, impl="cuda",
                                   search_iters=args.search_iters,
                                   ppo=PPOHyperparameters(n_minibatches=2))
    else:
        actor, chip = get_config("qwen2-0.5b").reduced(), hw.HOST_CPU
        exp_cfg = ExperimentConfig(batch=4, prompt_len=8, gen_len=8, impl="reference",
                                   search_iters=args.search_iters,
                                   ppo=PPOHyperparameters(n_minibatches=2))
    print("searching an execution plan (MCMC over meshes x strategies)...")
    exp = RLHFExperiment(actor, actor, Cluster(n_nodes=1, devs_per_node=1, chip=chip), exp_cfg,
                         device=args.device)
    print(exp.plan)
    for it in range(args.iters):
        t0 = time.perf_counter()
        out = exp.run_iteration(it)
        s = exp.engine.stats()
        print(f"iter {it}: {time.perf_counter() - t0:7.3f}s  "
              f"actor_loss={out['actor_stats']['loss']:+.4e}  "
              f"critic_loss={out['critic_stats']['loss']:.4f}  "
              f"reward_mean={float(out['rewards'].mean()):+.3f}  "
              f"realloc={s['realloc_s']:.3f}s")
    return exp


if __name__ == "__main__":
    main()
