"""Cluster launcher: search an execution plan and run RLHF training, the
counterpart of the JAX package's ``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 5                                  # the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --smoke --device cpu --impl reference --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --plan-only \\
        --arch llama-7b --nodes 2 --devs-per-node 8 --h100

``--plan-only`` builds the PPO dataflow graph, the cost model and the MCMC
search and prints the plan without building any model (so it plans
llama-70b on a laptop); the search is the experiment's, called the same
way.  Without it the launcher builds ``RLHFExperiment`` on ``--device``
("cuda" by default) and runs ``--steps`` iterations through the runtime.
"""

from __future__ import annotations

import argparse
import time

from repro_torch import hw
from repro_torch.configs import ARCHS
from repro_torch.core import dfg as DFG
from repro_torch.core.estimator import CostModel
from repro_torch.core.plan import Cluster
from repro_torch.core.search import mcmc_search


def search_plan(cfg, cluster: Cluster, *, batch: int, prompt_len: int, gen_len: int,
                n_minibatches: int, search_iters: int, seed: int = 0, pipeline_depth: int = 1):
    """The plan ``RLHFExperiment`` searches for ``cfg`` as actor and critic
    (``build_ppo`` + ``CostModel`` + ``mcmc_search``), with no model
    built."""
    graph = DFG.build_ppo(cfg, cfg, batch=batch, prompt_len=prompt_len, gen_len=gen_len,
                          n_minibatches=n_minibatches)
    return mcmc_search(graph, cluster, CostModel(cluster), iters=search_iters, seed=seed,
                       pipeline_iters=max(pipeline_depth, 1)).best_plan


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=sorted(ARCHS))
    ap.add_argument("--algo", default="ppo", choices=["ppo"])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen-len", type=int, default=8)
    ap.add_argument("--nodes", type=int, default=1)
    ap.add_argument("--devs-per-node", type=int, default=1)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--h100", action="store_true",
                    help="cost-model the paper's H100 cluster")
    ap.add_argument("--plan-only", action="store_true",
                    help="search + print the plan, build no model, do not execute")
    ap.add_argument("--search-iters", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--impl", default="cuda", choices=("cuda", "reference"))
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = cfg.reduced()
    kw = {}
    if args.h100:
        kw = dict(chip=hw.H100, intra_node_bw=450e9, inter_node_bw=50e9)
    cluster = Cluster(n_nodes=args.nodes, devs_per_node=args.devs_per_node, **kw)
    n_minibatches = min(2, args.batch)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"cluster={args.nodes}x{args.devs_per_node}")
    if args.plan_only:
        plan = search_plan(cfg, cluster, batch=args.batch, prompt_len=args.prompt_len,
                           gen_len=args.gen_len, n_minibatches=n_minibatches,
                           search_iters=args.search_iters, seed=args.seed)
        print(plan)
        return plan

    from repro_torch.rlhf.experiment import ExperimentConfig, RLHFExperiment
    from repro_torch.rlhf.ppo import PPOHyperparameters
    exp_cfg = ExperimentConfig(batch=args.batch, prompt_len=args.prompt_len,
                               gen_len=args.gen_len, search_iters=args.search_iters,
                               seed=args.seed, impl=args.impl,
                               ppo=PPOHyperparameters(n_minibatches=n_minibatches))
    run = RLHFExperiment(cfg, cfg, cluster, exp_cfg, device=args.device)
    print(run.plan)
    mgr = None
    if args.ckpt:
        from repro_torch.checkpoint.manager import CheckpointManager
        mgr = CheckpointManager(args.ckpt)
    for step in range(args.steps):
        t0 = time.time()
        out = run.run_iteration(step)
        print(f"step {step}: {time.time()-t0:.1f}s "
              f"actor_loss={out['actor_stats']['loss']:+.4f} "
              f"reward={float(out['rewards'].mean()):+.3f}", flush=True)
        if mgr and (step + 1) % 5 == 0:
            mgr.save_async(step + 1, {"actor": run.models["actor"].params,
                                      "critic": run.models["critic"].params})
    if mgr:
        mgr.wait()
    print("done")
    return run


if __name__ == "__main__":
    main()
