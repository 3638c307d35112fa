"""DPO training (paper §8.3, ReaL beyond PPO), the counterpart of the JAX
package's ``examples/dpo_train.py``: two function calls a step, reference
inference over synthetic (chosen, rejected) pairs, then one policy train
step.

    PYTHONPATH=src python -m repro_torch.dpo_train --steps 50     # the card
    PYTHONPATH=src python -m repro_torch.dpo_train --device cpu --steps 3

The model is reduced qwen2-0.5b; the reference is a frozen copy of the
policy's initial weights, so step 0's loss is ln 2.  On the card the
kernels run (``impl="cuda"``); ``--device cpu`` runs the reference tier.
With the default device and no card it raises.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.synth import PreferenceDataset
from repro_torch.models import model as MDL
from repro_torch.optim import adamw
from repro_torch.rlhf.dpo import DPOHyperparameters, make_dpo_train_step, seq_logp_sum


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dpo_train --device cuda: no CUDA device is available; pass "
                           "--device cpu to run on the host")
    impl = "cuda" if args.device == "cuda" else "reference"

    cfg = get_config("qwen2-0.5b").reduced()
    hp = DPOHyperparameters(beta=0.1)
    opt_cfg = adamw.AdamWConfig(lr=5e-4)
    gen_start = args.seq // 2
    policy = MDL.init_params(cfg, seed=0, device=args.device)
    ref = MDL.init_params(cfg, seed=0, device=args.device)  # frozen reference = same init
    opt = adamw.init(opt_cfg, policy)
    step_fn = make_dpo_train_step(cfg, hp, opt_cfg, gen_start, impl=impl)
    ds = PreferenceDataset(cfg.vocab_size, args.seq, args.batch, device=args.device)

    losses = []
    for step in range(args.steps):
        t0 = time.perf_counter()
        batch = ds.batch_at(step)
        with torch.no_grad():
            for side in ("chosen", "rejected"):
                batch[f"ref_{side}_logp"] = seq_logp_sum(ref, cfg, batch[side],
                                                         batch[f"{side}_mask"], gen_start,
                                                         impl=impl, remat=False)
        policy, opt, stats = step_fn(policy, opt, batch)
        losses.append(float(stats["loss"]))
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:3d}  {time.perf_counter() - t0:5.2f}s  "
                  f"loss={losses[-1]:.4f}  acc={float(stats['dpo_acc']):.2f}  "
                  f"margin={float(stats['margin']):+.3f}", flush=True)
    print("done")
    return losses


if __name__ == "__main__":
    main()
