"""Bucketed batch server over :func:`models.model.generate`, and its CLI.

``BatchServer`` groups requests into prompt-length buckets, left-pads each
bucket's prompts with ``pad_id`` and runs one generation per bucket.  As in
the JAX package: pad tokens are attended (no pad mask), every request holds
a full KV buffer for its whole life, and every bucket draws its samples
from the same seed.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 8 --new 64
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.models import model as MDL


def bucket_of(length: int, buckets=(16, 32, 64, 128, 256, 512, 1024)) -> int:
    return MDL.bucket_len(length, buckets)


class BatchServer:
    """Minimal bucketed batch server over the model API."""

    def __init__(self, cfg, params, max_new: int, pad_id: int = 0,
                 eos_id=None, temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, impl: str = "cuda"):
        self.cfg, self.params, self.max_new = cfg, params, max_new
        self.pad_id, self.impl = pad_id, impl
        self.gen_kw = dict(temperature=temperature, eos_id=eos_id,
                           top_k=top_k, top_p=top_p)
        self.device = params["embed"]["table"].device

    def serve(self, prompts, seed=None):
        """prompts: list of 1-D int sequences (ragged).  ``seed=None``
        decodes greedily; otherwise every bucket samples from a generator
        seeded with ``seed``.  Returns the generated-token tensors, in
        request order."""
        by_bucket: dict[int, list[int]] = {}
        for i, pr in enumerate(prompts):
            by_bucket.setdefault(bucket_of(len(pr)), []).append(i)
        results = [None] * len(prompts)
        for bucket, idxs in sorted(by_bucket.items()):
            toks = torch.full((len(idxs), bucket), self.pad_id, dtype=torch.int64)
            for row, i in enumerate(idxs):
                pr = torch.as_tensor(prompts[i], dtype=torch.int64)
                toks[row, bucket - len(pr):] = pr  # left-pad
            rng = None
            if seed is not None:
                rng = torch.Generator(device=self.device).manual_seed(seed)
            out = MDL.generate(self.params, self.cfg,
                               {"tokens": toks.to(self.device)},
                               num_new_tokens=self.max_new, rng=rng,
                               impl=self.impl, **self.gen_kw)
            for row, i in enumerate(idxs):
                results[i] = out["tokens"][row]
        return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (2 layers, narrow widths)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--impl", default="cuda", choices=["cuda", "reference"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.configs import get_config

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    params = MDL.init_params(cfg, seed=args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(1, cfg.vocab_size, rng.integers(4, 40))
               for _ in range(args.requests)]
    server = BatchServer(cfg, params, max_new=args.new, impl=args.impl)
    t0 = time.perf_counter()
    out = server.serve(prompts, seed=args.seed + 1)
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = sum(len(o) for o in out)
    print(f"served {len(prompts)} ragged requests in {dt:.2f}s ({toks} new "
          f"tokens, {toks / dt:.1f} tokens/s, {cfg.name}, {cfg.num_layers} "
          f"layers, device={args.device}, impl={args.impl})")
    print("first output:", out[0][:8].tolist())


if __name__ == "__main__":
    main()
