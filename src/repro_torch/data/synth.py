"""Synthetic RLHF data, as the JAX package's ``data/synth.py`` (the paper's
evaluation protocol, Appendix A): random prompts at the maximum prompt
length, generation always to max length, so workloads are shape-stable and
comparable across systems.

Also a deterministic token stream for LM training, synthetic preference
pairs for DPO, and a host prefetch thread.  Every dataset draws from the
same ``np.random.default_rng`` streams as the JAX package, so both give the
same arrays at the same (seed, step); the port's come as torch tensors on
``device``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.data import packing


class PromptDataset:
    """Deterministic, seekable synthetic prompts: resuming from a
    checkpoint at step k reproduces the same stream."""

    def __init__(self, vocab_size: int, prompt_len: int, batch: int, seed: int = 0,
                 pad_id: int = 0, min_len: Optional[int] = None, device="cuda"):
        self.vocab, self.plen, self.batch = vocab_size, prompt_len, batch
        self.seed, self.pad_id, self.device = seed, pad_id, device
        self.min_len = min_len or prompt_len

    def _draw(self, step: int):
        rng = np.random.default_rng((self.seed, step))
        toks = rng.integers(1, self.vocab, (self.batch, self.plen), dtype=np.int32)
        lens = rng.integers(self.min_len, self.plen + 1, (self.batch,))
        return toks, lens

    def batch_at(self, step: int) -> dict:
        """{"tokens": (B, P) int32 right-padded with ``pad_id``,
        "prompt_mask": (B, P) fp32}."""
        toks, lens = self._draw(step)
        mask = np.arange(self.plen)[None, :] < lens[:, None]
        toks = np.where(mask, toks, self.pad_id).astype(np.int32)
        return {"tokens": torch.from_numpy(toks).to(self.device),
                "prompt_mask": torch.from_numpy(mask.astype(np.float32)).to(self.device)}

    def packed_batch_at(self, step: int) -> packing.PackedBatch:
        """The batch of :meth:`batch_at` in the packed (total_tokens,)
        ``cu_seqlens`` layout: each row's valid prefix, no pad tokens."""
        toks, lens = self._draw(step)
        return packing.pack_batch(torch.from_numpy(toks).to(self.device), lens)

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PreferenceDataset:
    """Synthetic (chosen, rejected) pairs for DPO: (B, S) int32 each, masks
    of ones."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int, seed: int = 0,
                 device="cuda"):
        self.vocab, self.slen, self.batch = vocab_size, seq_len, batch
        self.seed, self.device = seed, device

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, 7, step))

        def draw():
            return torch.from_numpy(rng.integers(1, self.vocab, (self.batch, self.slen),
                                                 dtype=np.int32)).to(self.device)
        chosen = draw()
        mask = torch.ones((self.batch, self.slen), dtype=torch.float32, device=self.device)
        return {"chosen": chosen, "rejected": draw(), "chosen_mask": mask,
                "rejected_mask": mask}


class LMDataset:
    """Next-token-prediction batches: tokens, labels (the tokens shifted by
    one), mask of ones."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int, seed: int = 0,
                 device="cuda"):
        self.vocab, self.slen, self.batch = vocab_size, seq_len, batch
        self.seed, self.device = seed, device

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, 13, step))
        toks = torch.from_numpy(rng.integers(0, self.vocab, (self.batch, self.slen + 1),
                                             dtype=np.int32)).to(self.device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                "mask": torch.ones((self.batch, self.slen), dtype=torch.float32,
                                   device=self.device)}


class Prefetcher:
    """A host thread that prepares the next ``depth`` batches while the
    device computes."""

    def __init__(self, dataset, start_step: int = 0, depth: int = 2):
        self.ds = dataset
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._t = threading.Thread(target=self._work, daemon=True)
        self._t.start()

    def _work(self):
        step = self._step
        batch = None
        while not self._stop.is_set():
            if batch is None:
                batch = self.ds.batch_at(step)
            try:
                self.q.put(batch, timeout=0.1)
            except queue.Full:
                continue
            batch = None
            step += 1

    def next(self) -> dict:
        return self.q.get()

    def close(self):
        self._stop.set()
        self._t.join(timeout=2)
