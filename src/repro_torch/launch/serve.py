"""Serve engines over the model API, and their CLI.

``BatchServer`` groups requests into prompt-length buckets, left-pads each
bucket's prompts with ``pad_id`` and runs one generation per bucket.  As in
the JAX package: pad tokens are attended (no pad mask), every request holds
a full KV buffer for its whole life, and every bucket draws its samples
from the same seed.

``ContinuousBatchServer`` decodes a fixed number of slots per step over a
paged KV cache (``models/paged_cache.py``): a sequence holds only
``ceil(len / block_size)`` blocks, and queued requests are admitted between
steps into slots and blocks that finished requests freed.  Given a draft
model it runs speculative draft-and-verify cycles (``models/spec.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 16 --new 64 --mode continuous [--spec --spec-k 4]
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import model as MDL
from repro_torch.models import paged_cache as PC
from repro_torch.models import spec as SPEC


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

    @torch.no_grad()
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


# --------------------------------------------------------------- continuous

@dataclasses.dataclass
class _Request:
    rid: int
    prompt: np.ndarray  # int32
    max_new: int
    tokens: list = dataclasses.field(default_factory=list)
    logps: list = dataclasses.field(default_factory=list)
    blocks: list = dataclasses.field(default_factory=list)

    def reset(self):  # recompute-style preemption: restart from the prompt
        self.tokens, self.logps, self.blocks = [], [], []


class ContinuousBatchServer:
    """Continuous-batching decode engine over a paged KV cache, as the JAX
    package's class.

    Each decode dispatch runs ``sync_every`` steps over every slot (per-row
    positions, a block table into the shared KV pool, fused sampling) with
    tokens, positions and the table kept on the device; the host reads the
    chunk's tokens and logprobs once, at its end, then retires finished
    rows (their blocks are reused at once) and admits queued requests into
    free slots: one batched prefill, first-token sample and ``paged_insert``
    per same-bucket group.  Rows finishing mid-chunk decode a few throwaway
    tokens into their own about-to-be-freed blocks.  If the pool runs dry
    the youngest active request is preempted (blocks freed, requeued,
    recomputed from its prompt later), so the oldest always makes progress.
    Inactive slots point at the scratch block 0 and ride along.

    Given ``draft_params`` and ``draft_cfg`` the engine is speculative:
    each cycle drafts ``spec_k`` tokens per slot with the small model (``k``
    re-picked per cycle by ``spec_controller``, a ``SpecController``, when
    given) and verifies them in one prefill-shaped target step; rejection
    sampling keeps every returned token and logprob exactly the target's.
    Accepted prefixes keep their blocks, a rejection truncates the row's
    block list.  The draft owns a statically laid out block pool per slot
    and mirrors every admitted prompt into it; preemption only ever touches
    target blocks.  EOS and per-request ``max_new`` drop the overshooting
    suffix of a cycle's commits.

    Sampling takes one ``torch.Generator`` for a whole ``serve`` call (the
    JAX class splits a key per dispatch), so sampled tokens differ from the
    JAX package's; greedy output and the schedule do not.
    """

    def __init__(self, cfg, params, *, n_slots: int = 8,
                 kv_block_size: int = 16, max_kv_blocks: int = 0,
                 max_prompt: int = 128, max_new: int = 128,
                 eos_id=None, temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, impl: str = "cuda", sync_every: int = 4,
                 draft_params=None, draft_cfg=None, spec_k: int = 4,
                 spec_controller=None):
        if cfg.prefix_len and cfg.family != "encdec":
            raise ValueError("ContinuousBatchServer does not support prefix (vlm) configs")
        if (draft_params is None) != (draft_cfg is None):
            raise ValueError("draft_params and draft_cfg go together")
        k_cap = 0
        if draft_cfg is not None:
            SPEC.check_spec_pair(cfg, draft_cfg)
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            k_cap = spec_controller.k_max if spec_controller is not None else spec_k
        self.cfg, self.params = cfg, params
        self.draft_params, self.draft_cfg = draft_params, draft_cfg
        self.spec_k, self.spec_controller = spec_k, spec_controller
        self.n_slots, self.bs = n_slots, kv_block_size
        self.max_new = max_new
        self.eos_id = eos_id
        self.sample_kw = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                              impl=impl)
        self.impl = impl
        self.sync_every = max(1, sync_every)
        self.max_len = bucket_of(max_prompt) + max_new
        self.device = params["embed"]["table"].device
        # a chunk can run a row sync_every - 1 positions past its logical
        # end before the host trims it (a verify cycle k + 1): budget table
        # and pool for that
        self.max_blocks = PC.needed_blocks(
            self.max_len + max(self.sync_every - 1, k_cap + 1), self.bs)
        if max_kv_blocks <= 0:  # worst case: every slot at full length
            max_kv_blocks = PC.RESERVED_BLOCKS + n_slots * self.max_blocks
        self.alloc = PC.BlockAllocator(max_kv_blocks, self.bs)
        self.caches = PC.paged_cache_init(cfg, n_slots, max_kv_blocks, self.bs,
                                          self.max_len, L.dtype_of(cfg), self.device)
        self.table = np.zeros((n_slots, self.max_blocks), np.int32)
        if draft_cfg is not None:
            self.d_table = SPEC._draft_table(n_slots, self.max_blocks)
            self._d_table_dev = torch.from_numpy(self.d_table).to(self.device)
            self.d_caches = PC.paged_cache_init(
                draft_cfg, n_slots, n_slots * self.max_blocks + PC.RESERVED_BLOCKS, self.bs,
                self.max_len, L.dtype_of(draft_cfg), self.device)
        self.seq_lens = np.zeros(n_slots, np.int32)
        self.cur_tok = np.zeros(n_slots, np.int32)
        self.slots: list = [None] * n_slots
        self.queue: collections.deque = collections.deque()
        self._rng = None
        self.steps = 0
        self.preemptions = 0
        self.completion_order: list[int] = []
        self._results: dict = {}
        self._latencies: dict = {}  # rid -> seconds from serve() entry
        self._t_serve0 = None
        self.spec_cycles = self.spec_accepted = self.spec_proposed = 0
        self.spec_k_trace: list[int] = []

    # ----------------------------------------------------------- scheduling
    def _active(self):
        return [i for i, r in enumerate(self.slots) if r is not None]

    def _release(self, slot: int):
        req = self.slots[slot]
        req.blocks = self.alloc.truncate_to(req.blocks, 0)
        self.table[slot, :] = 0
        self.seq_lens[slot] = 0
        self.cur_tok[slot] = 0
        self.slots[slot] = None
        return req

    def _complete(self, slot: int):
        req = self._release(slot)
        self._results[req.rid] = (np.asarray(req.tokens, np.int32),
                                  np.asarray(req.logps, np.float32))
        self.completion_order.append(req.rid)
        if self._t_serve0 is not None:
            self._latencies[req.rid] = time.perf_counter() - self._t_serve0

    def _preempt(self, slot: int):
        """Recompute-style preemption: free the victim's blocks and requeue
        it (it restarts from its prompt), in arrival order so admission
        stays first-come first-served."""
        req = self._release(slot)
        req.reset()
        idx = 0
        while idx < len(self.queue) and self.queue[idx].rid < req.rid:
            idx += 1
        self.queue.insert(idx, req)
        self.preemptions += 1

    def _done(self, req) -> bool:
        return (len(req.tokens) >= req.max_new
                or (self.eos_id is not None and req.tokens[-1] == self.eos_id))

    def _admit(self, toks, slots_arr, table_arr, plen: int):
        """One admission dispatch: batched prefill of ``toks`` (W, plen),
        first-token sample, ``paged_insert`` of the rows whose slot is real;
        a speculative engine mirrors the prompts into the draft's rows.
        Returns (tok0, lp0) on the host."""
        toks = torch.from_numpy(toks).to(self.device)
        logits0 = SPEC._admit_run(self.params, self.cfg, toks, self.caches, slots_arr,
                                  table_arr, plen, n_slots=self.n_slots, impl=self.impl)
        tok0, lp0 = ops.sample_logits(logits0, self._rng, **self.sample_kw)
        if self.draft_cfg is not None:
            keep = slots_arr < self.n_slots
            d_rows = np.zeros_like(table_arr)  # padding rows: scratch, not written
            d_rows[keep] = self.d_table[slots_arr[keep], :table_arr.shape[1]]
            SPEC._admit_run(self.draft_params, self.draft_cfg, toks, self.d_caches,
                            slots_arr, d_rows, plen, n_slots=self.n_slots, impl=self.impl)
        return tok0.cpu().numpy(), lp0.cpu().numpy()

    def _try_admit(self):
        """Admit queued requests into free slots, batching every queued
        request that shares the head's prompt bucket into one ``_admit``
        (first-come first-served within a bucket; the head's bucket goes
        first, so nothing starves).  The batch width is rounded up to a
        power of two, padding rows carrying slot ``n_slots``."""
        while self.queue:
            free = [i for i, r in enumerate(self.slots) if r is None]
            if not free:
                return
            head = self.queue[0]
            pb = bucket_of(len(head.prompt))
            nb = PC.needed_blocks(pb, self.bs)
            batch_reqs, budget = [], self.alloc.free_count
            for req in self.queue:
                if len(batch_reqs) >= len(free) or budget < nb:
                    break
                if bucket_of(len(req.prompt)) != pb:
                    continue
                batch_reqs.append(req)
                budget -= nb
            if not batch_reqs:
                return  # the head does not fit yet: wait for completions
            for req in batch_reqs:
                self.queue.remove(req)
            width = 1
            while width < len(batch_reqs):
                width *= 2
            toks = np.zeros((width, pb), np.int64)  # pad id 0
            slots_arr = np.full((width,), self.n_slots, np.int64)  # not written
            table_arr = np.zeros((width, nb), np.int64)  # scratch block 0
            for row, req in enumerate(batch_reqs):
                req.blocks = self.alloc.alloc(nb)
                toks[row, pb - len(req.prompt):] = req.prompt  # left-pad
                slots_arr[row] = free[row]
                table_arr[row] = req.blocks
            tok0, lp0 = self._admit(toks, slots_arr, table_arr, pb)
            for row, req in enumerate(batch_reqs):
                slot = free[row]
                req.tokens.append(int(tok0[row]))
                req.logps.append(float(lp0[row]))
                self.table[slot, :] = 0
                self.table[slot, :nb] = req.blocks
                self.seq_lens[slot] = pb
                self.cur_tok[slot] = req.tokens[-1]
                self.slots[slot] = req
                if self._done(req):
                    self._complete(slot)

    def _ensure_blocks(self, span=None):
        """Grow each active row's block list to cover the whole coming
        dispatch, ``span`` positions past the current one (default: the
        ``sync_every`` chunk; a verify cycle passes k + 1), preempting the
        youngest request when the pool runs dry.  Rows grow oldest-first
        and never evict an older row: when only older rows remain as
        victims, the growing row preempts itself."""
        if span is None:
            span = self.sync_every - 1
        for slot in sorted(self._active(), key=lambda s: self.slots[s].rid):
            req = self.slots[slot]
            if req is None:  # preempted by an earlier iteration
                continue
            need = (int(self.seq_lens[slot]) + span) // self.bs
            while need >= len(req.blocks):
                if self.alloc.free_count > 0:
                    blk = self.alloc.alloc(1)[0]
                    self.table[slot, len(req.blocks)] = blk
                    req.blocks.append(blk)
                    continue
                victims = [s for s in self._active() if s != slot]
                if not victims:
                    raise MemoryError("KV pool too small for a single request; "
                                      "raise max_kv_blocks")
                victim = max(victims, key=lambda s: self.slots[s].rid)
                if self.slots[victim].rid < req.rid:
                    self._preempt(slot)  # everyone else is older: yield
                    break
                self._preempt(victim)

    def _decode_step(self):
        """One dispatch: ``sync_every`` decode steps for every slot, with
        tokens, positions and the table on the device throughout; the host
        reads the chunk's tokens and logprobs once, then retires rows.  A
        row finishing mid-chunk has its throwaway tail tokens dropped."""
        self._ensure_blocks()
        dev = self.device
        table = torch.from_numpy(self.table).to(dev)
        pos = torch.from_numpy(self.seq_lens).to(dev)
        tok = torch.from_numpy(self.cur_tok).to(dev)
        _, toks, lps = SPEC._decode_run(self.params, self.cfg, self.caches, table, tok, pos,
                                        self.sync_every, self._rng, self.sample_kw)
        toks, lps = toks.cpu().numpy(), lps.cpu().numpy()  # (n_slots, sync_every)
        self.steps += 1
        for slot in self._active():
            self._commit(slot, zip(toks[slot], lps[slot]))

    def _commit(self, slot: int, committed) -> bool:
        """Append (token, logprob) pairs to a slot's request in order until
        it is done; returns whether it completed."""
        req = self.slots[slot]
        for t, lp in committed:
            self.seq_lens[slot] += 1
            req.tokens.append(int(t))
            req.logps.append(float(lp))
            self.cur_tok[slot] = t
            if self._done(req):
                self._complete(slot)
                return True
        return False

    def _spec_step(self):
        """One speculative cycle for every slot: k + 1 draft steps (the last
        the consume-only catch-up), one prefill-shaped target verify over
        the k + 1 positions, batched rejection sampling, then the host
        commits.  Inactive slots ride along against scratch block 0 as in
        ``_decode_step``; their outputs are dropped.  The committed tokens
        are exact target samples, so an EOS or ``max_new`` cut drops a
        suffix."""
        ctl = self.spec_controller
        k = ctl.k if ctl is not None else self.spec_k
        self.spec_k_trace.append(k)
        # the verify writes positions seq_lens .. seq_lens + k, and a clean
        # sweep's truncate_to keeps blocks covering seq_lens + k + 1
        self._ensure_blocks(span=k + 1)
        dev = self.device
        pos0 = torch.from_numpy(self.seq_lens).to(dev)
        cur = torch.from_numpy(self.cur_tok).to(dev)
        dtoks, dlgs = SPEC._draft_run(self.draft_params, self.draft_cfg, self.d_caches,
                                      self._d_table_dev, cur, pos0, k + 1, self._rng,
                                      self.sample_kw)
        dtoks, dlgs = dtoks[:, :k], dlgs[:, :k]  # drop the catch-up step
        window = torch.cat([cur[:, None], dtoks], dim=1)
        positions = pos0[:, None] + torch.arange(k + 1, dtype=torch.int32, device=dev)[None]
        acc, ytok, ylp, dlps = SPEC._verify_run(
            self.params, self.cfg, self.caches, torch.from_numpy(self.table).to(dev), window,
            positions, dtoks, dlgs, self._rng, self.sample_kw)
        acc, ytok, ylp = acc.cpu().numpy(), ytok.cpu().numpy(), ylp.cpu().numpy()
        dlps, window = dlps.cpu().numpy(), window.cpu().numpy()
        self.steps += 1
        self.spec_cycles += 1
        cyc_acc = cyc_prop = 0
        for slot in self._active():
            r = int(acc[slot])
            cyc_acc += r
            cyc_prop += k
            committed = [*zip(window[slot, 1:1 + r], dlps[slot, :r]),
                         (ytok[slot], ylp[slot])]
            if not self._commit(slot, committed):
                # the row lives on: drop the blocks past its committed
                # length (seq_lens counts the prompt bucket and the tokens
                # consumed; the last committed token is the next to consume)
                req = self.slots[slot]
                req.blocks = self.alloc.truncate_to(req.blocks, int(self.seq_lens[slot]) + 1)
                self.table[slot, len(req.blocks):] = 0
        self.spec_accepted += cyc_acc
        self.spec_proposed += cyc_prop
        if ctl is not None and cyc_prop:
            ctl.update(cyc_acc / cyc_prop)

    # -------------------------------------------------------------- serving
    @torch.no_grad()
    def serve(self, prompts, seed=None, max_new=None):
        """prompts: list of 1-D int sequences (ragged).  ``max_new``: int or
        per-request list (default: the server's ``max_new``).  ``seed=None``
        decodes greedily; otherwise the whole call samples from one
        generator seeded with ``seed``.  Returns (tokens_list, logps_list)
        in request order; requests complete out of order
        (``completion_order``)."""
        self._rng = None
        if seed is not None:
            self._rng = torch.Generator(device=self.device).manual_seed(seed)
        n = len(prompts)
        if max_new is None:
            max_new = self.max_new
        per_req = list(max_new) if hasattr(max_new, "__len__") else [max_new] * n
        if len(per_req) != n:
            raise ValueError(f"max_new has {len(per_req)} entries for {n} prompts")
        base = len(self._results)
        reqs = [_Request(rid=base + i, prompt=np.asarray(p, np.int32), max_new=int(m))
                for i, (p, m) in enumerate(zip(prompts, per_req))]
        # validate before any work: a bad request raising mid-flight would
        # lose every in-flight request and leave the queue poisoned
        for r in reqs:
            if r.max_new < 1:
                raise ValueError(f"request {r.rid}: max_new must be >= 1")
            pb = bucket_of(len(r.prompt))
            if pb + r.max_new > self.max_len:
                raise ValueError(f"request {r.rid}: prompt bucket {pb} + max_new "
                                 f"{r.max_new} exceeds max_len {self.max_len}")
        self.queue.extend(reqs)
        # the latency clock restarts per serve() call, so stats() shows the
        # most recent cohort
        self._latencies = {}
        self._t_serve0 = time.perf_counter()
        while self.queue or self._active():
            self._try_admit()
            if self._active():
                if self.draft_cfg is not None:
                    self._spec_step()
                else:
                    self._decode_step()
            elif self.queue:
                raise MemoryError("queued request cannot be admitted into an empty "
                                  "server; raise max_kv_blocks")
        return ([self._results[r.rid][0] for r in reqs],
                [self._results[r.rid][1] for r in reqs])

    def stats(self) -> dict:
        out = {"steps": self.steps, "preemptions": self.preemptions,
               "peak_blocks": self.alloc.peak,
               "completion_order": list(self.completion_order)}
        if self._latencies:
            lats = sorted(self._latencies.values())

            def pct(q):
                return lats[min(len(lats) - 1, int(q * len(lats)))]
            out["latency_s"] = {"p50": pct(0.50), "p99": pct(0.99), "n": len(lats)}
        if self.draft_cfg is not None:
            out.update(spec_cycles=self.spec_cycles, spec_accepted=self.spec_accepted,
                       spec_proposed=self.spec_proposed,
                       spec_accept_rate=self.spec_accepted / max(self.spec_proposed, 1),
                       spec_k_trace=list(self.spec_k_trace))
        return out

    def kv_peak_bytes(self) -> int:
        return PC.kv_pool_bytes(self.cfg, self.alloc.peak, self.bs)


def build_server(cfg, params, exp, *, max_prompt: int = 128, max_new: int = 128,
                 draft_params=None):
    """The serve engine ``exp.serve_mode`` selects ("bucketed" or
    "continuous"), with the sampling and KV settings of ``exp`` (any object
    with the JAX package's ``ExperimentConfig`` attributes).  With
    ``exp.draft_model`` set and ``draft_params`` given, the continuous
    engine is speculative (``exp.spec_k``, adaptive when
    ``exp.spec_adaptive``)."""
    impl = exp.rollout_impl or exp.impl
    if exp.serve_mode == "bucketed":
        return BatchServer(cfg, params, max_new=max_new, eos_id=exp.eos_id,
                           top_k=exp.top_k, top_p=exp.top_p, impl=impl)
    if exp.serve_mode != "continuous":
        raise ValueError(f"serve_mode={exp.serve_mode!r} not in "
                         "('bucketed', 'continuous')")
    sampler = getattr(exp, "sampler", "cdf")
    if sampler != "cdf":
        raise NotImplementedError(f"sampler={sampler!r} is not ported (cdf only)")
    spec_kw = {}
    if draft_params is not None and getattr(exp, "draft_model", None) is not None:
        spec_kw = dict(draft_params=draft_params, draft_cfg=exp.draft_model,
                       spec_k=exp.spec_k,
                       spec_controller=(SPEC.SpecController(init_k=exp.spec_k)
                                        if exp.spec_adaptive else None))
    return ContinuousBatchServer(
        cfg, params, kv_block_size=exp.kv_block_size,
        max_kv_blocks=exp.max_kv_blocks, max_prompt=max_prompt,
        max_new=max_new, eos_id=exp.eos_id, top_k=exp.top_k, top_p=exp.top_p,
        impl=impl, **spec_kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (2 layers, narrow widths)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new", type=int, default=64)
    ap.add_argument("--mode", default="continuous", choices=["bucketed", "continuous"])
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--impl", default="cuda", choices=["cuda", "reference"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spec", action="store_true",
                    help="speculative continuous serving, the target drafting for itself "
                         "(accept rate ~1)")
    ap.add_argument("--spec-k", type=int, default=4)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    params = MDL.init_params(cfg, seed=args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(1, cfg.vocab_size, rng.integers(4, 40))
               for _ in range(args.requests)]
    t0 = time.perf_counter()
    if args.mode == "bucketed":
        out = BatchServer(cfg, params, max_new=args.new, impl=args.impl).serve(
            prompts, seed=args.seed + 1)
        extra = ""
    else:
        spec_kw = {}
        if args.spec:
            spec_kw = dict(draft_params=params, draft_cfg=cfg, spec_k=args.spec_k,
                           spec_controller=SPEC.SpecController(init_k=args.spec_k))
        server = ContinuousBatchServer(cfg, params, n_slots=args.slots,
                                       kv_block_size=args.block_size, max_prompt=64,
                                       max_new=args.new, impl=args.impl, **spec_kw)
        out, _ = server.serve(prompts, seed=args.seed + 1)
        st = server.stats()
        extra = (f", steps={st['steps']} preemptions={st['preemptions']} "
                 f"peak_blocks={st['peak_blocks']} kv_peak={server.kv_peak_bytes()}B")
        if args.spec:
            extra += (f", spec accept_rate={st['spec_accept_rate']:.3f} "
                      f"cycles={st['spec_cycles']} k_trace={st['spec_k_trace']}")
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = sum(len(o) for o in out)
    print(f"served {len(prompts)} ragged requests in {dt:.2f}s ({toks} new "
          f"tokens, {toks / dt:.1f} tokens/s, {cfg.name}, {cfg.num_layers} "
          f"layers, mode={args.mode}, device={args.device}, impl={args.impl}{extra})")
    print("first output:", [int(t) for t in out[0][:8]])


if __name__ == "__main__":
    main()
