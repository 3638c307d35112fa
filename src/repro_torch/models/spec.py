"""Speculative draft-and-verify rollout over the paged KV cache, the port of
the JAX package's ``models/spec.py``.

A small draft model proposes ``k`` tokens one step at a time; the target
scores all of them (and one bonus position) in one prefill-shaped step
(:func:`model.paged_verify_step`), and batched rejection sampling
(:func:`ops.spec_verify`) keeps the committed tokens distributed exactly as
the target's.  Accepted prefixes keep their KV blocks; a rejection
truncates the row's block list (``BlockAllocator.truncate_to``), and the
stale pool slots are overwritten before anything attends to them.

Cache invariant: a row with committed length ``c`` has valid target KV for
positions ``0 .. c-2``; the last committed token (position ``c-1``) is
consumed, and its KV written, by the next verify step.  The draft keeps
the same invariant over its own statically owned block pool, and each
draft cycle ends with a consume-only catch-up step, so a rejected proposal
needs no rollback on either side: the next cycle's writes land exactly on
the stale positions.

The draft length adapts per cycle: :class:`SpecController` folds measured
accept rates into a per-cycle cost model (``CostModel.spec_cycle_time_fn``
supplies a calibrated one) and picks the ``k`` that minimises the expected
time per committed token.

The JAX package jits each dispatch and ``lax.scan``s the draft steps; here
they are plain functions and Python loops, and the device work of a cycle
is read back to the host once, after the verify.  Randomness comes from
one ``torch.Generator`` per call, so sampled draws differ from the JAX
package's; greedy output does not.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import model as MDL
from repro_torch.models import paged_cache as PC
from repro_torch.models import transformer as T


def spec_supported(cfg: ModelConfig) -> bool:
    """Speculative decoding needs caches that take no rollback: attention
    layers (paged pools, rings) only.  A recurrent mixer (RG-LRU, SSD) would
    need a state snapshot per step to undo a rejected draft."""
    if cfg.family == "encdec" or cfg.prefix_len:
        return False
    return all(s.kind == ATTN for s in cfg.layers)


def check_spec_pair(cfg: ModelConfig, draft_cfg: ModelConfig) -> None:
    """Raise ValueError unless (target, draft) can run draft-and-verify:
    both attention-only decoder models over one vocabulary."""
    for c, role in ((cfg, "target"), (draft_cfg, "draft")):
        if not spec_supported(c):
            raise ValueError(f"speculative decoding is attention-only (decoder-only, "
                             f"prefix-free); {role} config {c.name!r} is not")
    if cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError(f"draft/target vocab mismatch: {draft_cfg.vocab_size} vs "
                         f"{cfg.vocab_size}")


# ------------------------------------------------------------- controller

class SpecController:
    """Adaptive draft length.

    Keeps an EMA of the measured accept rate and picks the ``k`` that
    minimises ``cycle_cost(k) / E[committed | a, k]``, with the truncated
    geometric expectation ``E = (1 - a^(k+1)) / (1 - a)`` of rejection
    sampling.  ``cycle_cost`` maps k to the cost of one draft-and-verify
    cycle (``CostModel.spec_cycle_time_fn(...)`` gives a calibrated one);
    the default is ``(k+1) * draft_cost + 1 + verify_marginal * k``: k+1
    draft steps (the last the consume-only catch-up) and one verify."""

    def __init__(self, *, k_min: int = 1, k_max: int = 8, init_k: int = 4,
                 decay: float = 0.9, init_accept: float = 0.7, cycle_cost=None,
                 draft_cost: float = 0.3, verify_marginal: float = 0.05):
        if not 1 <= k_min <= init_k <= k_max:
            raise ValueError(f"need 1 <= k_min <= init_k <= k_max, got "
                             f"{k_min}/{init_k}/{k_max}")
        self.k_min, self.k_max, self.decay = k_min, k_max, decay
        self.rate = float(init_accept)
        self.cycle_cost = cycle_cost or (
            lambda k: (k + 1) * draft_cost + 1.0 + verify_marginal * k)
        self.k = init_k
        self.history: list[tuple[float, int]] = []

    @staticmethod
    def expected_committed(accept_rate: float, k: int) -> float:
        """E[accepted prefix + 1] for an i.i.d. per-token accept rate."""
        a = min(max(float(accept_rate), 0.0), 0.999999)
        return (1.0 - a ** (k + 1)) / (1.0 - a)

    def _pick(self) -> int:
        return min(range(self.k_min, self.k_max + 1),
                   key=lambda k: self.cycle_cost(k) / self.expected_committed(self.rate, k))

    def update(self, measured_rate: float) -> int:
        """Fold one cycle's measured accept rate in; returns the new k."""
        self.rate = self.decay * self.rate + (1.0 - self.decay) * float(measured_rate)
        self.k = self._pick()
        self.history.append((self.rate, self.k))
        return self.k


# -------------------------------------------------------------- dispatches

def _admit_run(params, cfg: ModelConfig, tokens, caches, slots, table_rows, prompt_len: int,
               *, n_slots: int, impl: str):
    """Prompt admission: dense prefill of ``tokens`` (W, prompt_len), then
    ``paged_insert`` of the rows whose slot is below ``n_slots``.  Returns
    the last position's (W, V) logits."""
    last_h, dense = MDL.prefill(params, cfg, {"tokens": tokens}, prompt_len, impl=impl)
    PC.paged_insert(cfg, caches, dense, slots, table_rows, prompt_len, n_slots=n_slots)
    return MDL.logits_of(params, cfg, last_h[:, None])[:, 0]


def _decode_run(params, cfg: ModelConfig, caches, table, tok, pos, n: int, rng, kw):
    """``n`` fused paged decode-and-sample steps from ``tok`` at ``pos``.
    Returns (last token, tokens (B, n), logprobs (B, n))."""
    toks, lps = [], []
    for _ in range(n):
        tok, lp, _ = MDL.paged_decode_and_sample_step(params, cfg, tok, caches, table, pos,
                                                      rng, **kw)
        pos = pos + 1
        toks.append(tok)
        lps.append(lp)
    return tok, torch.stack(toks, dim=1), torch.stack(lps, dim=1)


def _draft_run(dparams, draft_cfg: ModelConfig, dcaches, d_table, tok, pos, n: int, rng, kw):
    """A draft cycle: ``n`` = k + 1 draft steps from ``tok`` at ``pos``.
    Returns the proposals (B, n) and their full logits (B, n, V); the
    caller drops the last, consume-only step's outputs."""
    toks, lgs = [], []
    for _ in range(n):
        tok, logits, _ = MDL.paged_draft_step(dparams, draft_cfg, tok, dcaches, d_table, pos,
                                              rng, **kw)
        pos = pos + 1
        toks.append(tok)
        lgs.append(logits)
    return torch.stack(toks, dim=1), torch.stack(lgs, dim=1)


def _verify_run(params, cfg: ModelConfig, caches, table, tokens, positions, dtoks, dlgs,
                rng, kw):
    """A verify cycle: one prefill-shaped target step over the spec window,
    batched rejection sampling, then the accepted tokens (the consumed one
    and the accepted draft tokens) written into the window layers' rings.
    Returns (accept_len, token, token_lp, draft_lps)."""
    logits, _ = MDL.paged_verify_step(params, cfg, tokens, caches, table, positions,
                                      impl=kw["impl"])
    out = ops.spec_verify(logits, dtoks, dlgs, rng, **kw)
    T.stack_commit_verify(cfg, caches, out[0] + 1)
    return out


# ----------------------------------------------------------------- rollout

def _draft_table(batch: int, blocks_per_row: int) -> np.ndarray:
    """The draft owns its rows statically: row b gets the contiguous
    physical blocks [1 + b*M, 1 + (b+1)*M) (block 0 stays scratch), so it
    needs no allocator and no truncation: stale positions are masked."""
    return (1 + np.arange(batch)[:, None] * blocks_per_row
            + np.arange(blocks_per_row)[None, :]).astype(np.int32)


def _row_pool(b: int, prompt_len: int, max_len: int, bs: int):
    """An allocator over room for ``b`` rows of ``max_len`` tokens, each row
    holding the blocks of its prompt, and the (b, M) block table.  Returns
    (allocator, per-row block lists, table, blocks per row M, prompt
    blocks)."""
    m = PC.needed_blocks(max_len, bs)
    alloc = PC.BlockAllocator(b * m + PC.RESERVED_BLOCKS, bs)
    nb0 = PC.needed_blocks(prompt_len, bs)
    blocks = [alloc.alloc(nb0) for _ in range(b)]
    table = np.zeros((b, m), np.int32)
    for i, row in enumerate(blocks):
        table[i, :nb0] = row
    return alloc, blocks, table, m, nb0


def _grow(alloc, blocks, table, n_tokens, bs):
    """Grow each row's block list to cover ``n_tokens[i]`` tokens."""
    for i, row in enumerate(blocks):
        need = PC.needed_blocks(int(n_tokens[i]), bs)
        if need > len(row):
            new = alloc.alloc(need - len(row))
            table[i, len(row):need] = new
            row.extend(new)


@torch.no_grad()
def paged_generate(params, cfg: ModelConfig, batch, *, num_new_tokens: int, rng=None,
                   temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                   impl="cuda", block_size: int = 16, step_chunk: int = 1):
    """Non-speculative paged rollout, the baseline the speculative one is
    judged against: one fused decode-and-sample step per token, ``step_chunk``
    steps between host visits (the continuous server's ``sync_every``), with
    host-side block growth; all rows advance in lockstep, so this is
    :func:`model.generate` on the block pool.  ``rng``: a
    ``torch.Generator`` on the batch's device, or None for greedy.  Returns
    {"tokens": (B, T) int32, "logprobs": (B, T) f32, "peak_blocks"}."""
    tokens = batch["tokens"]
    dev = tokens.device
    b, p = tokens.shape
    bs = block_size
    max_len = p + num_new_tokens + step_chunk
    alloc, blocks, table, _, nb0 = _row_pool(b, p, max_len, bs)
    caches = PC.paged_cache_init(cfg, b, alloc.n_blocks, bs, max_len, L.dtype_of(cfg), dev)
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p, impl=impl)
    logits0 = _admit_run(params, cfg, tokens, caches, np.arange(b), table[:, :nb0], p,
                         n_slots=b, impl=impl)
    tok, lp = ops.sample_logits(logits0, rng, **kw)
    toks_out, lps_out = [tok[:, None]], [lp[:, None]]
    g = 1  # tokens committed so far (the admission sample)
    while g < num_new_tokens:
        n = min(step_chunk, num_new_tokens - g)
        _grow(alloc, blocks, table, np.full(b, p + g + n), bs)
        pos = torch.full((b,), p + g - 1, dtype=torch.int32, device=dev)
        tok, toks, lps = _decode_run(params, cfg, caches, torch.from_numpy(table).to(dev),
                                     tok, pos, n, rng, kw)
        toks_out.append(toks)
        lps_out.append(lps)
        g += n
    peak = alloc.peak
    for row in blocks:
        alloc.free(row)
    return {"tokens": torch.cat(toks_out, dim=1), "logprobs": torch.cat(lps_out, dim=1),
            "peak_blocks": peak}


@torch.no_grad()
def spec_generate(params, cfg: ModelConfig, draft_params, draft_cfg: ModelConfig, batch, *,
                  num_new_tokens: int, spec_k: int = 4, rng=None, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0, impl="cuda", block_size: int = 16,
                  controller=None):
    """Draft-and-verify rollout with PPO-exact logprobs.

    Per cycle: the draft proposes ``k`` tokens (k + 1 fused draft steps,
    the last the consume-only catch-up that keeps the draft cache one token
    behind the commit point on every outcome); the target scores all k + 1
    positions in one :func:`model.paged_verify_step`; :func:`ops.spec_verify`
    accepts a prefix and resamples the first rejection from the residual.
    Rows advance independently: their block lists grow before the verify
    and are truncated back to the committed length after it.  A row that
    has all its tokens is frozen: it keeps verifying at its pinned position
    and its outputs are dropped.

    The returned ``logprobs`` are the target's full-distribution logprobs
    of the committed tokens (a teacher-forced forward's, to fp32
    tolerance); with ``rng=None`` the committed tokens are those of greedy
    :func:`model.generate`.  ``stats`` holds the accept rate, the cycles,
    the per-cycle ``k`` (``k_trace``), the accepted and proposed counts and
    the pool's high-water mark.  With ``controller`` (a
    :class:`SpecController`) ``k`` re-adapts every cycle from the measured
    accept rate and ``spec_k`` is ignored."""
    check_spec_pair(cfg, draft_cfg)
    if spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")
    tokens = batch["tokens"]
    dev = tokens.device
    b, p = tokens.shape
    bs = block_size
    k_cap = controller.k_max if controller is not None else spec_k
    # a row can overshoot num_new_tokens by up to k commits before it
    # freezes, and frozen rows keep verifying at their pinned position
    max_len = p + num_new_tokens + 2 * k_cap + 1
    alloc, blocks, table, m, nb0 = _row_pool(b, p, max_len, bs)
    caches = PC.paged_cache_init(cfg, b, alloc.n_blocks, bs, max_len, L.dtype_of(cfg), dev)
    d_table = _draft_table(b, m)
    d_caches = PC.paged_cache_init(draft_cfg, b, alloc.n_blocks, bs, max_len,
                                   L.dtype_of(draft_cfg), dev)
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p, impl=impl)

    logits0 = _admit_run(params, cfg, tokens, caches, np.arange(b), table[:, :nb0], p,
                         n_slots=b, impl=impl)
    tok0, lp0 = ops.sample_logits(logits0, rng, **kw)
    _admit_run(draft_params, draft_cfg, tokens, d_caches, np.arange(b), d_table[:, :nb0], p,
               n_slots=b, impl=impl)
    d_table_dev = torch.from_numpy(d_table).to(dev)

    buf = num_new_tokens + k_cap + 1
    toks_out = np.zeros((b, buf), np.int32)
    lps_out = np.zeros((b, buf), np.float32)
    toks_out[:, 0] = tok0.cpu().numpy()
    lps_out[:, 0] = lp0.cpu().numpy()
    gen = np.ones(b, np.int64)        # committed new tokens per row
    c = np.full(b, p + 1, np.int64)   # committed length (prompt + generated)
    cur_tok = toks_out[:, 0].copy()
    cycles = accepted_total = proposed_total = 0
    k_trace: list[int] = []

    while bool((gen < num_new_tokens).any()):
        k = controller.k if controller is not None else spec_k
        k_trace.append(k)
        # a clean sweep commits k + 1 tokens and the post-commit
        # truncate_to keeps blocks covering c + k + 1: grow to that now
        _grow(alloc, blocks, table, c + k + 1, bs)
        pos0 = torch.from_numpy((c - 1).astype(np.int32)).to(dev)
        cur = torch.from_numpy(cur_tok).to(dev)
        dtoks, dlgs = _draft_run(draft_params, draft_cfg, d_caches, d_table_dev, cur, pos0,
                                 k + 1, rng, kw)
        dtoks, dlgs = dtoks[:, :k], dlgs[:, :k]  # drop the catch-up step
        window = torch.cat([cur[:, None], dtoks], dim=1)
        positions = pos0[:, None] + torch.arange(k + 1, dtype=torch.int32, device=dev)[None]
        acc, ytok, ylp, dlps = _verify_run(params, cfg, caches, torch.from_numpy(table).to(dev),
                                           window, positions, dtoks, dlgs, rng, kw)
        acc, ytok, ylp = acc.cpu().numpy(), ytok.cpu().numpy(), ylp.cpu().numpy()
        dlps, window = dlps.cpu().numpy(), window.cpu().numpy()
        cycles += 1
        cyc_acc = cyc_prop = 0
        for i in range(b):
            if gen[i] >= num_new_tokens:
                continue  # frozen row: state pinned, outputs dropped
            r = int(acc[i])
            cyc_acc += r
            cyc_prop += k
            g = int(gen[i])
            toks_out[i, g:g + r] = window[i, 1:1 + r]
            lps_out[i, g:g + r] = dlps[i, :r]
            toks_out[i, g + r] = ytok[i]
            lps_out[i, g + r] = ylp[i]
            gen[i] += r + 1
            c[i] += r + 1
            cur_tok[i] = ytok[i]
            blocks[i] = alloc.truncate_to(blocks[i], int(c[i]))
            table[i, len(blocks[i]):] = 0
        accepted_total += cyc_acc
        proposed_total += cyc_prop
        if controller is not None and cyc_prop:
            controller.update(cyc_acc / cyc_prop)

    peak = alloc.peak
    for row in blocks:
        alloc.free(row)
    return {
        "tokens": torch.from_numpy(toks_out[:, :num_new_tokens]).to(dev),
        "logprobs": torch.from_numpy(lps_out[:, :num_new_tokens]).to(dev),
        "stats": {"cycles": cycles, "accept_rate": accepted_total / max(proposed_total, 1),
                  "k_trace": k_trace, "peak_blocks": peak, "accepted": int(accepted_total),
                  "proposed": int(proposed_total)},
    }
