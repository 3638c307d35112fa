"""Model facade: init / forward / prefill / decode / paged decode /
generate, and the length-bucketed generator.

Parameters: {"embed": {"table"}, "layers": [one dict per layer],
"final_norm": {"scale"}} (+ "lm_head" when embeddings are not tied, or
"value_head" for a value model).  A batch is {"tokens": (B, S) int
tensor}, or a packed cohort {"tokens", "cu_seqlens", "positions"}.  Every
entry point runs where the parameters lie and defaults to ``impl="cuda"``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda", head: str = "lm"):
    """Random weights, drawn from one ``torch.Generator`` seeded with
    ``seed``, with the JAX package's initialisers (truncated normal,
    d_in^-0.5 for dense weights, 1.0 for the embedding, zero biases, unit
    norms).  ``head="value"`` (the RLHF critic and reward models) swaps
    the LM head for the fp32 scalar ``value_head``."""
    if head not in ("lm", "value"):
        raise ValueError(f"head={head!r}; need 'lm' or 'value'")
    gen = torch.Generator(device=device).manual_seed(seed)
    p = {
        "embed": L.embed_init(gen, cfg, device),
        "layers": T.stack_init(gen, cfg, device),
        "final_norm": L.rmsnorm_init(cfg.d_model, L.dtype_of(cfg), device),
    }
    if head == "value":
        p["value_head"] = L.dense_init(gen, cfg.d_model, 1, torch.float32, device)
    elif not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                    L.dtype_of(cfg), device)
    return p


def _embed(params, cfg: ModelConfig, tokens):
    return L.embed_apply(params["embed"], tokens).to(L.dtype_of(cfg))


def forward(params, cfg: ModelConfig, batch, *, impl="cuda", remat=False,
            max_seqlen=None, return_aux=False):
    """Full-sequence causal forward.  Returns the final-normed hidden
    states (B, S, D), or with ``return_aux`` (hidden, aux): the MoE
    load-balance loss summed over layers (0 without MoE), the JAX
    package's ``forward``'s second output.

    Packed mode: when ``batch`` has "cu_seqlens", its "tokens" are a (T,)
    packed cohort and "positions" the (T,) within-sequence positions; the
    cohort runs as one (1, T, D) row, attention block-diagonal through
    ``ops.varlen_mha``, and the hidden states are (1, T, D).
    ``max_seqlen`` (the longest sequence) bands the varlen attention's plain
    version.  ``remat`` recomputes each layer in the backward."""
    if "cu_seqlens" in batch:
        x = _embed(params, cfg, batch["tokens"][None])
        out = T.stack_apply(params["layers"], cfg, x, batch["positions"][None], impl=impl,
                            cu_seqlens=batch["cu_seqlens"], max_seqlen=max_seqlen,
                            remat=remat, return_aux=return_aux)
    else:
        x = _embed(params, cfg, batch["tokens"])
        out = T.stack_apply(params["layers"], cfg, x, impl=impl, remat=remat,
                            return_aux=return_aux)
    h, aux = out if return_aux else (out, None)
    h = L.rmsnorm_apply(params["final_norm"], h, cfg.norm_eps)
    return (h, aux) if return_aux else h


def logits_of(params, cfg: ModelConfig, hidden):
    return L.unembed_apply(params.get("lm_head"), params["embed"], hidden,
                           tie=cfg.tie_embeddings)


def values_of(params, hidden):
    """The value head's scalar per position, fp32: (..., D) -> (...)."""
    return L.dense_apply(params["value_head"], hidden.to(torch.float32))[..., 0]


def lm_loss(params, cfg: ModelConfig, batch, *, impl="cuda", remat=True, aux_weight=0.01):
    """Next-token cross-entropy of a {"tokens", "labels", "mask"} batch
    (mean over the mask) plus ``aux_weight`` times the MoE load-balance
    loss, as the JAX package's ``lm_loss``.  Returns (loss, {"lm_loss",
    "aux_loss"}).  The (B, S, V) logits are made whole: the JAX package
    chunks its LM head from 4,096 tokens on, and the port's one caller, the
    profiler, stays below that."""
    hidden, aux = forward(params, cfg, batch, impl=impl, remat=remat, return_aux=True)
    logits = logits_of(params, cfg, hidden)
    mask = batch["mask"]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["labels"][..., None].long())[..., 0]
    loss = ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
    return loss + aux_weight * aux, {"lm_loss": loss, "aux_loss": aux}


def synth_batch(rng, cfg: ModelConfig, seq_len: int, batch: int, kind="train", *,
                device="cuda"):
    """A synthetic batch of random tokens (and, for ``kind="train"``, random
    labels and a unit mask), drawn from ``rng`` (a seed or a
    ``torch.Generator``), as the JAX package's ``synth_batch`` for the
    token-only models the port runs."""
    if cfg.prefix_len or cfg.family == "encdec":
        raise NotImplementedError(f"{cfg.name}: prefix embeddings are not ported")
    gen = rng if isinstance(rng, torch.Generator) else torch.Generator().manual_seed(int(rng))
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq_len), generator=gen)}
    if kind == "train":
        out["labels"] = torch.randint(0, cfg.vocab_size, (batch, seq_len), generator=gen)
        out["mask"] = torch.ones((batch, seq_len), dtype=torch.float32)
    return {k: v.to(device) for k, v in out.items()}


# ----------------------------------------------------------------- serving
# Every serving entry point runs under torch.no_grad(): the trained actor's
# parameters require grad, and the decode kernels have no backward.

@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch, max_len, *, impl="cuda"):
    """Run the prompt, fill caches, return (last_hidden (B, D), caches)."""
    x = _embed(params, cfg, batch["tokens"])
    caches = T.cache_init(cfg, x.shape[0], max_len, L.dtype_of(cfg), x.device)
    h = T.stack_prefill(params["layers"], cfg, x, caches, impl=impl)
    h = L.rmsnorm_apply(params["final_norm"], h, cfg.norm_eps)
    return h[:, -1], caches


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token, caches, t: int, *, impl="cuda"):
    """token: (B,) int; t: the position of this token.
    Returns (logits (B, V) fp32, caches)."""
    x = _embed(params, cfg, token[:, None])
    h = T.stack_decode(params["layers"], cfg, x, caches, t, impl=impl)
    h = L.rmsnorm_apply(params["final_norm"], h, cfg.norm_eps)
    return logits_of(params, cfg, h)[:, 0], caches


@torch.no_grad()
def decode_and_sample_step(params, cfg: ModelConfig, token, caches, t: int,
                           rng=None, *, temperature: float = 1.0,
                           top_k: int = 0, top_p: float = 1.0, impl="cuda"):
    """One decode step on ``token``, then sample the next token and its
    logprob (``ops.sample_logits``).  ``rng=None`` means greedy.
    Returns (next_token (B,), logprob (B,), caches)."""
    logits, caches = decode_step(params, cfg, token, caches, t, impl=impl)
    tok, lp = ops.sample_logits(logits, rng, temperature=temperature,
                                top_k=top_k, top_p=top_p, impl=impl)
    return tok, lp, caches


@torch.no_grad()
def paged_decode_step(params, cfg: ModelConfig, token, caches, block_table,
                      positions, *, impl="cuda"):
    """One decode step over paged caches with per-row positions (the
    continuous-batching step).  token: (B,) the token each row consumes;
    positions: (B,) int32 its position; block_table: (B, M) int32.
    Returns (logits (B, V) fp32, caches)."""
    x = _embed(params, cfg, token[:, None])
    h = T.stack_paged_decode(params["layers"], cfg, x, caches, block_table,
                             positions, impl=impl)
    h = L.rmsnorm_apply(params["final_norm"], h, cfg.norm_eps)
    return logits_of(params, cfg, h)[:, 0], caches


@torch.no_grad()
def paged_decode_and_sample_step(params, cfg: ModelConfig, token, caches,
                                 block_table, positions, rng=None, *,
                                 temperature: float = 1.0, top_k: int = 0,
                                 top_p: float = 1.0, impl="cuda"):
    """``paged_decode_step``, then sample the next token and its logprob
    (``ops.sample_logits``; ``rng=None`` is greedy).  Returns (next_token
    (B,), logprob (B,), caches)."""
    logits, caches = paged_decode_step(params, cfg, token, caches, block_table,
                                       positions, impl=impl)
    tok, lp = ops.sample_logits(logits, rng, temperature=temperature,
                                top_k=top_k, top_p=top_p, impl=impl)
    return tok, lp, caches


@torch.no_grad()
def generate(params, cfg: ModelConfig, batch, *, num_new_tokens: int,
             rng=None, temperature: float = 1.0, impl="cuda",
             eos_id: int | None = None, top_k: int = 0, top_p: float = 1.0):
    """Greedy (``rng=None``) or sampled (``rng`` a ``torch.Generator``)
    generation after a prefill: the JAX package's fused ``generate``.

    Token 0 is sampled from the prefill's last-position logits; decode step
    i consumes token i-1 at position prompt_len + i - 1.  The returned
    caches therefore lack the last sampled token's KV.  Returns a dict with
    tokens (B, T_new) int32, logprobs (B, T_new) f32 and caches.

    With ``eos_id`` set, a row that emits it is forced to ``eos_id`` with
    logprob 0 from then on, the loop stops once every row is done, and the
    result gains ``gen_mask`` ((B, T_new) f32, 1.0 through each row's first
    EOS).
    """
    prompt_len = batch["tokens"].shape[1]
    max_len = prompt_len + num_new_tokens
    last_h, caches = prefill(params, cfg, batch, max_len, impl=impl)
    logits0 = logits_of(params, cfg, last_h[:, None])[:, 0]
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p, impl=impl)
    tok, lp = ops.sample_logits(logits0, rng, **kw)

    if eos_id is None:
        toks, lps = [tok], [lp]
        for i in range(1, num_new_tokens):
            tok, lp, caches = decode_and_sample_step(
                params, cfg, tok, caches, prompt_len + i - 1, rng, **kw)
            toks.append(tok)
            lps.append(lp)
        return {"tokens": torch.stack(toks, dim=1),
                "logprobs": torch.stack(lps, dim=1), "caches": caches}

    b = tok.shape[0]
    toks_buf = torch.full((b, num_new_tokens), eos_id, dtype=torch.int32,
                          device=tok.device)
    lps_buf = torch.zeros((b, num_new_tokens), dtype=torch.float32,
                          device=tok.device)
    toks_buf[:, 0] = tok
    lps_buf[:, 0] = lp
    done = tok == eos_id
    for i in range(1, num_new_tokens):
        if bool(done.all()):  # a host sync per step: the early exit needs it
            break
        ntok, lp, caches = decode_and_sample_step(
            params, cfg, tok, caches, prompt_len + i - 1, rng, **kw)
        ntok = torch.where(done, eos_id, ntok)
        lp = torch.where(done, 0.0, lp)
        toks_buf[:, i] = ntok
        lps_buf[:, i] = lp
        done = done | (ntok == eos_id)
        tok = ntok
    is_eos = (toks_buf == eos_id).to(torch.int32)
    after_eos = (torch.cumsum(is_eos, dim=1) - is_eos) > 0
    return {"tokens": toks_buf, "logprobs": lps_buf, "caches": caches,
            "gen_mask": 1.0 - after_eos.to(torch.float32)}


# ----------------------------------------------------------- buckets

GEN_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)


def bucket_len(n: int, buckets=GEN_BUCKETS) -> int:
    """Smallest bucket >= n; lengths beyond the largest bucket stay exact."""
    for b in buckets:
        if n <= b:
            return b
    return n


class BucketedGenerator:
    """Length-bucketed :func:`generate`, as the JAX package's class: prompts
    are left-padded with ``pad_id`` to the next prompt-length bucket (left,
    so the last prompt token stays adjacent to generation; pad tokens are
    attended, there is no pad mask), ``num_new_tokens`` is rounded up to
    its bucket, and outputs are trimmed back to the requested length.  The
    JAX class keys a jit cache on the bucket; the port runs eagerly, so the
    buckets only fix the shapes each call sees."""

    def __init__(self, cfg: ModelConfig, *, temperature: float = 1.0,
                 impl: str = "cuda", eos_id: int | None = None,
                 pad_id: int = 0, top_k: int = 0, top_p: float = 1.0,
                 buckets=GEN_BUCKETS):
        self.cfg, self.temperature, self.impl = cfg, temperature, impl
        self.eos_id, self.pad_id = eos_id, pad_id
        self.top_k, self.top_p = top_k, top_p
        self.buckets = buckets

    @torch.no_grad()
    def __call__(self, params, batch, *, num_new_tokens: int, rng=None):
        toks = batch["tokens"]
        plen = toks.shape[1]
        pb = bucket_len(plen, self.buckets)
        gb = bucket_len(num_new_tokens, self.buckets)
        if pb != plen:
            pad = torch.full((toks.shape[0], pb - plen), self.pad_id,
                             dtype=toks.dtype, device=toks.device)
            batch = dict(batch, tokens=torch.cat([pad, toks], dim=1))
        out = generate(params, self.cfg, batch, num_new_tokens=gb, rng=rng,
                       temperature=self.temperature, impl=self.impl,
                       eos_id=self.eos_id, top_k=self.top_k, top_p=self.top_p)
        return {k: (v[:, :num_new_tokens]
                    if k in ("tokens", "logprobs", "gen_mask") else v)
                for k, v in out.items()}
