"""Model facade: init / forward / prefill / decode / paged decode /
speculative draft and verify steps / generate, and the length-bucketed
generator.

Parameters: {"embed": {"table"}, "layers": [one dict per layer],
"final_norm": {"scale"}} (+ "lm_head" when embeddings are not tied, or
"value_head" for a value model; + "encoder": {"layers", "final_norm"} for
an encoder-decoder).  A batch is {"tokens": (B, S) int tensor}, or a
packed cohort {"tokens", "cu_seqlens", "positions"}.  An encoder-decoder
([audio]) batch adds "frames" (B, prefix_len, D), the encoder's input; a
prefix ([vlm]) batch adds "prefix_embeds" (B, prefix_len, D), spliced over
token positions [0:prefix_len] (the tokens there are ignored).  Every
entry point runs where the parameters lie and defaults to ``impl="cuda"``.
The ``*_sharded`` entry points at the end run over a mesh of logical
devices (``parallel/steps.py``).
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
    the LM head for the fp32 scalar ``value_head``.  On ``device="meta"``
    it returns the shape tree and draws nothing (the dry run's params)."""
    if head not in ("lm", "value"):
        raise ValueError(f"head={head!r}; need 'lm' or 'value'")
    gen = (None if torch.device(device).type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    encdec = cfg.family == "encdec"
    p = {
        "embed": L.embed_init(gen, cfg, device),
        "layers": T.stack_init(gen, cfg, device, cross=encdec),
        "final_norm": L.rmsnorm_init(cfg.d_model, L.dtype_of(cfg), device),
    }
    if head == "value":
        p["value_head"] = L.dense_init(gen, cfg.d_model, 1, torch.float32, device)
    elif not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                    L.dtype_of(cfg), device)
    if encdec:
        # the JAX package builds the encoder from the decoder's layer
        # pattern, so its depth is num_layers (enc_layers feeds the count)
        p["encoder"] = {"layers": T.stack_init(gen, cfg, device),
                        "final_norm": L.rmsnorm_init(cfg.d_model, L.dtype_of(cfg), device)}
    return p


def _embed(params, cfg: ModelConfig, tokens):
    return L.embed_apply(params["embed"], tokens).to(L.dtype_of(cfg))


def _input(batch, name: str, cfg: ModelConfig):
    if name not in batch:
        raise ValueError(f"{cfg.name}: the batch needs {name!r} (B, {cfg.prefix_len}, "
                         f"{cfg.d_model}) beside its tokens")
    return batch[name].to(L.dtype_of(cfg))


def _encode(params, cfg: ModelConfig, batch, *, impl, remat=False):
    """The encoder output (B, prefix_len, D) of ``batch["frames"]``:
    bidirectional self-attention at positions arange, then the encoder's
    final norm; None for a decoder-only model."""
    if cfg.family != "encdec":
        return None
    h = T.stack_apply(params["encoder"]["layers"], cfg, _input(batch, "frames", cfg),
                      causal=False, impl=impl, remat=remat)
    return L.rmsnorm_apply(params["encoder"]["final_norm"], h, cfg.norm_eps)


def _splice_prefix(cfg: ModelConfig, x, batch):
    """Token embeddings x with a prefix model's ``prefix_embeds`` over
    positions [0:prefix_len] (x itself for any other model).  Fewer tokens
    than ``prefix_len`` raise (the JAX package's splice would return a
    sequence of prefix_len)."""
    if not cfg.prefix_len or cfg.family == "encdec":
        return x
    if x.shape[1] < cfg.prefix_len:
        raise ValueError(f"{cfg.name}: {x.shape[1]} tokens, fewer than the prefix of "
                         f"{cfg.prefix_len} embeddings they start with")
    return torch.cat([_input(batch, "prefix_embeds", cfg), x[:, cfg.prefix_len:]], dim=1)


def _embed_inputs(params, cfg: ModelConfig, batch):
    """The token embeddings, with a prefix model's prefix spliced in."""
    return _splice_prefix(cfg, _embed(params, cfg, batch["tokens"]), batch)


def forward(params, cfg: ModelConfig, batch, *, impl="cuda", remat=False,
            max_seqlen=None, return_aux=False):
    """Full-sequence causal forward (after the encoder, for an
    encoder-decoder).  Returns the final-normed hidden states (B, S, D), or
    with ``return_aux`` (hidden, aux): the MoE load-balance loss summed over
    the decoder's layers (0 without MoE), the JAX package's ``forward``'s
    second output.

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
        x = _embed_inputs(params, cfg, batch)
        enc_out = _encode(params, cfg, batch, impl=impl, remat=remat)
        out = T.stack_apply(params["layers"], cfg, x, impl=impl, enc_out=enc_out, remat=remat,
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


def lm_loss(params, cfg: ModelConfig, batch, *, impl="cuda", remat=True, aux_weight=0.01,
            max_seqlen=None):
    """Next-token cross-entropy of a {"tokens", "labels", "mask"} batch
    (mean over the mask) plus ``aux_weight`` times the MoE load-balance
    loss, as the JAX package's ``lm_loss``; a packed batch's labels and
    mask are (1, T), ``max_seqlen`` its band (``forward``).  The LM head
    runs through ``layers.chunked_lm_head_loss``: from 4,096 positions on
    (along T for a packed batch) in checkpointed chunks of 512, so no (B, S,
    V) logits are held.  Its callers are the train steps
    (``parallel/steps.make_train_step``), the dry run's train cells
    (``launch/dryrun.py``, through the sharded step's ``lm_loss_sharded``)
    and the profiler.  Returns (loss, {"lm_loss", "aux_loss"})."""
    hidden, aux = forward(params, cfg, batch, impl=impl, remat=remat, max_seqlen=max_seqlen,
                          return_aux=True)
    loss, _ = L.chunked_lm_head_loss(lambda h: logits_of(params, cfg, h), hidden,
                                     batch["labels"], batch["mask"])
    aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
    return loss + aux_weight * aux, {"lm_loss": loss, "aux_loss": aux}


def synth_batch(rng, cfg: ModelConfig, seq_len: int, batch: int, kind="train", *,
                device="cuda"):
    """A synthetic batch of random tokens, an encoder-decoder's normal
    ``frames`` or a prefix model's normal ``prefix_embeds`` (B, prefix_len,
    D) in the config's dtype, and for ``kind="train"`` random labels and a
    unit mask, zero over a prefix model's prefix: the JAX package's
    ``synth_batch``, drawn from ``rng`` (a seed or a ``torch.Generator``)."""
    gen = rng if isinstance(rng, torch.Generator) else torch.Generator().manual_seed(int(rng))
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq_len), generator=gen)}
    if cfg.prefix_len:
        name = "frames" if cfg.family == "encdec" else "prefix_embeds"
        out[name] = torch.randn((batch, cfg.prefix_len, cfg.d_model),
                                generator=gen).to(L.dtype_of(cfg))
    if kind == "train":
        out["labels"] = torch.randint(0, cfg.vocab_size, (batch, seq_len), generator=gen)
        out["mask"] = torch.ones((batch, seq_len), dtype=torch.float32)
        if cfg.prefix_len and cfg.family != "encdec":
            out["mask"][:, :cfg.prefix_len] = 0.0
    return {k: v.to(device) for k, v in out.items()}


# ----------------------------------------------------------------- serving
# Every serving entry point runs under torch.no_grad(): the trained actor's
# parameters require grad, and the decode kernels have no backward.

@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch, max_len, *, impl="cuda"):
    """Run the prompt (an encoder-decoder's frames through its encoder
    first), fill caches, return (last_hidden (B, D), caches)."""
    x = _embed_inputs(params, cfg, batch)
    enc_out = _encode(params, cfg, batch, impl=impl)
    caches = T.cache_init(cfg, x.shape[0], max_len, L.dtype_of(cfg), x.device,
                          cross=enc_out is not None,
                          enc_len=None if enc_out is None else enc_out.shape[1])
    h = T.stack_prefill(params["layers"], cfg, x, caches, impl=impl, enc_out=enc_out)
    h = L.rmsnorm_apply(params["final_norm"], h, cfg.norm_eps)
    return h[:, -1], caches


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token, caches, t: int, *, impl="cuda"):
    """token: (B,) int; t: the position of this token.
    Returns (logits (B, V) fp32, caches)."""
    x = _embed(params, cfg, token[:, None])
    h = T.stack_decode(params["layers"], cfg, x, caches, t, impl=impl,
                       cross=cfg.family == "encdec")
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
def paged_draft_step(params, cfg: ModelConfig, token, caches, block_table, positions,
                     rng=None, *, temperature: float = 1.0, top_k: int = 0,
                     top_p: float = 1.0, impl="cuda"):
    """The draft model's step: ``paged_decode_and_sample_step`` that also
    returns the full (B, V) fp32 logits, the proposal distribution the
    verify's residual resampling needs.  Returns (next_token (B,),
    logits (B, V), caches)."""
    logits, caches = paged_decode_step(params, cfg, token, caches, block_table,
                                       positions, impl=impl)
    tok, _ = ops.sample_logits(logits, rng, temperature=temperature,
                               top_k=top_k, top_p=top_p, impl=impl)
    return tok, logits.to(torch.float32), caches


@torch.no_grad()
def paged_verify_step(params, cfg: ModelConfig, tokens, caches, block_table, positions,
                      *, impl="cuda"):
    """Score a speculative window in one prefill-shaped step over paged
    caches.  tokens: (B, K), the last committed token then the draft's
    proposals; positions: (B, K) their positions.  Every token's KV is
    written into the pools (a window layer's ring takes the accepted ones
    at ``transformer.stack_commit_verify``), and position i's logits are
    the target's next-token distribution after tokens[:, :i+1], as i + 1
    single-token steps would give.  Returns (logits (B, K, V) fp32,
    caches)."""
    x = _embed(params, cfg, tokens)
    h = T.stack_paged_verify(params["layers"], cfg, x, caches, block_table, positions,
                             impl=impl)
    h = L.rmsnorm_apply(params["final_norm"], h, cfg.norm_eps)
    return logits_of(params, cfg, h).to(torch.float32), caches


@torch.no_grad()
def generate(params, cfg: ModelConfig, batch, *, num_new_tokens: int,
             rng=None, temperature: float = 1.0, impl="cuda",
             eos_id: int | None = None, top_k: int = 0, top_p: float = 1.0):
    """Greedy (``rng=None``) or sampled (``rng`` a ``torch.Generator``)
    generation after a prefill of ``batch`` (its frames or prefix
    embeddings too): the JAX package's fused ``generate``.

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
    buckets only fix the shapes each call sees.  An encoder-decoder's frames
    pass through unpadded; a prefix model is refused (left padding would
    shift its tokens out from under the prefix splice)."""

    def __init__(self, cfg: ModelConfig, *, temperature: float = 1.0,
                 impl: str = "cuda", eos_id: int | None = None,
                 pad_id: int = 0, top_k: int = 0, top_p: float = 1.0,
                 buckets=GEN_BUCKETS):
        if cfg.prefix_len and cfg.family != "encdec":
            raise ValueError("BucketedGenerator does not support prefix (vlm) configs; pad "
                             "prompts upstream instead")
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


# ----------------------------------------------------------------- sharded
# The forward, loss, prefill and decode of ``parallel/steps.py``'s sharded
# steps: explicit SPMD over the mesh of ``ctx`` (``parallel/ctx.py``), every
# per-rank value a dict {logical id: tensor}, ``params`` a tree of
# ``ShardedTensor`` leaves laid out by ``parallel/sharding.py``.  A rank's
# batch is a dict as ``forward``'s, holding its batch replica's rows: an
# encoder-decoder's encoder runs sharded over the rank's frames, and a
# prefix model's embeddings are spliced in once the token embeddings are
# whole on every rank.

def vocab_split(params, cfg: ModelConfig, ctx) -> bool:
    """Whether the logits are vocabulary-parallel (``sanitize_specs`` drops
    the tensor axis from a vocabulary it does not divide: granite's 49,155
    at an even degree)."""
    if cfg.tie_embeddings:
        return ctx.tp_splits(params["embed"]["table"], 0)
    return ctx.tp_splits(params["lm_head"]["w"], 1)


def _embed_sharded(params, top, cfg: ModelConfig, tokens, ctx):
    """{rank: (B_r, S, D)} embeddings of {rank: (B_r, S) tokens}; ``top`` is
    ``ctx.local`` of the non-layer params.  A vocabulary-parallel table
    looks up its own rows (zeros elsewhere), summed over the tensor axis."""
    if not ctx.tp_splits(params["embed"]["table"], 0):
        return {r: L.embed_apply(top[r]["embed"], t).to(L.dtype_of(cfg))
                for r, t in tokens.items()}
    xs = {r: L.embed_apply_vocab_shard(top[r]["embed"], t,
                                       ctx.tp_index(r) * top[r]["embed"]["table"].shape[0])
          for r, t in tokens.items()}
    return {r: x.to(L.dtype_of(cfg)) for r, x in ctx.tp_reduce(xs).items()}


def _top(params, ctx) -> dict:
    """``ctx.local`` of the parameters outside the layer stacks (an
    encoder's final norm, not its layers, which each layer gathers)."""
    top = {k: v for k, v in params.items() if k not in ("layers", "encoder")}
    if "encoder" in params:
        top["encoder"] = {"final_norm": params["encoder"]["final_norm"]}
    return ctx.local(top)


def _embed_inputs_sharded(params, top, cfg: ModelConfig, batch, ctx):
    """``_embed_inputs`` over a mesh: the tokens' embeddings, summed over
    the tensor axis where the vocabulary is split, then the prefix spliced
    in (before that sum it would be counted once per tensor rank)."""
    xs = _embed_sharded(params, top, cfg, {r: b["tokens"] for r, b in batch.items()}, ctx)
    return {r: _splice_prefix(cfg, x, batch[r]) for r, x in xs.items()}


def _encode_sharded(params, top, cfg: ModelConfig, batch, ctx, *, impl, remat=False):
    """``_encode`` over a mesh: {rank: the encoder output of its rows'
    frames}, whole on every tensor rank after the encoder's last
    all-reduce and its replicated final norm; None for a decoder-only
    model."""
    if cfg.family != "encdec":
        return None
    hs = T.stack_apply_sharded(params["encoder"]["layers"], cfg,
                               {r: _input(b, "frames", cfg) for r, b in batch.items()},
                               ctx=ctx, impl=impl, causal=False, remat=remat)
    return {r: L.rmsnorm_apply(top[r]["encoder"]["final_norm"], h, cfg.norm_eps)
            for r, h in hs.items()}


def _final_hidden(params, cfg: ModelConfig, batch, ctx, *, impl, remat=False,
                  return_aux=False):
    """(top, {rank: final-normed hidden}, aux).  A packed batch (each rank
    its replica's {"tokens" (T_r,), "positions", "cu_seqlens",
    "max_seqlen"}, ``parallel/steps.split_batch``) runs as each rank's
    (1, T_r) cohort, as ``forward`` runs one."""
    top = _top(params, ctx)
    if "cu_seqlens" in next(iter(batch.values())):
        xs = _embed_sharded(params, top, cfg, {r: b["tokens"][None] for r, b in batch.items()},
                            ctx)
        out = T.stack_apply_sharded(
            params["layers"], cfg, xs, ctx=ctx, impl=impl, remat=remat, return_aux=return_aux,
            positions={r: b["positions"][None] for r, b in batch.items()},
            cu_seqlens={r: b["cu_seqlens"] for r, b in batch.items()},
            max_seqlen={r: b["max_seqlen"] for r, b in batch.items()})
    else:
        xs = _embed_inputs_sharded(params, top, cfg, batch, ctx)
        enc = _encode_sharded(params, top, cfg, batch, ctx, impl=impl, remat=remat)
        out = T.stack_apply_sharded(params["layers"], cfg, xs, ctx=ctx, impl=impl,
                                    enc_outs=enc, remat=remat, return_aux=return_aux)
    hs, aux = out if return_aux else (out, None)
    hs = {r: L.rmsnorm_apply(top[r]["final_norm"], h, cfg.norm_eps) for r, h in hs.items()}
    return top, hs, aux


def forward_sharded(params, cfg: ModelConfig, batch, *, ctx, impl="cuda", remat=False,
                    return_aux=False):
    """``forward`` over a mesh: batch {rank: {"tokens": (B_r, S), and an
    encoder-decoder's "frames" or a prefix model's "prefix_embeds"}} (each
    rank its batch replica's rows), or a packed batch as ``split_batch``
    deals one.  Returns {rank: final-normed hidden (B_r, S, D), packed (1,
    T_r, D)}, or with ``return_aux`` also {rank: MoE load-balance loss}."""
    _, hs, aux = _final_hidden(params, cfg, batch, ctx, impl=impl, remat=remat,
                               return_aux=return_aux)
    return (hs, aux) if return_aux else hs


def global_seq_len(batch, ctx) -> int:
    """The sequence length of the global batch whose per-rank rows are
    ``batch``: a padded batch's S, a packed cohort's T, the sum of its
    batch replicas' T_r (``packing.split_packed`` deals every token)."""
    if "cu_seqlens" not in next(iter(batch.values())):
        return next(iter(batch.values()))["labels"].shape[1]
    per = {ctx.batch_index(r): b["labels"].shape[1] for r, b in batch.items()}
    return sum(per.values())


def nll_sums_sharded(top, cfg: ModelConfig, hs, labels, masks, *, ctx, split: bool,
                     chunk: int = 0):
    """{rank: the masked next-token NLL summed over its rows} of the
    final-normed hidden states hs {rank: (B_r, S_r, D)} under ``top``'s LM
    head (each rank's vocabulary block where ``split``).  With ``chunk``
    each rank's rows run in chunks of ``chunk`` positions along S_r (the
    last one short where chunk does not divide S_r, none where a replica
    has fewer), each chunk over all ranks ``layers.checkpointed``: its
    logits and the vocabulary-parallel all-reduces are recomputed in the
    backward."""
    ranks = list(hs)
    n = len(ranks)

    def nll_sums(*flat):
        h, y, m = (dict(zip(ranks, flat[i * n:(i + 1) * n])) for i in range(3))
        logits = {r: logits_of(top[r], cfg, h[r]) for r in ranks}  # the rank's vocabulary
        if split:
            mx = ctx.tp_reduce({r: l.detach().amax(dim=-1) for r, l in logits.items()},
                               op="max")
            s = ctx.tp_reduce({r: torch.exp(l - mx[r][..., None]).sum(dim=-1)
                               for r, l in logits.items()})
            gold = ctx.tp_reduce({r: L.gather_vocab_shard(l, y[r], ctx.tp_index(r) * l.shape[-1])
                                  for r, l in logits.items()})
            nll = {r: mx[r] + torch.log(s[r]) - gold[r] for r in ranks}
        else:
            nll = {r: L.token_nll(l, y[r]) for r, l in logits.items()}
        return tuple((nll[r] * m[r]).sum() for r in ranks)

    flat = [hs[r] for r in ranks] + [labels[r] for r in ranks] + [masks[r] for r in ranks]
    if not chunk:
        return dict(zip(ranks, nll_sums(*flat)))
    total = None
    for i in range(-(-max(h.shape[1] for h in hs.values()) // chunk)):
        part = L.checkpointed(nll_sums, *(x[:, i * chunk:(i + 1) * chunk] for x in flat))
        total = part if total is None else tuple(a + b for a, b in zip(total, part))
    return dict(zip(ranks, total))


def lm_loss_sharded(params, cfg: ModelConfig, batch, *, ctx, impl="cuda", remat=True,
                    aux_weight=0.01):
    """``lm_loss`` over a mesh: batch {rank: {"tokens", "labels", "mask"}
    (and the frames or prefix embeddings)}, or a packed batch with (1,
    T_r) labels and mask.

    The logits stay vocabulary-parallel: each rank's logsumexp takes the
    max over the tensor axis (an all-reduce max) and the sum of its
    exponentials (an all-reduce sum), and the gold logit comes from the
    rank that holds the label, summed over the tensor axis; no rank
    gathers the (B, S, V) logits.  The head is chunked by the JAX rule
    (``layers.lm_head_chunk``) on the global batch's sequence length, each
    rank chunking its own rows (``nll_sums_sharded``).  The loss is the
    mean over the global mask: the masked sum and the token count are each
    all-reduced over the batch axes before the one division (replicas'
    means would weigh their masks wrongly).  Returns (loss, {"lm_loss",
    "aux_loss"}), 0-d tensors on the mesh's first device; the loss is
    computed once, from the first rank's copies."""
    top, hs, aux = _final_hidden(params, cfg, batch, ctx, impl=impl, remat=remat,
                                 return_aux=True)
    sums = nll_sums_sharded(top, cfg, hs, {r: b["labels"] for r, b in batch.items()},
                            {r: b["mask"] for r, b in batch.items()}, ctx=ctx,
                            split=vocab_split(params, cfg, ctx),
                            chunk=L.lm_head_chunk(global_seq_len(batch, ctx)))
    num = ctx.batch_reduce(sums)
    cnt = ctx.batch_reduce({r: batch[r]["mask"].sum() for r in sums})
    root = ctx.ranks[0]
    loss = num[root] / torch.clamp(cnt[root], min=1.0)
    return loss + aux_weight * aux[root], {"lm_loss": loss, "aux_loss": aux[root]}


@torch.no_grad()
def prefill_sharded(params, cfg: ModelConfig, batch, max_len, *, ctx, impl="cuda"):
    """``prefill`` over a mesh: batch {rank: {"tokens": (B_r, S), and the
    frames or prefix embeddings}}.  Returns ({rank: next-token logits (B_r,
    V_r) fp32}, {rank: the rank's layer caches}): each rank's caches hold
    its batch rows and its own KV heads (where the tensor axis does not
    divide them, every KV head for its own block of the slots), RG-LRU
    channels or SSD heads, every one of them where the layer's mixer runs
    whole (``transformer.cache_init_sharded``), so the
    decode kernel runs on whole heads; an encoder-decoder's also the cross
    k/v of the same heads over its rows' encoder output ("xkv")."""
    top = _top(params, ctx)
    xs = _embed_inputs_sharded(params, top, cfg, batch, ctx)
    enc = _encode_sharded(params, top, cfg, batch, ctx, impl=impl)
    plans = T.layer_plans(params["layers"], cfg, ctx)
    caches = {r: T.cache_init_sharded(cfg, ctx, r, x.shape[0], max_len, L.dtype_of(cfg),
                                      x.device, plans=plans, cross=enc is not None,
                                      enc_len=None if enc is None else enc[r].shape[1])
              for r, x in xs.items()}
    hs = T.stack_prefill_sharded(params["layers"], cfg, xs, caches, max_len, ctx=ctx,
                                 impl=impl, enc_outs=enc)
    hs = {r: L.rmsnorm_apply(top[r]["final_norm"], h, cfg.norm_eps)[:, -1:]
          for r, h in hs.items()}
    return {r: logits_of(top[r], cfg, h)[:, 0] for r, h in hs.items()}, caches


@torch.no_grad()
def decode_step_sharded(params, cfg: ModelConfig, token, caches, t: int, max_len: int, *, ctx,
                        impl="cuda"):
    """``decode_step`` over a mesh: token {rank: (B_r,)} at position t,
    caches from ``prefill_sharded`` at ``max_len`` (updated in place; each
    rank of a cache split by slot reads its own valid slots, and an
    encoder-decoder's cross-attention reads their "xkv", so no frames are
    needed).  Returns {rank: logits (B_r, V_r) fp32}."""
    top = _top(params, ctx)
    xs = _embed_sharded(params, top, cfg, {r: x[:, None] for r, x in token.items()}, ctx)
    hs = T.stack_decode_sharded(params["layers"], cfg, xs, caches, t, max_len, ctx=ctx,
                                impl=impl)
    hs = {r: L.rmsnorm_apply(top[r]["final_norm"], h, cfg.norm_eps) for r, h in hs.items()}
    return {r: logits_of(top[r], cfg, h)[:, 0] for r, h in hs.items()}
