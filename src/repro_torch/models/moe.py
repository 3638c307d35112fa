"""Top-k MoE FFN (the JAX package's ``models/moe.py``), with the dispatch
``cfg.moe_dispatch`` names:

* ``"dropless"``: each token's (token, expert) assignments are stably
  sorted by expert, the expert-sorted rows go through one grouped expert
  FFN (``ops.grouped_ffn``) over the real row count, and the results are
  combined with the router weights renormalised over the token's own
  top-k.  No capacity buffer and no drops, so a token's output does not
  depend on the cohort it is computed in (training forward, prefill or a
  decode step).  Nothing reads back to the host: ``group_sizes`` is an
  int32 ``scatter_add_`` and the kernel derives its work units from it on
  the device.
* ``"capacity"``: the (E, C, D) capacity-drop buffers, C from the cohort's
  token count (``capacity``).  The assignments past an expert's C rows
  (drop rank over the flat batch-major cohort) all go to one discard slot
  and fall back to the residual path; a token's combine weights are
  renormalised over the experts it kept, so routing is cohort-dependent.
  The expert products are batched ``einsum``s in x's dtype (the JAX
  package computes them outside any Pallas kernel too).

Both combines un-permute the (T*K, D) expert rows to (T, K, D), sum over k
in a fixed order in fp32 (no float atomics) and cast once.  Arctic's dense
residual MLP (``cfg.dense_residual_ffn``, the params' ``"dense"``) is added
to either, in x's dtype.

The training forward (``want_aux=True``) also returns the Switch
load-balance loss; serving skips it.  ``moe_apply_sharded`` is the
expert-parallel layer over a mesh (experts split over the tensor axis, the
dense residual over its d_ff) under either dispatch.  The expert FFN is
differentiable on both tiers (``grouped_ffn``'s plain backward).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

CAPACITY_FACTOR = 1.25


def moe_init(gen, cfg: ModelConfig, device):
    dt = L.dtype_of(cfg)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    p = {
        "router": L.dense_init(gen, d, e, torch.float32, device),
        "w_gate": L.truncated_normal(gen, (e, d, f), dt, d ** -0.5, device),
        "w_in": L.truncated_normal(gen, (e, d, f), dt, d ** -0.5, device),
        "w_out": L.truncated_normal(gen, (e, f, d), dt, f ** -0.5, device),
    }
    if cfg.dense_residual_ffn:
        p["dense"] = L.mlp_init(gen, cfg, device)
    return p


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Rows per expert of the capacity dispatch for a cohort of
    ``n_tokens`` tokens: at least 8, at most the token count."""
    c = int(n_tokens * cfg.top_k * CAPACITY_FACTOR / cfg.n_experts)
    return max(8, min(n_tokens, c))


def _router(p, cfg: ModelConfig, xf):
    """(T, D) -> (top_w (T, K) f32, top_i (T, K) int64)."""
    logits = L.dense_apply(p["router"], xf.to(torch.float32))
    return torch.topk(torch.softmax(logits, dim=-1), cfg.top_k, dim=-1)


def _aux_terms(p, xf, top_i, e: int):
    """The load-balance loss's inputs: the router's probabilities (T, E)
    and the (token, k) assignments per expert (E,), both fp32.  Recomputes
    the router's softmax (one (T, D) x (D, E) product) rather than widening
    ``_router``'s result."""
    probs = torch.softmax(L.dense_apply(p["router"], xf.to(torch.float32)), dim=-1)
    counts = torch.zeros((e,), dtype=torch.float32, device=xf.device).scatter_add_(
        0, top_i.reshape(-1), torch.ones((top_i.numel(),), dtype=torch.float32,
                                         device=xf.device))
    return probs, counts


def _aux_loss(p, xf, top_i, e: int):
    """Switch-style load-balance loss, E * sum_e f_e * p_e: f_e the share of
    the (token, k) assignments routed to expert e, p_e its mean router
    probability."""
    probs, counts = _aux_terms(p, xf, top_i, e)
    return e * torch.sum(probs.mean(dim=0) * counts / top_i.numel())


def _group_sizes(top_i, e: int):
    """Rows per expert, (E,) int32, as an integer scatter-add on the device."""
    flat = top_i.reshape(-1)
    return torch.zeros((e,), dtype=torch.int32, device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))


def _sort_by_expert(top_i, k: int):
    """Stably sort the flattened (T, K) assignments by expert.  Returns
    (order, st): the sorted flat indices and their token ids."""
    order = torch.argsort(top_i.reshape(-1), stable=True)
    return order, torch.div(order, k, rounding_mode="floor")


def _unsort(rows, order, k: int):
    """Expert-sorted (T*K, D) rows back to (T, K, D): row i of the result's
    flat (token, k) order is ``rows[j]`` where ``order[j] == i``."""
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    return rows[inv].view(-1, k, rows.shape[-1])


def _expert_rows(p, cfg: ModelConfig, xf, top_w, top_i, lo: int, n: int, impl):
    """The (T, K, D) fp32 router-weighted expert outputs of the (token, k)
    assignments to experts lo .. lo + n - 1, whose weights ``p`` holds;
    other assignments give zero rows.  The local assignments are stably
    sorted by expert ahead of the others, which lie past the group sizes'
    total, where ``grouped_ffn`` leaves its rows zero (nothing is read back
    to the host to cut them off).  With lo 0 and n the expert count this is
    the whole dispatch."""
    k = cfg.top_k
    top_w = top_w / top_w.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    flat = top_i.reshape(-1)
    mine = (flat >= lo) & (flat < lo + n)
    key = torch.where(mine, flat - lo, n)
    order, st = _sort_by_expert(key, k)
    ys = ops.grouped_ffn(xf[st], _group_sizes(key, n + 1)[:n], p["w_gate"], p["w_in"],
                         p["w_out"], act=cfg.act, impl=impl)  # (T*K, D) f32
    return _unsort(ys, order, k) * top_w.to(torch.float32)[:, :, None]


def _sum_k(y):
    """Sum (T, K, D) over k as a fixed pairwise tree: the same order for
    every token in every cohort."""
    while y.shape[1] > 1:
        half = y.shape[1] // 2
        head = y[:, :half] + y[:, half:2 * half]
        y = torch.cat([head, y[:, 2 * half:]], dim=1) if y.shape[1] % 2 else head
    return y[:, 0]


def _dispatch_dropless(p, cfg: ModelConfig, xf, top_w, top_i, impl):
    rows = _expert_rows(p, cfg, xf, top_w, top_i, 0, cfg.n_experts, impl)
    return _sum_k(rows).to(xf.dtype)


def capacity_route(cfg: ModelConfig, top_w, top_i, t: int):
    """The capacity dispatch's routing for a T-token cohort.  Returns
    (order, st, slot, keep, sw, c) in expert-sorted order: the sorted flat
    (token, k) indices, their token ids, their buffer slots (``e*c`` for an
    assignment past its expert's c rows: the discard slot), the keep mask,
    and the combine weights renormalised over each token's kept experts
    (fp32; a token that loses an expert shares its weight among the rest),
    and the capacity c."""
    c = capacity(t, cfg)
    return _route(cfg, top_w, top_i, c) + (c,)


def _route(cfg: ModelConfig, top_w, top_i, c: int, offset=None):
    """``capacity_route``'s (order, st, slot, keep, sw) for a cohort's rows
    after ``offset`` (E,) assignments per expert earlier in the token-major
    order (None for a whole cohort): an assignment's slot is its place
    among its expert's assignments counted from there."""
    e, k = cfg.n_experts, cfg.top_k
    order, st = _sort_by_expert(top_i, k)
    se = top_i.reshape(-1)[order]
    counts = _group_sizes(top_i, e).to(se.dtype)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(se.numel(), device=se.device) - starts[se]
    if offset is not None:
        rank = rank + offset[se]
    keep = rank < c
    slot = torch.where(keep, se * c + rank, e * c)
    keep_tk = torch.empty_like(keep).scatter_(0, order, keep).view(-1, k)
    w_kept = top_w * keep_tk
    w = w_kept / w_kept.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    sw = w.reshape(-1)[order].to(torch.float32)
    return order, st, slot, keep, sw


def _count_offsets(counts: dict, ctx) -> dict:
    """{rank: (E,) assignments per expert of the batch replicas before the
    rank's}: the replicas' counts all-gathered over the batch axes."""
    every = ctx.batch_gather({r: n[None] for r, n in counts.items()})
    return {r: every[r][:ctx.batch_index(r)].sum(dim=0) for r in counts}


def capacity_route_sharded(cfg: ModelConfig, routes: dict, *, ctx):
    """``capacity_route`` over the global cohort of the batch replicas:
    routes {rank: (top_w, top_i) of its rows}.  The capacity is the global
    cohort's, and an assignment's slot is its place in the global
    token-major sort by expert, replica 0's rows first (the JAX package's
    GSPMD step sorts the whole cohort): each rank offsets its own count by
    the replicas' before it.  The global cohort's tokens are the sum of the
    replicas' row counts, which differ where a packed cohort was dealt by
    whole sequences (``packing.split_packed``).  Returns {rank: (order, st,
    slot, keep, sw, c)} over the rank's rows, slots in the global
    buffer."""
    e = cfg.n_experts
    rows = {ctx.batch_index(r): ti.shape[0] for r, (_, ti) in routes.items()}
    c = capacity(sum(rows.values()), cfg)
    offsets = _count_offsets({r: _group_sizes(ti, e).long() for r, (_, ti) in routes.items()},
                             ctx)
    return {r: _route(cfg, tw, ti, c, offsets[r]) + (c,) for r, (tw, ti) in routes.items()}


def _capacity_rows(p, cfg: ModelConfig, xf, route, lo: int, n: int):
    """The (T, K, D) fp32 weighted expert outputs of the capacity dispatch
    ``route`` (``capacity_route``'s tuple) for the kept assignments to
    experts lo .. lo + n - 1, whose weights ``p`` holds; other assignments
    give zero rows.  Each kept row goes to its slot of an (n*C + 1, D)
    buffer in x's dtype (dropped and other experts' rows to the last,
    never read), and the experts run as batched einsums over n*C rows."""
    order, st, slot, keep, sw, c = route
    se = torch.div(slot, c, rounding_mode="floor")
    mine = keep & (se >= lo) & (se < lo + n)
    local = torch.where(mine, slot - lo * c, n * c)
    buf = xf.new_zeros((n * c + 1, xf.shape[1]))
    buf[local] = xf[st]
    xe = buf[:-1].view(n, c, xf.shape[1])
    g = L.ACTS[cfg.act](torch.einsum("ecd,edf->ecf", xe, p["w_gate"]))
    h = g * torch.einsum("ecd,edf->ecf", xe, p["w_in"])
    ye = torch.einsum("ecf,efd->ecd", h, p["w_out"]).reshape(n * c, -1)
    contrib = ye[local.clamp(max=n * c - 1)].to(torch.float32) * (
        sw * mine.to(torch.float32))[:, None]
    return _unsort(contrib, order, cfg.top_k)


def _dispatch_capacity(p, cfg: ModelConfig, xf, top_w, top_i):
    """Each kept assignment's row in its expert's slot of an (E*C + 1, D)
    buffer in x's dtype; every dropped one writes the last slot, which is
    never read (their order of writing does not matter).  The expert FFN
    runs on all E*C slots (empty ones zero) as batched products in x's
    dtype; a kept row's output times its weight, fp32, summed over k."""
    route = capacity_route(cfg, top_w, top_i, xf.shape[0])
    return _sum_k(_capacity_rows(p, cfg, xf, route, 0, cfg.n_experts)).to(xf.dtype)


def moe_apply(p, cfg: ModelConfig, x, *, impl="cuda", want_aux=False):
    """x: (B, S, D) -> (B, S, D) in x's dtype, through ``cfg.moe_dispatch``
    plus the dense residual MLP where ``p`` has one; with ``want_aux`` (the
    training forward) also the load-balance loss, a 0-d fp32 tensor."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    top_w, top_i = _router(p, cfg, xf)
    if cfg.moe_dispatch == "capacity":
        y = _dispatch_capacity(p, cfg, xf, top_w, top_i)
    else:
        y = _dispatch_dropless(p, cfg, xf, top_w, top_i, impl)
    y = y.reshape(b, s, d)
    if "dense" in p:
        y = y + L.mlp_apply(p["dense"], cfg, x)
    if want_aux:
        return y, _aux_loss(p, xf, top_i, cfg.n_experts)
    return y


def moe_apply_sharded(ps, cfg: ModelConfig, xs, *, ctx, impl="cuda", want_aux=False,
                      dense_ctx=None):
    """Expert parallelism over the tensor axis of ``ctx``: ps is {rank: the
    layer's local FFN params} (experts tp_index * E/tp onwards, the router
    whole; every expert on every rank under a ``ctx.whole()``, where the
    layout leaves the expert axis whole), xs {rank: (B_r, S, D)}.  Every
    rank routes its tokens with the replicated router and computes the
    (T, K, D) fp32 rows of the
    assignments to its own experts: the dropless dispatch through
    ``grouped_ffn``, the capacity dispatch through its einsums over the
    global cohort's slots (``capacity_route_sharded``: the capacity and
    each slot the single device's over the batch replicas' rows).  The
    rows are summed over the tensor axis (each row comes from one rank,
    zeros from the others, so the sum is exact), then summed over k and
    cast once, as on one device.  A dense residual MLP (``ps[r]["dense"]``,
    the rank's d_ff columns of w_gate and w_in and rows of w_out under
    ``dense_ctx``, default ``ctx``: its own d_ff decides whether the axis
    splits it) adds each rank's fp32 share of its output
    (``mlp_apply(partial=True)``), summed over ``dense_ctx``'s tensor axis
    and cast once.  With ``want_aux`` also {rank: the
    load-balance loss} from expert counts and router probability sums
    all-reduced over the batch axes: the global means' product, not a mean
    of the replicas'."""
    e = cfg.n_experts
    n = e // ctx.tp_size
    xfs = {r: x.reshape(-1, x.shape[-1]) for r, x in xs.items()}
    routes = {r: _router(ps[r], cfg, xf) for r, xf in xfs.items()}
    if cfg.moe_dispatch == "capacity":
        cap = capacity_route_sharded(cfg, routes, ctx=ctx)
        rows = {r: _capacity_rows(ps[r], cfg, xf, cap[r], ctx.tp_index(r) * n, n)
                for r, xf in xfs.items()}
    else:
        rows = {r: _expert_rows(ps[r], cfg, xf, *routes[r], ctx.tp_index(r) * n, n, impl)
                for r, xf in xfs.items()}
    terms = {}
    if want_aux:
        for r, xf in xfs.items():
            probs, counts = _aux_terms(ps[r], xf, routes[r][1], e)
            ntok = torch.full((1,), float(xf.shape[0]), device=xf.device)
            terms[r] = torch.cat([probs.sum(dim=0), counts, ntok])
    rows = ctx.tp_reduce(rows)
    ys = {r: _sum_k(rows[r]).to(x.dtype).reshape(x.shape) for r, x in xs.items()}
    if "dense" in next(iter(ps.values())):
        shares = (dense_ctx or ctx).tp_reduce(
            {r: L.mlp_apply(ps[r]["dense"], cfg, x, partial=True) for r, x in xs.items()})
        ys = {r: ys[r] + shares[r].to(x.dtype) for r, x in xs.items()}
    if not want_aux:
        return ys, None
    aux = {}
    for r, v in ctx.batch_reduce(terms).items():
        ntok = v[-1]
        aux[r] = e * torch.sum((v[:e] / ntok) * v[e:2 * e] / (ntok * cfg.top_k))
    return ys, aux
