"""Train, prefill and decode steps, single-device and sharded: the port of
the JAX package's ``parallel/steps.py``.  The profiler measures the
single-device train step.

JAX lowers these steps under ``jit`` with ``in_shardings`` and lets GSPMD
partition them.  The port has no partitioner, so with a ``mesh`` a step
runs explicit SPMD by hand, Megatron-style, in one process: every rank
(logical device of the mesh) computes on its own blocks
(``ShardedTensor.blocks``), ranks run one after another on the host, and
the collectives (``parallel/collectives.py``) sit where GSPMD puts them.
The layouts are ``parallel/sharding.py``'s: FSDP over the data axis (a
weight's block is all-gathered before use, its gradient reduce-scattered
by autograd), tensor parallelism over the model axis (column-parallel
q/k/v and gate/in projections, row-parallel o/out projections followed by
an all-reduce, a vocabulary-parallel embedding and head, MoE experts split
over the same axis), the batch over the batch axes.  Gradients of a leaf
replicated over an axis (a norm; a dim ``sanitize_specs`` left unsharded)
are all-reduced over it, so every replica holds the same bits after the
step.  Every mixer runs (attention, RG-LRU, SSD; ``models/transformer.py``
says how each splits) and either MoE dispatch, and so do an
encoder-decoder's encoder and cross-attention and a prefix model's splice
(``models/model.py``).  Any tensor degree runs: where the axis does not
divide a block's q_dim, FFN width, experts, RG-LRU width or SSD heads,
``sanitize_specs`` leaves its weights whole and every tensor rank computes
the whole block (``transformer.layer_plan``), as GSPMD replicates it;
where the axis splits a query head, every rank computes every head
(``transformer.heads_split``).  The AdamW state may
be ZeRO-1 over the pod axis (``opt_layouts``).  The train step also takes
a packed cohort (``cu_seqlens``), dealt to the batch replicas as runs of
whole sequences (``split_batch``): each rank's varlen attention and MoE
run on its replica's (1, T_r) cohort.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.data import packing
from repro_torch.models import layers as L
from repro_torch.models import model as MDL
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim.grad import accumulate_grads
from repro_torch.parallel import collectives as C
from repro_torch.parallel import ctx as CTX
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.layout import (Layout, P, ShardedTensor, axes_of, tree_at,
                                         tree_leaves, tree_map, tree_map_with_path)


def check_mesh(cfg: ModelConfig, mesh, rules: SH.ShardingRules, batch=None):
    """Raise unless ``rules``' axes are axes of ``mesh`` and ``cfg`` runs
    sharded at its tensor degree (``transformer.check_sharded``), and, for
    a packed ``batch``, unless ``cfg`` trains packed
    (``transformer.check_packed``, as on one device)."""
    for a in (rules.tp_axis, rules.fsdp_axis, *rules.batch_axes):
        if a and a not in mesh.shape:
            raise ValueError(f"rules name axis {a!r}, not in mesh {mesh.axis_names}")
    T.check_sharded(cfg, mesh.shape[rules.tp_axis] if rules.tp_axis else 1)
    if batch is not None and "cu_seqlens" in batch:
        T.check_packed(cfg)


def _on_mesh(tree, mesh, what):
    """``tree`` with every leaf a ``ShardedTensor`` on ``mesh``.  A leaf on
    another mesh whose layout is equivalent to its spec's on ``mesh`` (a
    replicated norm that a reshard aliased: it keeps its blocks and its old
    layout, as a JAX array keeps its sharding) comes back relabelled onto
    ``mesh``, its blocks shared; any other leaf raises."""
    def one(st):
        if isinstance(st, ShardedTensor):
            if st.layout.mesh == mesh:
                return st
            spec = st.layout.spec
            if all(a in mesh.shape for part in spec for a in axes_of(part)):
                lay = Layout(mesh, spec)
                if st.layout.is_equivalent_to(lay, len(st.shape)):
                    return ShardedTensor(st.shape, st.dtype, lay, st.blocks)
        raise ValueError(f"{what}: every leaf must be a ShardedTensor on {mesh!r}; got {st!r}")
    return tree_map(one, tree)


def split_batch(batch, mesh, rules: SH.ShardingRules, *, max_seqlen=None) -> dict:
    """{rank: {key: the rank's rows}}: every tensor of ``batch`` laid out
    by ``batch_specs``, its leading dim split over the batch axes.  A
    packed batch (with "cu_seqlens") goes to the batch replicas as runs of
    whole sequences (``packing.split_packed``, which checks
    ``max_seqlen``): each rank gets its replica's packed leaves on its
    device, its rebased "cu_seqlens" and its "max_seqlen"."""
    k = C.axis_size(mesh, rules.batch_axes) if rules.batch_axes else 1
    if "cu_seqlens" in batch:
        parts = packing.split_packed(batch, k, max_seqlen=max_seqlen)

        def rank_part(r):
            part = parts[C.axis_index(mesh, rules.batch_axes, r) if rules.batch_axes else 0]
            dev = mesh.torch_device(r)
            return {name: v.to(dev) if isinstance(v, torch.Tensor) else v
                    for name, v in part.items()}
        return {r: rank_part(r) for r in mesh.device_ids}
    for name, v in batch.items():
        if v.shape[0] % k:
            raise ValueError(f"batch[{name!r}] has {v.shape[0]} rows; {k} replicas need a "
                             "multiple")
    specs = SH.batch_specs(batch, rules)
    placed = {name: ShardedTensor.place(v, Layout(mesh, specs[name])).blocks
              for name, v in batch.items()}
    return {r: {name: placed[name][r] for name in batch} for r in mesh.device_ids}


def _replicated_axes(st: ShardedTensor) -> tuple:
    """The mesh axes (of size > 1) that no dim of ``st`` is sharded over."""
    used = {a for part in st.layout.spec for a in axes_of(part)}
    mesh = st.layout.mesh
    return tuple(a for a in mesh.axis_names if a not in used and mesh.shape[a] > 1)


def sharded_grads(loss_fn, params, batch, n_micro: int, mesh, rules, *, cfg: ModelConfig,
                  max_seqlen=None):
    """The sharded counterpart of ``optim.grad.accumulate_grads``.
    ``loss_fn(params, {rank: rows}) -> (loss, aux)``.  Microbatch j is the
    j-th slice of the global batch's rows, split over the replicas, so the
    step equals the single-device one row for row.  A packed batch is one
    microbatch (``split_batch`` deals its sequences; the JAX package's
    ``accumulate_grads`` has no packed microbatching to mirror), so
    ``n_micro > 1`` raises ``ValueError`` there.  Every block of every
    leaf requires grad; the fp32 gradient blocks are averaged over the
    microbatches, then summed over each leaf's replicated axes, the
    tensor axis left out for the leaves whose gradient every tensor rank
    holds whole (``transformer.full_grad_leaves`` of ``cfg``).  Returns
    (mean loss, a tree of fp32 ``ShardedTensor`` gradients on the params'
    layouts, the last microbatch's aux)."""
    sts = tree_leaves(params)
    packed = "cu_seqlens" in batch
    if packed and n_micro > 1:
        raise ValueError(f"a packed batch is one microbatch; got n_micro={n_micro}")
    blocks = [st.blocks[d] for st in sts for d in mesh.device_ids]
    for b in blocks:
        b.requires_grad_(True)
    rows = next(iter(batch.values())).shape[0]
    if rows % n_micro:
        raise ValueError(f"batch of {rows} rows does not split into {n_micro} microbatches")
    acc, loss_sum, aux = None, 0.0, {}
    for j in range(n_micro):
        mb = batch if packed else {k: v.reshape(n_micro, rows // n_micro, *v.shape[1:])[j]
                                   for k, v in batch.items()}
        with torch.enable_grad():
            loss, aux = loss_fn(params, split_batch(mb, mesh, rules, max_seqlen=max_seqlen))
            grads = torch.autograd.grad(loss, blocks, allow_unused=True)
        grads = [torch.zeros(b.shape, dtype=torch.float32, device=b.device) if g is None
                 else g.to(torch.float32) for b, g in zip(blocks, grads)]
        acc = grads if acc is None else [a + g for a, g in zip(acc, grads)]
        loss_sum = loss_sum + loss.detach()
        aux = {k: v.detach() for k, v in aux.items()}
    acc = iter([a / n_micro for a in acc]) if n_micro > 1 else iter(acc)
    whole = {id(st) for st in T.full_grad_leaves(
        params, cfg, CTX.ShardingCtx(mesh, rules.batch_axes, rules.tp_axis))}
    out = {}
    with torch.no_grad():
        for st in sts:
            g = {d: next(acc) for d in mesh.device_ids}
            rep = tuple(a for a in _replicated_axes(st)
                        if not (id(st) in whole and a == rules.tp_axis))
            if rep:
                g = C.all_reduce(g, mesh, rep)
            out[id(st)] = ShardedTensor(st.shape, torch.float32, st.layout, g)
    return loss_sum / n_micro, tree_map(lambda st: out[id(st)], params), aux


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, *, impl="cuda", remat=True,
                    n_micro: int = 1, mesh=None, rules: SH.ShardingRules | None = None,
                    max_seqlen: int | None = None):
    """(params, opt_state, batch) -> (params, opt_state, metrics): the LM
    loss's gradient over ``n_micro`` microbatches, then one AdamW update
    (in place).

    Without ``mesh`` the parameters are tensors that must require grad.
    With a ``mesh`` (and ``rules``, default ``ShardingRules()``: FSDP over
    data, TP over model) they are a tree of ``ShardedTensor``s laid out by
    ``param_shardings`` (sanitized), the optimizer state ``adamw.init`` of
    them, on their layouts or on ``opt_layouts``' (ZeRO-1 over the pod
    axis: each rank updates its slice, then the slices are all-gathered),
    and the batch a dict of global (B, S) tensors, or a packed cohort
    {"tokens" (T,), "positions" (T,), "cu_seqlens", "labels" (1, T), "mask"
    (1, T)} (the JAX package's packed ``lm_loss`` batch; ``n_micro`` 1),
    whose sequences ``split_batch`` deals to the batch replicas, each
    rank's varlen attention banded by its replica's longest segment; the
    loss is ``model.lm_loss_sharded``.

    ``max_seqlen`` is a packed cohort's band, as the packed PPO steps take
    it: one device's varlen attention is banded by it, and a longer
    sequence raises (``packing.check_band``)."""
    if mesh is None:
        def loss_fn(params, batch):
            return MDL.lm_loss(params, cfg, batch, impl=impl, remat=remat,
                               max_seqlen=max_seqlen)

        def step(params, opt_state, batch):
            if "cu_seqlens" in batch:
                packing.check_band(batch["cu_seqlens"], max_seqlen)
            loss, grads, aux = accumulate_grads(loss_fn, params, batch, n_micro)
            params, opt_state, stats = adamw.update(opt_cfg, params, opt_state, grads)
            return params, opt_state, {"loss": loss, **aux, **stats}
        return step

    rules = rules or SH.ShardingRules()
    check_mesh(cfg, mesh, rules)

    def step(params, opt_state, batch):
        check_mesh(cfg, mesh, rules, batch)
        params = _on_mesh(params, mesh, "params")
        with CTX.use(mesh, rules.batch_axes, rules.tp_axis) as c:
            def loss_fn(params, parts):
                return MDL.lm_loss_sharded(params, cfg, parts, ctx=c, impl=impl, remat=remat)
            loss, grads, aux = sharded_grads(loss_fn, params, batch, n_micro, mesh, rules,
                                             cfg=cfg, max_seqlen=max_seqlen)
            params, opt_state, stats = adamw.update(opt_cfg, params, opt_state, grads)
        return params, opt_state, {"loss": loss, **aux, **stats}

    return step


def opt_layouts(params, mesh, rules: SH.ShardingRules, *, pod_size=None):
    """The ``Layout`` tree of the AdamW state (m, v, master) of the
    ``ShardedTensor`` tree ``params``: ``opt_state_specs`` of their specs
    and shapes, sanitized, as the JAX package lays it out.  Where
    ``rules.pod_axis`` is set and ``shard_opt_over_pod`` (ZeRO-1), each
    leaf's first whole dim that ``pod_size`` (default: the pod axis's
    size) divides is split over the pod axis too."""
    pspecs = tree_map(lambda st: st.layout.spec, params)
    size = pod_size or (mesh.shape[rules.pod_axis] if rules.pod_axis else 2)
    specs = SH.opt_state_specs(pspecs, rules, params, pod_size=size)["m"]
    return tree_map(lambda s: Layout(mesh, s), SH.sanitize_specs(specs, params, mesh))


def _logits_layout(params, cfg, mesh, rules, c):
    part = rules.tp_axis if MDL.vocab_split(params, cfg, c) else None
    return Layout(mesh, P(_batch_part(rules), part))


def _batch_part(rules):
    ax = rules.batch_axes
    return ax if len(ax) > 1 else (ax[0] if ax else None)


def _as_sharded(per_rank: dict, layout: Layout, shape) -> ShardedTensor:
    """{rank: block} as the global ``shape`` on ``layout``."""
    return ShardedTensor(shape, next(iter(per_rank.values())).dtype, layout, per_rank)


# The dim of each cache leaf that a rank holds its share of over the tensor
# axis: attention k/v (a decoder layer's cross "xkv" too) by KV head (where
# ``kv_replicated`` none: self-attention's k/v split their slots, dim 1,
# instead, ``transformer.attn_slots``, and "xkv" is on every rank), the
# RG-LRU state by channel, the SSD state by head and its conv state's x
# channels (``ssm.ssm_state_init_sharded``; its B and C channels are on
# every rank).  A layer whose mixer (or cross-attention, for "xkv") runs
# whole (``transformer.layer_plan``) holds none of them by the tensor
# axis.
_CACHE_TP_DIM = {"k": 2, "v": 2, "h": 1, "conv": 2, "ssm": 1, "conv_x": 2, "conv_bc": None}
_SLOT_DIM = 1


def wrap_caches(caches: dict, cfg, mesh, rules, max_len: int, layers):
    """{rank: layer caches at ``max_len`` positions} as a list per layer of
    the same (nested) dicts of ``ShardedTensor``s, each rank's block its
    batch rows and its share over the tensor axis (``_CACHE_TP_DIM``), or,
    for self-attention k/v split by slot, its block of the slots over the
    slot axes (``transformer.attn_slots``).  ``layers``: the parameters'
    layer trees whose ``layer_plan`` made the caches."""
    k = C.axis_size(mesh, rules.batch_axes) if rules.batch_axes else 1
    c = CTX.ShardingCtx(mesh, rules.batch_axes, rules.tp_axis)
    r0 = mesh.device_ids[0]
    out = []
    for i, (spec, plan) in enumerate(zip(cfg.layers, T.layer_plans(layers, cfg, c))):
        mc = plan["mixer"]
        slots = None
        if spec.kind == ATTN:
            rows = tree_leaves(caches[r0][i])[0].shape[0]
            slots = T.attn_slots(cfg, spec, mc, r0, rows, max_len)

        def wrap(path, blk, i=i, slots=slots, plan=plan, mc=mc):
            parts = [_batch_part(rules)] + [None] * (blk.dim() - 1)
            shape = [blk.shape[0] * k, *blk.shape[1:]]
            own = plan["xattn"] if "xkv" in path else mc
            if slots is not None and "xkv" not in path:
                parts[_SLOT_DIM] = slots.axes[0] if len(slots.axes) == 1 else slots.axes
                shape[_SLOT_DIM] = slots.cap
            replicated = spec.kind == ATTN and T.kv_replicated(cfg, own.tp_size)
            dim = None if replicated or own.tp_axis is None else _CACHE_TP_DIM[path[-1]]
            if dim is not None:
                parts[dim] = own.tp_axis
                shape[dim] *= own.tp_size
            return _as_sharded({r: tree_at(caches[r][i], path) for r in caches},
                               Layout(mesh, P(*parts)), tuple(shape))
        out.append(tree_map_with_path(wrap, caches[r0][i]))
    return out


def gathered_caches(caches: list, device=None) -> list:
    """The sharded caches of ``make_prefill_step`` gathered (onto
    ``device``) into the single-device ones (``transformer.cache_init``'s):
    a cache split by slot rejoined from its blocks (its layout's regions),
    an SSD layer's conv state joined from its x and its B and C channels."""
    out = []
    for layer in caches:
        whole = tree_map(lambda st: st.gather(device), layer)
        if "conv_x" in whole:
            whole["conv"] = torch.cat([whole.pop("conv_x"), whole.pop("conv_bc")], dim=-1)
        out.append(whole)
    return out


def make_prefill_step(cfg: ModelConfig, *, impl="cuda", extra_len: int = 0, mesh=None,
                      rules: SH.ShardingRules | None = None):
    """(params, batch) -> (next_token_logits, caches).

    With a ``mesh``: ``params`` a ``ShardedTensor`` tree and ``batch``
    {"tokens": (B, S)} global (with an encoder-decoder's "frames" or a
    prefix model's "prefix_embeds", split by rows as the tokens); the
    logits come back as a (B, V)
    ``ShardedTensor`` laid out over (batch axes, tensor axis) (the
    vocabulary replicated where the axis does not divide it), the caches as
    a list per layer of ``ShardedTensor``s, each rank holding its batch rows
    and (``cache_partition_specs`` lists the layouts):
      * attention {"k", "v"} (B, S_max or the window, Hkv, Dh): its own
        KV heads, ``P(batch, None, model, None)``, so ``flash_decode``
        runs on whole heads; where the tensor axis does not divide the KV
        heads every head for its own ceil-sized block of the slots,
        ``P(batch, model, None, None)`` (a ring's too: a token at position
        p sits at slot p % W on the rank whose block holds it; each rank's
        decode attends its block and the ranks merge by log-sum-exp); a
        batch-1 cache without batch axes whose slot count 16 divides and
        is at least 4,096 (the JAX dry run's rule) also splits its slots
        over the data axis, ``P(None, (data, model), None, None)``, or
        ``P(None, data, model, None)`` where the model axis holds KV
        heads;
      * RG-LRU {"h": (B, W) fp32, "conv": (B, 3, W)}: its channels,
        ``P(batch, model)`` and ``P(batch, None, model)``;
      * SSD {"ssm": (B, H, P, N) fp32, "conv_x": (B, K-1, di), "conv_bc":
        (B, K-1, 2N)}: its heads, ``P(batch, model, None, None)``, their x
        channels of the conv state, ``P(batch, None, model)``, and its B
        and C channels, ``P(batch, None, None)``;
      * an encoder-decoder's decoder layer {"self": its attention cache as
        above, "xkv": {"k", "v"} (B, prefix_len, Hkv, Dh)}: the cross k/v
        of its KV heads over its rows' encoder output, computed once here,
        laid out as "self" is (by KV head, or replicated over the tensor
        axis: "xkv" is never split by slot).
    ``gathered_caches`` joins them into the single-device caches."""
    if mesh is None:
        def step(params, batch):
            max_len = batch["tokens"].shape[1] + max(extra_len, 1)
            last_h, caches = MDL.prefill(params, cfg, batch, max_len, impl=impl)
            return MDL.logits_of(params, cfg, last_h[:, None])[:, 0], caches
        return step

    rules = rules or SH.ShardingRules()
    check_mesh(cfg, mesh, rules)

    def step(params, batch):
        params = _on_mesh(params, mesh, "params")
        b, s = batch["tokens"].shape
        with CTX.use(mesh, rules.batch_axes, rules.tp_axis) as c:
            logits, caches = MDL.prefill_sharded(params, cfg, split_batch(batch, mesh, rules),
                                                 s + max(extra_len, 1), ctx=c, impl=impl)
            logits = _as_sharded(logits, _logits_layout(params, cfg, mesh, rules, c),
                                 (b, cfg.vocab_size))
        return logits, wrap_caches(caches, cfg, mesh, rules, s + max(extra_len, 1),
                                   params["layers"])

    return step


def _max_len(cfg: ModelConfig, caches: list) -> int | None:
    """The positions the sharded caches were made for: the most slots of an
    attention layer's cache (a linear one holds max_len; a ring min(W,
    max_len), which places its slot blocks alike), or None without
    attention."""
    caps = [(c["self"] if "self" in c else c)["k"].shape[_SLOT_DIM]
            for spec, c in zip(cfg.layers, caches) if spec.kind == ATTN]
    return max(caps) if caps else None


def make_decode_step(cfg: ModelConfig, *, impl="cuda", mesh=None,
                     rules: SH.ShardingRules | None = None):
    """(params, token (B,), caches, t) -> (logits, caches): one new token
    against a cache (the caches are updated in place).  With a ``mesh`` the
    caches and logits are ``make_prefill_step``'s sharded ones."""
    if mesh is None:
        def step(params, token, caches, t):
            return MDL.decode_step(params, cfg, token, caches, t, impl=impl)
        return step

    rules = rules or SH.ShardingRules()
    check_mesh(cfg, mesh, rules)

    def step(params, token, caches, t):
        params = _on_mesh(params, mesh, "params")
        with CTX.use(mesh, rules.batch_axes, rules.tp_axis) as c:
            tokens = {r: v["token"] for r, v in split_batch({"token": token}, mesh,
                                                            rules).items()}
            local = {r: tree_map(lambda st, r=r: st.blocks[r], caches) for r in mesh.device_ids}
            logits = MDL.decode_step_sharded(params, cfg, tokens, local, t,
                                             _max_len(cfg, caches), ctx=c, impl=impl)
            logits = _as_sharded(logits, _logits_layout(params, cfg, mesh, rules, c),
                                 (token.shape[0], cfg.vocab_size))
        return logits, caches

    return step


# ----------------------------------------------------------- dry-run wiring

def shardings_for_cell(cfg: ModelConfig, mesh, *, multi_pod: bool):
    rules = SH.ShardingRules(
        tp_axis="model", fsdp_axis="data", dp_axes=("data",),
        pod_axis="pod" if multi_pod else None)
    return rules


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """The decode caches' shapes and dtypes, as ``meta`` tensors: one
    {"k", "v"} (B, S_max or the window, Hkv, Dh) per layer, an
    encoder-decoder's {"self", "xkv"} over ``prefix_len`` frames (the JAX
    package's with each group's stack dim dropped)."""
    T.check_supported(cfg)
    cross = cfg.family == "encdec"
    return T.cache_init(cfg, batch, max_len, L.dtype_of(cfg), torch.device("meta"),
                        cross=cross, enc_len=cfg.prefix_len if cross else None)


def cache_partition_specs(cache_shapes, rules: SH.ShardingRules):
    """The JAX package's cache specs with the stack dim dropped: batch over
    (pod+)data, the last dim (head or state) over the tensor axis where 16
    divides it.  The port's sharded decode does not use them: its caches
    (``make_prefill_step``) hold attention k/v by KV head, ``P(batch, None,
    model, None)``, or, where the tensor axis does not divide the KV heads,
    every KV head for a ceil-sized block of the slots, ``P(batch, model,
    None, None)``, the same bytes per card as JAX's head_dim split to within
    a slot a rank, with the slots of a batch-1 cache also over the data axis
    by the JAX dry run's rule (``ctx.ShardingCtx.seq_axes``); the RG-LRU state by
    channel, "h" ``P(batch, model)`` and "conv" ``P(batch, None, model)``;
    the SSD state by head, "ssm" ``P(batch, model, None, None)``, with its
    conv state split into its x channels by head, "conv_x" ``P(batch,
    None, model)``, and its B and C channels on every rank, "conv_bc"
    ``P(batch, None, None)``; an encoder-decoder's "xkv" k/v by KV head,
    or replicated over the tensor axis where it does not divide them."""
    b = _batch_part(rules)

    def spec(x):
        if x.ndim >= 3:  # (B, S, H, D) kv or (B, H, P, N) ssm
            parts = [b] + [None] * (x.ndim - 2) + [rules.tp_axis]
            if x.shape[-1] % 16 != 0:
                parts[-1] = None
            return P(*parts)
        if x.ndim >= 1:
            return P(b, *([None] * (x.ndim - 1)))
        return P()

    return tree_map(spec, cache_shapes)
