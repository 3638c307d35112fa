"""The dry run on H100 clusters: every (arch x shape) cell of ``ASSIGNED`` x
``SHAPES`` on the single-pod (16, 16) and two-pod (2, 16, 16) production
meshes (``launch/mesh.make_production_mesh``, 256 and 512 cards), the port's
counterpart of the JAX package's ``launch/dryrun.py``.

JAX lowers and compiles each cell's jitted step and reads XLA's memory and
cost analyses and its HLO's collectives.  The port has no compiler: a cell
runs the port's own sharded train, prefill or decode step
(``parallel/steps.py``) at ``impl="reference"`` on ``meta`` tensors (shapes
and dtypes, no data), every rank of the mesh one after another, under
``CostMode``, which counts each aten op's flops (``FlopCounterMode``'s
formulas), the bytes of its inputs and outputs, and the bytes live.  The
collectives come from ``parallel/collectives.RECORD``.  Full depth comes
from runs at 1 and 2 superblocks, as the JAX probes correct XLA's
count-a-loop-once analysis: cost(n) = c1 + (n - 1)(c2 - c1) over
``ModelConfig.n_superblocks`` (the tail and the layers outside the stack
are in c1).  A cell's record is one JSON under ``artifacts/dryrun_torch/``
with the JAX artifact's fields, ``run_s`` in place of ``lower_s`` and
``compile_s``:

  * ``memory``: per card, ``argument_bytes`` (rank 0's blocks of params,
    optimizer state, batch and caches, exact from the layouts at full
    depth; the step counter is a Python int, 0 bytes), ``output_bytes``,
    ``alias_bytes`` (outputs written in place into arguments),
    ``temp_bytes`` (the rest of what the step holds at its peak: the bytes
    autograd saves for the backward and the transients, over the ranks),
    ``peak_per_device`` and ``hbm_per_device`` (``hw.H100``);
  * ``cost``: flops, and bytes as the sum of every op's input and output
    bytes (``bytes_unfused_*``: no fusion, so an upper bound on HBM
    traffic), raw (1 superblock) and corrected (full depth), per card;
  * ``collectives``, ``model_flops`` and the ``roofline`` row
    (``launch/roofline.py``), with each collective priced at its own link.

The live bytes are counted over all ranks (they run in one process): at the
peak every rank's saved activations are live but only one rank's
transients, so ``temp_bytes`` (the peak over the rank count) holds one
rank's transients spread over all.  The reference grouped FFN of a dropless
MoE cell reads its group sizes on the host; on ``meta`` it splits the rows
evenly over the experts (``kernels/ref.group_ends``), which counts the same
N rows of work.  Decode caches keep the port's layout: attention k/v by KV
head over the model axis, or, where the axis does not divide the KV heads,
every KV head for a ceil-sized block of the slots over it (the same bytes
per card as the JAX package's head_dim split, to within a slot a rank; the
ranks' partials merge by log-sum-exp, two all-reduces a layer in the
record); a batch-1 cache's slots also over the data axis where the JAX
rule splits them (16 divides the slots and there are at least 4,096);
recurrent states by channel or head.  The artifact names the layout and
its bytes per card.

    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k --mesh pod1
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import hw
from repro_torch.configs import ASSIGNED, SHAPES, cell_supported, get_config
from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as MDL
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.parallel import collectives as C
from repro_torch.parallel import ctx as CTX
from repro_torch.parallel import sharding as SH
from repro_torch.parallel import steps as ST
from repro_torch.parallel.layout import Layout, ShardedTensor, region_shape, tree_leaves, tree_map

ARTIFACTS = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
META = torch.device("meta")


def batch_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


@dataclasses.dataclass
class CellSpec:
    arch: str
    shape: str
    multi_pod: bool
    variant: str = "base"

    @property
    def key(self) -> str:
        pod = "pod2" if self.multi_pod else "pod1"
        v = "" if self.variant == "base" else f"__{self.variant}"
        return f"{self.arch}__{self.shape}__{pod}{v}"


# The JAX dry run's hill-climb variants: each changes one lever.
#   micro<k>    grad-accumulation microbatches
#   no_fsdp     params replicated over data
#   fsdp_model  no TP: params FSDP-sharded over the model axis, pure DP
#   dp_all      batch sharded over both axes, params replicated
#   dp_zero1    dp_all with the optimizer state ZeRO-1 over the data axis
VARIANTS = ("base", "micro4", "micro16", "micro32", "no_fsdp",
            "fsdp_model", "dp_all", "dp_zero1")


def _variant_setup(cell: CellSpec, mesh):
    """(the JAX rules (params, optimizer state), the batch axes, n_micro)."""
    pod = "pod" if cell.multi_pod else None
    v = cell.variant
    n_micro = {"micro4": 4, "micro16": 16, "micro32": 32}.get(v, 1)
    if v == "no_fsdp":
        rules = SH.ShardingRules(tp_axis="model", fsdp_axis=None, pod_axis=pod)
        batch_ax = batch_axes(cell.multi_pod)
    elif v == "fsdp_model":
        rules = SH.ShardingRules(tp_axis=None, fsdp_axis="model", pod_axis=pod)
        batch_ax = batch_axes(cell.multi_pod)
    elif v in ("dp_all", "dp_zero1"):
        rules = SH.ShardingRules(tp_axis=None, fsdp_axis=None, pod_axis=pod)
        batch_ax = (("pod",) if cell.multi_pod else ()) + ("data", "model")
    else:
        rules = SH.ShardingRules(pod_axis=pod)
        batch_ax = batch_axes(cell.multi_pod)
    return rules, batch_ax, n_micro


def _batch_axes_for(bsz: int, mesh, ax) -> tuple:
    """The JAX dry run's ``_batch_spec`` as axes: all of ``ax`` where they
    divide the batch, else the data axis where it does, else none."""
    if bsz % math.prod(mesh.shape[a] for a in ax) == 0:
        return tuple(ax)
    if bsz != 1 and bsz % mesh.shape["data"] == 0:
        return ("data",)
    return ()


def _step_rules(rules: SH.ShardingRules, b_axes: tuple) -> SH.ShardingRules:
    """``rules`` with batch axes ``b_axes`` (the port's steps read them
    from ``rules.batch_axes``)."""
    pod = "pod" if b_axes[:1] == ("pod",) else None
    return dataclasses.replace(rules, pod_axis=pod, dp_axes=tuple(a for a in b_axes if a != "pod"))


# ------------------------------------------------------------- cost mode

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(xs):
    """The tensors among ``xs`` and the lists and tuples in it."""
    for a in xs:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from (b for b in a if isinstance(b, torch.Tensor))


def _signature(func, args, kwargs):
    """A hashable key of an op on ``meta`` tensors: the op, each tensor's
    shape, stride, offset and dtype, every other argument; None where an
    argument is not on ``meta`` or not hashable."""
    def one(x):
        if isinstance(x, torch.Tensor):
            if not x.is_meta:
                raise TypeError
            return (tuple(x.shape), x.stride(), x.storage_offset(), x.dtype)
        if isinstance(x, (list, tuple)):
            return tuple(one(y) for y in x)
        hash(x)
        return x
    try:
        return (func, one(args), tuple((k, one(v)) for k, v in sorted(kwargs.items())))
    except TypeError:
        return None


class CostMode(TorchDispatchMode):
    """Counts every aten op run under it: ``flops`` by
    ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s, without
    its decomposition of unregistered ops, which the dispatcher has already
    decomposed), ``bytes`` as the op's tensor inputs and outputs (a view
    moves none), and the bytes ``live``: the storage of an output that
    aliases no input is counted from its op until the last tensor made
    under the mode that shares it (the output, or a view of it) is
    released, ``peak`` the most live at once.

    A ``meta`` op that aliases no input is a function of its inputs'
    metadata, and the ranks of a mesh repeat the same ops on the same
    shapes: its outputs' shapes, strides and dtypes and its flops are
    kept per signature (op, each tensor's shape, stride, offset and
    dtype, every other argument), and a repeat makes empty outputs of
    those instead of running the op's meta kernel again (most of them
    Python)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._refs = {}  # id(weakref) -> (weakref, storage key)
        self._storages = {}  # storage key -> [bytes, tensors alive]
        self._kind = {}  # op -> "view", "inplace" or "new"
        self._seen = {}  # signature -> (container, [(shape, stride, dtype)], flops)

    def _hold(self, t, key):
        ref = weakref.ref(t, self._free)
        self._refs[id(ref)] = (ref, key)
        self._storages[key][1] += 1

    def _free(self, ref):
        key = self._refs.pop(id(ref))[1]
        entry = self._storages[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def _kind_of(self, func):
        schema = func._schema
        aliases = any(r.alias_info is not None for r in schema.returns)
        return "new" if not aliases else ("inplace" if schema.is_mutable else "view")

    def _run(self, func, kind, args, kwargs):
        """(the op's output, its flops): a ``meta`` op that aliases no
        input from its signature's record where it has one."""
        sig = _signature(func, args, kwargs) if kind == "new" else None
        seen = self._seen.get(sig) if sig is not None else None
        if seen is not None:
            container, metas, flops = seen
            outs = [torch.empty_strided(sh, st, dtype=dt, device=META) for sh, st, dt in metas]
            return (outs[0] if container is None else container(outs)), flops
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        flops = (flop_registry[packet](*args, **kwargs, out_val=out)
                 if packet in flop_registry else 0)
        if sig is not None:
            many = isinstance(out, (list, tuple))
            outs = list(out) if many else [out]
            if all(isinstance(o, torch.Tensor) and o.is_meta for o in outs):
                self._seen[sig] = (type(out) if many else None,
                                   [(o.shape, o.stride(), o.dtype) for o in outs], flops)
        return out, flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = self._kind.get(func) or self._kind.setdefault(func, self._kind_of(func))
        out, flops = self._run(func, kind, args, kwargs)
        self.flops += flops
        outs = list(_tensors(out if isinstance(out, (list, tuple)) else (out,)))
        if kind == "view":
            for o in outs:  # a view keeps its base's storage alive
                key = o.untyped_storage()._cdata
                if key in self._storages:
                    self._hold(o, key)
            return out
        self.bytes += sum(_nbytes(a) for a in _tensors(args))
        self.bytes += sum(_nbytes(a) for a in _tensors(kwargs.values()))
        self.bytes += sum(_nbytes(o) for o in outs)
        if kind == "new":
            for o in outs:
                key = o.untyped_storage()._cdata
                if key not in self._storages:
                    n = o.untyped_storage().nbytes()
                    self._storages[key] = [n, 0]
                    self.live += n
                self._hold(o, key)
            self.peak = max(self.peak, self.live)
        return out


# ---------------------------------------------------------------- inputs

def depth(cfg: ModelConfig, n_superblocks: int) -> ModelConfig:
    """``cfg`` with ``n_superblocks`` superblocks (and its tail)."""
    return dataclasses.replace(cfg, n_superblocks=n_superblocks,
                               num_layers=n_superblocks * len(cfg.superblock) + len(cfg.tail))


def _meta_sharded(t, spec, mesh) -> ShardedTensor:
    lay = Layout(mesh, spec)
    return ShardedTensor(t.shape, t.dtype, lay,
                         {d: torch.empty(region_shape(reg), dtype=t.dtype, device=META)
                          for d, reg in lay.regions(t.shape)})


def meta_params(cfg: ModelConfig, mesh, rules: SH.ShardingRules):
    """The parameters as ``ShardedTensor``s of ``meta`` blocks on ``mesh``,
    laid out by ``rules`` (sanitized)."""
    shapes = MDL.init_params(cfg, device="meta")
    specs = SH.sanitize_specs(SH.param_specs(shapes, rules), shapes, mesh)
    return tree_map(lambda t, s: _meta_sharded(t, s, mesh), shapes, specs)


def input_specs(cfg: ModelConfig, seq_len: int, batch: int, kind: str) -> dict:
    """The JAX package's ``model.input_specs`` as ``meta`` tensors: int32
    tokens (and labels), an fp32 mask, an encoder-decoder's frames or a
    prefix model's embeddings in the config's dtype."""
    tok = torch.empty((batch, seq_len), dtype=torch.int32, device=META)
    specs = {"tokens": tok}
    if kind in ("train", "prefill") and cfg.prefix_len:
        name = "frames" if cfg.family == "encdec" else "prefix_embeds"
        specs[name] = torch.empty((batch, cfg.prefix_len, cfg.d_model), dtype=L.dtype_of(cfg),
                                  device=META)
    if kind == "train":
        specs["labels"] = torch.empty_like(tok)
        specs["mask"] = torch.empty((batch, seq_len), dtype=torch.float32, device=META)
    return specs


def meta_caches(cfg: ModelConfig, mesh, rules: SH.ShardingRules, batch: int, max_len: int, *,
                layers):
    """The sharded decode caches (``make_prefill_step``'s layout) as
    ``meta`` blocks: each rank's batch rows, its KV heads (every one for its
    block of the slots where the tensor axis does not divide them) or
    recurrent channels, every one where ``layers`` (the parameters' layer
    trees, ``meta_params``') leave a layer's mixer whole."""
    k = C.axis_size(mesh, rules.batch_axes) if rules.batch_axes else 1
    ctx = CTX.ShardingCtx(mesh, rules.batch_axes, rules.tp_axis)
    cross = cfg.family == "encdec"
    plans = T.layer_plans(layers, cfg, ctx)
    per = {r: T.cache_init_sharded(cfg, ctx, r, batch // k, max_len, L.dtype_of(cfg), META,
                                   plans=plans, cross=cross,
                                   enc_len=cfg.prefix_len if cross else None)
           for r in mesh.device_ids}
    return ST.wrap_caches(per, cfg, mesh, rules, max_len, layers)


def _rank_bytes(tree, rank) -> int:
    """Bytes of ``rank``'s blocks of the ``ShardedTensor`` leaves of
    ``tree`` (its whole tensors for the rest)."""
    return sum(_nbytes(x.blocks[rank]) if isinstance(x, ShardedTensor) else _nbytes(x)
               for x in tree_leaves(tree) if isinstance(x, (ShardedTensor, torch.Tensor)))


def cache_layout(cfg: ModelConfig, tp: int, caches: list) -> str:
    """The layout of the sharded decode ``caches`` in words."""
    kinds = {s.kind for s in cfg.layers}
    parts = []

    def split(kind):  # whether the model axis holds a share of these layers' caches
        return any("model" in str(st.layout.spec) for spec, c in zip(cfg.layers, caches)
                   if (spec.kind == ATTN) == (kind == ATTN)
                   for st in tree_leaves(c.get("self", c)))
    if ATTN in kinds:
        slot_axes = sorted({str(st.layout.spec[1]) for spec, c in zip(cfg.layers, caches)
                            if spec.kind == ATTN for st in tree_leaves(c.get("self", c))
                            if st.layout.spec[1]})
        heads = ("every KV head" if T.kv_replicated(cfg, tp) or not split(ATTN)
                 else "KV heads by the model axis")
        parts.append(f"attention k/v by slot over {' and '.join(slot_axes)} ({heads}; the "
                     "ranks' partials merged by log-sum-exp)" if slot_axes
                     else "attention k/v by KV head over the model axis" if split(ATTN)
                     else "attention k/v whole on every model rank")
    if kinds - {ATTN}:
        parts.append("recurrent states by channel or head over the model axis"
                     if split(None) else "recurrent states whole on every model rank")
    return "; ".join(parts) + "; batch rows over the batch axes"


# ------------------------------------------------------------- one run

def _setup(cfg, shape, mesh, rules, b_axes, *, zero1=None):
    """(the step's rules, params, optimizer state or None, the call's other
    arguments, their names): everything a cell's step takes, on ``meta``."""
    srules = _step_rules(rules, _batch_axes_for(shape.global_batch, mesh, b_axes))
    params = meta_params(cfg, mesh, rules)
    if shape.kind == "train":
        opt_cfg = adamw.AdamWConfig()
        olay = ST.opt_layouts(params, mesh, zero1 or rules,
                              pod_size=mesh.shape["data"] if zero1 else None)
        return srules, params, adamw.init(opt_cfg, params, olay), (
            input_specs(cfg, shape.seq_len, shape.global_batch, "train"),)
    if shape.kind == "prefill":
        return srules, params, None, (
            input_specs(cfg, shape.seq_len, shape.global_batch, "prefill"),)
    bsz = shape.global_batch
    return srules, params, None, (
        torch.empty((bsz,), dtype=torch.int32, device=META),
        meta_caches(cfg, mesh, srules, bsz, shape.seq_len + 1, layers=params["layers"]),
        shape.seq_len)


def _call(cfg, shape, mesh, srules, params, opt, args, n_micro):
    if shape.kind == "train":
        step = ST.make_train_step(cfg, adamw.AdamWConfig(), impl="reference", remat=True,
                                  n_micro=n_micro, mesh=mesh, rules=srules)
        return step(params, opt, *args)
    if shape.kind == "prefill":
        return ST.make_prefill_step(cfg, impl="reference", extra_len=1, mesh=mesh,
                                    rules=srules)(params, *args)
    return ST.make_decode_step(cfg, impl="reference", mesh=mesh, rules=srules)(params, *args)


def measure(cfg, shape, mesh, rules, b_axes, *, n_micro=1, zero1=None) -> dict:
    """One run of the cell's step at ``cfg``'s depth on ``meta``: flops,
    unfused bytes, the live peak (all over the ranks), the collective
    record, seconds."""
    srules, params, opt, args = _setup(cfg, shape, mesh, rules, b_axes, zero1=zero1)
    C.reset_stats()
    mode = CostMode()
    t0 = time.perf_counter()
    with mode:
        out = _call(cfg, shape, mesh, srules, params, opt, args, n_micro)
    seconds = time.perf_counter() - t0
    del out
    return {"flops": mode.flops, "bytes": mode.bytes, "peak_live": mode.peak,
            "record": dict(C.RECORD), "seconds": seconds}


def _extrapolate(r1: dict, r2: dict, n: int) -> dict:
    """c1 + (n - 1)(c2 - c1) of every count of two runs at 1 and 2
    superblocks, the collective record key by key."""
    def lin(a, b):
        return a + (n - 1) * (b - a)
    keys = set(r1["record"]) | set(r2["record"])
    record = {k: lin(r1["record"].get(k, 0), r2["record"].get(k, 0)) for k in keys}
    if any(v < 0 for v in record.values()):
        raise ValueError("a collective's count falls with depth")
    return {"flops": lin(r1["flops"], r2["flops"]), "bytes": lin(r1["bytes"], r2["bytes"]),
            "peak_live": lin(r1["peak_live"], r2["peak_live"]),
            "record": {k: v for k, v in record.items() if v}}


def memory_of(cfg, shape, mesh, rules, b_axes, peak_live: float, *, zero1=None) -> dict:
    """The per-card memory of the cell at ``cfg``'s depth (see the module
    docstring); ``peak_live`` the live peak over all ranks."""
    srules, params, opt, args = _setup(cfg, shape, mesh, rules, b_axes, zero1=zero1)
    r0, n = mesh.device_ids[0], mesh.size
    arg = _rank_bytes(params, r0) + _rank_bytes(opt, r0) + sum(
        _rank_bytes(a, r0) if not isinstance(a, dict) else sum(
            _nbytes(b) for b in ST.split_batch(a, mesh, srules)[r0].values())
        for a in args if not isinstance(a, int))
    tp = mesh.shape[srules.tp_axis] if srules.tp_axis else 1
    vocab = cfg.vocab_size // tp if cfg.vocab_size % tp == 0 and tp > 1 else cfg.vocab_size
    rows = shape.global_batch // (C.axis_size(mesh, srules.batch_axes) if srules.batch_axes
                                  else 1)
    logits = rows * vocab * 4
    if shape.kind == "train":
        alias = _rank_bytes(params, r0) + _rank_bytes(opt, r0)
        out = alias + 5 * 4  # the updated params and state, five fp32 metrics
    elif shape.kind == "prefill":
        caches = meta_caches(cfg, mesh, srules, shape.global_batch, shape.seq_len + 1,
                             layers=params["layers"])
        alias, out = 0, logits + _rank_bytes(caches, r0)
    else:
        alias = _rank_bytes(args[1], r0)
        out = logits + alias
    temp = max(0.0, peak_live / n - (out - alias))
    mem = {"argument_bytes": arg, "output_bytes": out, "temp_bytes": temp,
           "alias_bytes": alias, "peak_per_device": arg + out + temp - alias,
           "hbm_per_device": hw.H100.hbm_bytes}
    if shape.kind == "decode":
        mem["cache_layout"] = cache_layout(cfg, tp, args[1])
        mem["cache_bytes_per_device"] = _rank_bytes(args[1], r0)
    return mem


# ------------------------------------------------------------- cell runner

def run_cell(cell: CellSpec, *, n_micro: int = 1, with_probes: bool = True, save: bool = True,
             cfg: ModelConfig | None = None, shape=None, mesh=None) -> dict:
    """The cell's record (and its JSON under ``ARTIFACTS`` with ``save``,
    read back if there).  ``cfg``, ``shape`` and ``mesh`` override the
    cell's config, ``SHAPES`` entry and production mesh (reduced cells).
    Without ``with_probes`` the step runs once at full depth."""
    path = ARTIFACTS / f"{cell.key}.json"
    if save and path.exists():
        return json.loads(path.read_text())
    cfg = cfg or get_config(cell.arch)
    shape = shape or SHAPES[cell.shape]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        res = {"cell": dataclasses.asdict(cell), "skipped": True, "why": why}
        _save(res, path, save)
        return res
    mesh = mesh or make_production_mesh(cell.multi_pod)
    rules, b_axes, v_micro = _variant_setup(cell, mesh)
    n_micro = max(n_micro, v_micro)
    zero1 = (SH.ShardingRules(tp_axis=None, fsdp_axis=None, pod_axis="data")
             if cell.variant == "dp_zero1" else None)
    kw = dict(n_micro=n_micro, zero1=zero1)
    t0 = time.perf_counter()
    if with_probes and cfg.n_superblocks > 1:
        probes = [measure(depth(cfg, k), shape, mesh, rules, b_axes, **kw) for k in (1, 2)]
        full = _extrapolate(*probes, cfg.n_superblocks)
        raw = probes[0]
    else:
        full = raw = measure(cfg, shape, mesh, rules, b_axes, **kw)
        probes = [full]
    mem = memory_of(cfg, shape, mesh, rules, b_axes, full["peak_live"], zero1=zero1)
    run_s = time.perf_counter() - t0

    n = mesh.size
    flops, bytes_ = full["flops"] / n, full["bytes"] / n
    colls = RL.collective_stats(full["record"])
    mf = RL.model_flops(cfg, shape.kind, shape.global_batch, shape.seq_len)
    weighted = RL.link_weighted_wire_bytes(full["record"])
    terms = RL.RooflineTerms(flops, bytes_, weighted, hw.H100, model_flops_total=mf, n_chips=n)
    res = {
        "cell": dataclasses.asdict(cell),
        "skipped": False,
        "n_chips": n,
        "run_s": round(run_s, 2),
        "memory": mem,
        "cost": {"flops_raw": raw["flops"] / n, "bytes_unfused_raw": raw["bytes"] / n,
                 "flops_corrected": flops, "bytes_unfused_corrected": bytes_,
                 "bytes": "unfused: every op's tensor inputs and outputs, per card"},
        "collectives": {
            "counts": colls.counts,
            "bytes_by_kind": colls.bytes_by_kind,
            "wire_bytes_by_kind": colls.wire_bytes_by_kind,
            "total_wire_bytes": colls.total_wire_bytes,
            "link_weighted_wire_bytes": weighted,
            "record": [[*k, v] for k, v in sorted(full["record"].items())],
        },
        "probes": [{"superblocks": i + 1, "flops": p["flops"] / n, "bytes": p["bytes"] / n,
                    "seconds": round(p["seconds"], 2)} for i, p in enumerate(probes)],
        "model_flops": mf,
        "roofline": terms.row(),
        "terms": {"flops_per_dev": flops, "hbm_bytes_per_dev": bytes_,
                  "wire_bytes_per_dev": colls.total_wire_bytes},
        "notes": {"impl": "reference, on meta",
                  "grouped_ffn": "dropless MoE rows split evenly over the experts on meta"
                  if cfg.ffn_kind == "moe" else None,
                  "collective_links": f"a group within {C.NODE_CARDS} cards at "
                                      f"{hw.H100.ici_link_bw:.3g} B/s, across nodes at "
                                      f"{hw.H100.dcn_bw:.3g} B/s"},
    }
    if shape.name == "long_500k":
        res["notes"]["jax_cache_layout"] = (
            "batch 1: the JAX rule puts a cache's sequence over the data axis where 16 "
            "divides its slots and there are at least 4,096; the port mirrors it "
            "(memory.cache_layout), and at seq_len + 1 slots it does not fire")
    _save(res, path, save)
    return res


def _save(res, path, save):
    if save:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(res, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod1", "pod2", "both"], default="both")
    ap.add_argument("--variant", default="base", choices=VARIANTS)
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ASSIGNED
    shapes = [args.shape] if args.shape else list(SHAPES)
    pods = {"pod1": [False], "pod2": [True], "both": [False, True]}[args.mesh]

    failures = []
    for arch in archs:
        for shp in shapes:
            for mp in pods:
                cell = CellSpec(arch, shp, mp, args.variant)
                if args.force:
                    (ARTIFACTS / f"{cell.key}.json").unlink(missing_ok=True)
                try:
                    t0 = time.time()
                    res = run_cell(cell, n_micro=args.micro, with_probes=not args.no_probes)
                    if res.get("skipped"):
                        print(f"SKIP {cell.key}: {res['why']}")
                        continue
                    r = res["roofline"]
                    mem = res["memory"]["peak_per_device"] / 2**30
                    print(f"OK   {cell.key}: run={res['run_s']:.0f}s "
                          f"mem/dev={mem:.2f}GiB dominant={r['dominant']} "
                          f"[comp={r['compute_s']*1e3:.1f}ms "
                          f"mem={r['memory_s']*1e3:.1f}ms "
                          f"coll={r['collective_s']*1e3:.1f}ms] "
                          f"roofline={r['roofline_fraction']:.2%} "
                          f"({time.time()-t0:.0f}s)", flush=True)
                except Exception as e:  # noqa: BLE001
                    failures.append((cell.key, repr(e)))
                    print(f"FAIL {cell.key}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: "
                         + ", ".join(k for k, _ in failures))
    print("all requested cells passed")


if __name__ == "__main__":
    main()
