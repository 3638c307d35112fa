#!/usr/bin/env python3
"""Break down the per-card peak of the dry run's cells that exceed a card.

    PYTHONPATH=src python scripts/dryrun_breakdown.py [--shape train_4k] [--mesh pod1] [--all]

Reads the cells' records under ``artifacts/dryrun_torch/`` (written by
``python -m repro_torch.launch.dryrun``) and prints, for each train cell
whose ``peak_per_device`` exceeds ``hbm_per_device`` (every train cell with
``--all``), in bytes per card:

- ``arguments``: the rank's blocks of the parameters, the AdamW state and
  the batch (the record's ``argument_bytes``);
- ``saved``: the layer inputs remat keeps for the backward, one (B_r, S, D)
  block a decoder layer (and an encoder layer's over its frames), from the
  shapes;
- ``head``: the LM head's working set, one chunk's forward and backward
  on one rank (``layers.lm_head_chunk``; the whole sequence where it is
  0): the logits over the rank's vocabulary block and the
  vocabulary-parallel logsumexp and gold (``layers.token_nll`` where the
  axis does not split the vocabulary);
- ``attention``: one attention layer's plain forward and backward on one
  rank (``ref.mha_ref`` at the rank's heads, the widest window): the
  reference tier's working set, which the card's ``flash_mha`` backward
  (autograd of ``mha_ref``) holds too;
- ``rest``: the peak less the arguments, the saved inputs and the larger
  of the head's and the attention's working sets (the two are live at
  different times of the backward).

Both working sets are the peak of the bytes live under ``dryrun.CostMode``
on ``meta`` for one rank: an op's outputs, not the temporaries inside one
op (logsumexp's).  The dry run's peak holds every rank's saved tensors
but one rank's transients spread over the ranks (``launch/dryrun.py``),
so where a head's backward is the card's peak, ``rest`` reads below zero
and the record understates the card: hence only the cells over a card by
default.  The figures are reckonings on the host, not device
measurements.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ATTN
from repro_torch.kernels import ref
from repro_torch.launch import dryrun as DRY
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.parallel import collectives as C


def attention_bytes(cfg, tp: int, rows: int, seq: int) -> int:
    """Peak live bytes of one attention layer's ``mha_ref`` forward and
    backward on one rank: its query and KV heads at ``tp``, ``rows`` x
    ``seq`` positions, the layers' widest window (None: causal over all)."""
    if not any(s.kind == ATTN for s in cfg.layers):
        return 0
    lcfg = T.tp_cfg(cfg, tp)
    windows = {s.window for s in cfg.layers if s.kind == ATTN}
    window = None if None in windows else max(windows)
    hq, hkv = lcfg.n_heads, lcfg.n_kv_heads
    if hq % hkv:  # every KV head on the rank, its query heads read their own
        hkv = max(1, hq * cfg.n_kv_heads // cfg.n_heads)
    dt, meta = L.dtype_of(cfg), torch.device("meta")
    q = torch.empty((rows, seq, hq, cfg.head_dim), dtype=dt, device=meta, requires_grad=True)
    k, v = (torch.empty((rows, seq, hkv, cfg.head_dim), dtype=dt, device=meta,
                        requires_grad=True) for _ in range(2))
    mode = DRY.CostMode()
    with mode:
        out = ref.mha_ref(q, k, v, causal=True, window=window)
        torch.autograd.grad(out.sum(), (q, k, v))
    return mode.peak


def head_bytes(cfg, tp: int, rows: int, seq: int) -> int:
    """Peak live bytes of one LM-head chunk's forward and backward on one
    rank: bf16 hidden rows x chunk against the rank's block of the tied or
    untied head, the fp32 logits, their logsumexp over the vocabulary
    (max, sum of exponentials, gold, as ``model.nll_sums_sharded``) and the
    masked sum."""
    split = tp > 1 and cfg.vocab_size % tp == 0
    vocab = cfg.vocab_size // tp if split else cfg.vocab_size
    dt, meta = L.dtype_of(cfg), torch.device("meta")
    chunk = L.lm_head_chunk(seq) or seq
    h = torch.empty((rows, chunk, cfg.d_model), dtype=dt, device=meta, requires_grad=True)
    w = torch.empty((vocab, cfg.d_model), dtype=dt, device=meta, requires_grad=True)
    y = torch.zeros((rows, chunk), dtype=torch.long, device=meta)
    mask = torch.empty((rows, chunk), dtype=torch.float32, device=meta)
    mode = DRY.CostMode()
    with mode:
        logits = torch.einsum("bsd,vd->bsv", h, w).to(torch.float32)
        if split:
            mx = logits.detach().amax(dim=-1)
            nll = (mx + torch.log(torch.exp(logits - mx[..., None]).sum(dim=-1))
                   - L.gather_vocab_shard(logits, y, 0))
        else:
            nll = L.token_nll(logits, y)
        torch.autograd.grad((nll * mask).sum(), (h, w))
    return mode.peak


def breakdown(rec: dict) -> dict:
    cell = rec["cell"]
    cfg, shape = get_config(cell["arch"]), SHAPES[cell["shape"]]
    mesh = make_production_mesh(cell["multi_pod"])
    tp = mesh.shape["model"]
    rows = shape.global_batch // C.axis_size(mesh, DRY.batch_axes(cell["multi_pod"]))
    bf = L.dtype_of(cfg).itemsize
    saved = cfg.num_layers * rows * shape.seq_len * cfg.d_model * bf
    if cfg.family == "encdec":
        saved += cfg.num_layers * rows * cfg.prefix_len * cfg.d_model * bf
    head = head_bytes(cfg, tp, rows, shape.seq_len)
    attn = attention_bytes(cfg, tp, rows, shape.seq_len)
    mem = rec["memory"]
    peak = mem["peak_per_device"]
    return {"cell": f"{cell['arch']} {cell['shape']} {'pod2' if cell['multi_pod'] else 'pod1'}",
            "peak": peak, "arguments": mem["argument_bytes"], "saved": saved,
            "rows": rows, "head": head, "attention": attn,
            "rest": peak - mem["argument_bytes"] - saved - max(head, attn)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", choices=["pod1", "pod2", "both"], default="both")
    ap.add_argument("--all", action="store_true", help="every cell, not only those over a card")
    args = ap.parse_args()
    pods = ["pod1", "pod2"] if args.mesh == "both" else [args.mesh]
    for path in sorted(pathlib.Path(DRY.ARTIFACTS).glob(f"*__{args.shape}__*.json")):
        rec = json.loads(path.read_text())
        key = path.stem.split("__")
        if rec.get("skipped") or key[2] not in pods or len(key) > 3:
            continue
        mem = rec["memory"]
        if not args.all and mem["peak_per_device"] <= mem["hbm_per_device"]:
            continue
        b = breakdown(rec)
        print(json.dumps({k: (round(v / 1e9, 3) if isinstance(v, (int, float))
                              and k != "rows" else v) for k, v in b.items()})
              + "  (GB per card)")


if __name__ == "__main__":
    main()
