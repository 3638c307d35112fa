"""Roofline terms of the dry run's cells on H100 clusters, the port's copy of
the JAX package's ``launch/roofline.py``.

Three terms per (arch x shape x mesh) cell, all per card:

  compute    = flops / peak bf16 FLOP/s
  memory     = bytes / HBM bandwidth
  collective = ring-model wire bytes of every collective / link bandwidth

``RooflineTerms``, ``model_flops``, ``_wire_bytes`` and ``CollectiveStats``
are the JAX file's, with ``hw.H100`` for the TPU chip.  The JAX package
reads its collectives from the compiled HLO text (``parse_collectives`` and
its helpers); the port has no HLO, so ``collective_stats`` builds the
stats from the record the port's collectives keep of every call
(``parallel/collectives.RECORD``: kind, full payload, group size, nodes a
group spans).  A group within one 8-card node rides NVLink
(``hw.H100.ici_link_bw``, 450 GB/s); a group that spans nodes rides the
nodes' network (``hw.H100.dcn_bw``, 50 GB/s per card), and
``link_weighted_wire_bytes`` scales its wire bytes by the ratio, so that
``RooflineTerms``' one link rate prices every collective at its own link.
"""

from __future__ import annotations

import dataclasses

from repro_torch import hw

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    bytes_by_kind: dict
    wire_bytes_by_kind: dict

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes_by_kind.values())


def _wire_bytes(kind: str, nbytes: float, k: int) -> float:
    """Per-device wire bytes under ring algorithms.  ``nbytes`` is the FULL
    (unsharded) payload of the collective."""
    if k <= 1:
        return 0.0
    if kind == "all-reduce":
        return hw.all_reduce_bytes(nbytes, k)
    if kind in ("all-gather", "reduce-scatter"):
        return hw.all_gather_bytes(nbytes, k)
    if kind == "all-to-all":
        return nbytes * (k - 1) / k
    return nbytes  # collective-permute: every byte crosses a link once


def collective_stats(record) -> CollectiveStats:
    """``CollectiveStats`` of a collective record: a mapping (kind, payload
    bytes, group size, nodes spanned) -> calls (``collectives.RECORD``, or
    a dry run's extrapolation of it)."""
    counts: dict = {}
    bytes_by: dict = {}
    wire_by: dict = {}
    for (kind, nbytes, k, _), n in record.items():
        counts[kind] = counts.get(kind, 0) + n
        bytes_by[kind] = bytes_by.get(kind, 0.0) + nbytes * n
        wire_by[kind] = wire_by.get(kind, 0.0) + _wire_bytes(kind, nbytes, k) * n
    return CollectiveStats(counts, bytes_by, wire_by)


def link_weighted_wire_bytes(record, chip: hw.ChipSpec = hw.H100) -> float:
    """The record's wire bytes with each call's scaled by ``ici_link_bw``
    over its link's rate (``dcn_bw`` where a group spans nodes): divided by
    ``ici_link_bw`` they give the collectives' seconds."""
    total = 0.0
    for (kind, nbytes, k, nodes), n in record.items():
        bw = chip.ici_link_bw if nodes <= 1 else chip.dcn_bw
        total += _wire_bytes(kind, nbytes, k) * n * chip.ici_link_bw / bw
    return total


# ------------------------------------------------------------------ terms

@dataclasses.dataclass
class RooflineTerms:
    flops: float            # per-device, trip-corrected
    hbm_bytes: float        # per-device, trip-corrected
    wire_bytes: float       # per-device collective wire traffic
    chip: hw.ChipSpec
    model_flops_total: float = 0.0
    n_chips: int = 1

    @property
    def compute_s(self) -> float:
        return self.flops / self.chip.peak_flops_bf16

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / self.chip.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.wire_bytes / self.chip.ici_link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        hlo_total = self.flops * self.n_chips
        return self.model_flops_total / hlo_total if hlo_total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the chip's peak the step achieves if it runs at the
        dominant-term time: useful_compute_time / bound_time."""
        useful_s = (self.model_flops_total / self.n_chips
                    / self.chip.peak_flops_bf16)
        return useful_s / self.bound_s if self.bound_s else 0.0

    def row(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_flops_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg, shape_kind: str, batch: int, seq_len: int) -> float:
    """MODEL_FLOPS: 6·N_active·D for train, 2·N_active·D for fwd-only; decode
    D = batch tokens (one step)."""
    n = cfg.active_param_count()
    if shape_kind == "train":
        return 6.0 * n * batch * seq_len
    if shape_kind == "prefill":
        return 2.0 * n * batch * seq_len
    return 2.0 * n * batch  # decode: one token per sequence
