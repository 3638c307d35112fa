"""``chip_smoke.py``'s phase 19 (packed training on sharded layouts)
rehearsed on logical CPU devices at the reduced size with
``impl="reference"``, in fp32: reduced qwen2-0.5b with 14 query heads on
(2, 2) and on (1, 4), where the heads split, and reduced granite's experts
over (1, 4), each packed step against the single-device one within
``FP32_GRAD_TOL`` through the phase's own report; the ops calls that stand
in for kernel launches equal the phase's prediction.  A planted fault, the
cohort cut evenly by tokens so that a sequence spans two replicas, must be
caught.  (Positions that run on across a replica's sequences are no such
fault: RoPE's scores depend on the distance within a sequence alone, and
the step reads the same within 1e-6.)  The full-size cohort and launch
predictions are checked against the arithmetic.
"""

import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data import packing
from repro_torch.kernels import ops

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")
COHORT = dict(seqs=6, min_len=4, max_len=12, bucket=16)
CASES = [("qwen2-0.5b", dict(n_heads=14), ((2, 2), (1, 4))),
         ("granite-moe-1b-a400m", {}, ((1, 4),))]


@pytest.fixture(scope="module")
def cs():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


@pytest.fixture
def counted(cs, monkeypatch):
    """The phase's launch counters read the ops calls that launch each
    kernel on the card (none launches on the reference tier)."""
    calls = dict.fromkeys(cs.launches(), 0)

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    for op, kernel in (("varlen_mha", "flash_mha_varlen"), ("grouped_ffn", "grouped_ffn")):
        monkeypatch.setattr(ops, op, count(kernel, getattr(ops, op)))
    monkeypatch.setattr(cs, "reset_launches", lambda: calls.update(dict.fromkeys(calls, 0)))
    monkeypatch.setattr(cs, "launches", lambda: dict(calls))
    return calls


def rehearse(cs, arch, kw, layouts, total):
    cfg = get_config(arch).reduced(**kw)
    params = cs.make_params(cfg, seed=0, device=CPU)
    batch = cs.packed_lm_batch(cfg, CPU, **COHORT)
    runs = cs.phase_packed_train(cfg, params, batch, layouts, impl="reference",
                                 max_seqlen=COHORT["max_len"])
    cs.report_packed("[packed]", cfg, runs, batch, cs.FP32_GRAD_TOL, cs.FP32_GRAD_TOL, total)
    return cfg, runs


@pytest.mark.parametrize("arch,kw,layouts", CASES)
def test_phase19_packed_train_on_cpu(cs, counted, arch, kw, layouts):
    total = dict.fromkeys(counted, 0)
    cfg, runs = rehearse(cs, arch, kw, layouts, total)
    want = cs.packed_train_predicted(cfg)
    for layout, r in runs.items():
        assert max(r["loss_err"], r["grad_norm_err"], r["global_err"], r["worst_leaf_err"]) <= 1e-5
        assert r["routes"] is None or r["routes"]["agreement"] == 1.0
        for k, v in cs.packed_train_predicted(cfg, layout).items():
            want[k] += v
    assert total == {k: want.get(k, 0) for k in total}
    assert total["flash_mha_varlen"] > 0 and (total["grouped_ffn"] > 0) == (arch != CASES[0][0])


def test_phase19_catches_a_sequence_cut_between_replicas(cs, counted, monkeypatch):
    """The cohort cut evenly by tokens, as the JAX package's batch layout
    cuts it (its partitioner carries attention across the cut; here the
    piece after the cut attends only itself)."""
    def even_cut(batch, n, **kw):
        t, cu = batch["tokens"].shape[-1], batch["cu_seqlens"].tolist()
        assert t // 2 not in cu  # the cut falls inside a sequence
        parts = []
        for lo, hi in ((0, t // 2), (t // 2, t)):
            ends = [c for c in cu if lo < c <= min(hi, cu[-1])]
            if min(hi, cu[-1]) > lo and min(hi, cu[-1]) not in ends:
                ends.append(min(hi, cu[-1]))
            part = {k: v[..., lo:hi] for k, v in batch.items() if k != "cu_seqlens"}
            part["cu_seqlens"] = torch.tensor([0] + [c - lo for c in ends], dtype=torch.int32)
            part["max_seqlen"] = hi - lo
            parts.append(part)
        return parts
    monkeypatch.setattr(packing, "split_packed", even_cut)
    with pytest.raises(SystemExit, match="disagrees with one device"):
        rehearse(cs, *CASES[0][:2], ((2, 2),), dict.fromkeys(counted, 0))


def test_replica_routes_join_the_replicas_in_cohort_order(cs):
    """On (2, 2) a layer's router calls come rank by rank in mesh order;
    tensor rank 0 of replica 0, then of replica 1, make one device's call."""
    def call(rows):
        return (torch.tensor(rows)[:, None], torch.tensor(rows, dtype=torch.float32))
    calls = [call([10 * layer + 3 * r, 10 * layer + 3 * r + 1]) for layer in range(2)
             for r in range(4)]
    got = cs.replica_routes(calls, (2, 2))
    assert len(got) == 2
    for layer, (experts, gaps) in enumerate(got):
        want = [10 * layer, 10 * layer + 1, 10 * layer + 6, 10 * layer + 7]
        assert experts[:, 0].tolist() == want and gaps.tolist() == want


def test_phase19_full_size(cs):
    """16 sequences of 64-384 tokens bucketed by 64; each replica's band
    within the cohort's; 24 layers x 4 ranks x 2 (remat) launches a step."""
    qwen, granite = cs.get_config(cs.PACKED), cs.shallow(cs.get_config(cs.PACKED_MOE),
                                                        cs.PACKED_MOE_LAYERS)
    batch = cs.packed_lm_batch(qwen, CPU, **cs.PACKED_COHORT)
    lens = np.diff(batch["cu_seqlens"].tolist())
    t = batch["tokens"].shape[0]
    assert len(lens) == 16 and lens.min() >= 64 and lens.max() <= 384
    assert t % 64 == 0 and 0 <= t - lens.sum() < 64
    assert batch["labels"].shape == batch["mask"].shape == (1, t)
    assert float(batch["mask"].sum()) == lens.sum() - 16
    for parts in (packing.split_packed(batch, 2), packing.split_packed(batch, 1)):
        assert all(p["max_seqlen"] <= cs.PACKED_COHORT["max_len"] for p in parts)
    assert cs.packed_train_predicted(qwen, (2, 2)) == {"flash_mha_varlen": 192,
                                                       "grouped_ffn": 0}
    assert cs.packed_train_predicted(granite, cs.PACKED_EP[0]) == {"flash_mha_varlen": 192,
                                                                   "grouped_ffn": 192}
