"""``chip_smoke.py``'s phase 17 rehearsed on logical CPU devices at the
reduced size with ``impl="reference"``, in fp32: (a) a tensor axis that
splits the query heads (6 over 4 ranks; a gemma-like 2 over 4 past its
16-slot rings) served against one device with the collectives' bytes equal
to the phase's prediction (wq, wk, wv gathered per attention layer), and a
train step against one device; (b) the ZeRO-1 step bit-equal to the
equal-layout one; (c) the dry run's record of a train step on ``meta``
against the same step run: the collective records and the argument bytes
equal.  Planted faults show that the checks catch what they are for: every
rank's wo rows fed the first ranks' columns (a), the ZeRO-1 slices never
all-gathered (b).
"""

import os
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ATTN, LayerSpec
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")
SPLIT6 = dict(n_heads=6, n_kv_heads=2)
GEMMA2 = dict(n_heads=2, n_kv_heads=1, superblock=(LayerSpec(ATTN, 16), LayerSpec(ATTN, None)),
              n_superblocks=1, tail=(), num_layers=2)


@pytest.fixture(scope="module")
def cs():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def serve(cs, arch, kw, prompt_len=12, steps=3):
    cfg = get_config(arch).reduced(**kw)
    params = cs.make_dense_params(cfg, seed=0, device=CPU)
    return cfg, cs.phase_tp_serve(cfg, params, (1, 4), impl="reference", batch=4,
                                  prompt_len=prompt_len, steps=steps)


@pytest.mark.parametrize("arch,kw,prompt_len", [("qwen2-0.5b", SPLIT6, 12),
                                                ("gemma3-1b", GEMMA2, 20)])
def test_phase17a_split_head_serve_on_cpu(cs, arch, kw, prompt_len):
    cfg, r = serve(cs, arch, kw, prompt_len)
    assert TT.heads_split(cfg, 4)
    assert max(r["prefill_err"], r["decode_err"]) <= cs.FP32_LOGIT_TOL
    assert r["cache_err"] <= cs.FP32_LOGIT_TOL and r["argmax_agreement"] == 1.0
    assert r["prefill_bytes"] == cs.sharded_serve_bytes(cfg, 4, 4, prompt_len)
    assert r["decode_bytes"] == cs.sharded_serve_bytes(cfg, 4, 4, 1, decode=True)


def test_phase17a_split_head_train_on_cpu(cs):
    cfg = get_config("qwen2-0.5b").reduced(**SPLIT6)
    params = cs.make_params(cfg, seed=1, device=CPU)
    batch = cs.lm_batch(cfg, CPU, batch=4, prompt=8, new=8, seed=1)
    r = cs.phase_tp_train(cfg, params, batch, cs.SPLIT_LAYOUT, impl="reference")
    assert max(r["loss_err"], r["grad_norm_err"], r["global_err"],
               r["worst_leaf_err"]) <= cs.FP32_GRAD_TOL
    assert r["replicas_equal"] and r["finite"] and r["moved"]


def test_phase17a_catches_wo_rows_on_the_wrong_columns(cs, monkeypatch):
    cols = TT._out_cols
    monkeypatch.setattr(TT, "_out_cols", lambda cfg, ctx, r: (
        None if cols(cfg, ctx, r) is None else cols(cfg, ctx, ctx.ranks[0])))
    _, r = serve(cs, "qwen2-0.5b", SPLIT6, steps=1)
    assert r["prefill_err"] > cs.FP32_LOGIT_TOL


def zero1_case(cs):
    cfg = get_config("qwen2-0.5b").reduced()
    params = cs.make_params(cfg, seed=2, device=CPU)
    return cs.phase_zero1(cfg, params, cs.lm_batch(cfg, CPU, batch=4, prompt=8, new=8, seed=3),
                          impl="reference")


def test_phase17b_zero1_on_cpu(cs):
    r = zero1_case(cs)
    assert r["bit_equal"] and r["replicas_equal"]
    assert r["n_split"] > 0 and r["state_bytes"][0] < r["state_bytes"][1]


def test_phase17b_catches_slices_never_gathered(cs, monkeypatch):
    monkeypatch.setattr(adamw, "_gather_zero1", lambda p, slay: None)
    r = zero1_case(cs)
    assert not r["bit_equal"] and not r["replicas_equal"]


def test_phase17c_dry_run_against_the_run_on_cpu(cs):
    cfg = get_config("qwen2-0.5b").reduced()
    params = cs.make_params(cfg, seed=4, device=CPU)
    r = cs.phase_dry_check(cfg, params, cs.lm_batch(cfg, CPU, batch=8, prompt=8, new=8, seed=5),
                           impl="reference")
    assert r["dry_record"] == r["record"] and len(r["record"]) > 3
    assert r["memory"]["argument_bytes"] == r["argument_bytes"]
    assert r["rise"] is None and r["reckoned"] > 4 * r["argument_bytes"]


def test_phase17_full_size(cs):
    """The full configs split heads at the phase's degrees; the serve
    bytes predicted for qwen2-0.5b at TP 4 add per layer wq's and wk/wv's
    gathers (897 rows with the bias) to the three fp32 all-reduces."""
    q, g = get_config(cs.SPLIT), get_config(cs.GEMMA)
    assert TT.heads_split(q, cs.SPLIT_LAYOUT[1]) and TT.heads_split(g, cs.GEMMA_LAYOUT[1])
    for cfg, tp in ((q, cs.SPLIT_LAYOUT[1]), (g, cs.GEMMA_LAYOUT[1])):
        TT.check_sharded(cfg, tp)
    ar = 2 * 3
    act = 4 * 256 * 896 * 4
    gather = 4 * 3 * 897 * (896 + 2 * 128) // 4 * 2
    assert cs.sharded_serve_bytes(q, 4, 4, 256) == ar * 4 * 256 * 896 * 2 + 24 * (
        2 * ar * act + gather)
    assert cs.DRY_PEAK_BAND[0] < 1 < cs.DRY_PEAK_BAND[1]
    assert TM.init_params(cs.shallow(q, cs.DRY_LAYERS), device="meta")["layers"][0]["mixer"][
        "wq"]["w"].is_meta
