"""``chip_smoke.py``'s phase 11 (compute on sharded layouts) rehearsed on
logical CPU devices at the reduced size with ``impl="reference"``, in
fp32: (a) the sharded train step on (2, 2) against the single-device step,
(b) sharded prefill and decode on (1, 4), (c) the expert-parallel forward
on (1, 2), (d) the 4-stage pipeline, (e) ``compressed_psum`` on 4 ranks'
gradient trees held to its quantization bound.  Two planted faults show
that the checks catch what they are for: the attention all-reduce of one
layer dropped (a), the peers' scales swapped for the local ones (e).
"""

import os
import sys

import pytest
import torch

from repro_torch.models import model as TM
from repro_torch.parallel import collectives as C
from repro_torch.parallel import ctx as CTX

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def cs():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


CPU = torch.device("cpu")


def small_train(cs):
    cfg = cs.get_config("qwen2-0.5b").reduced()
    params = TM.init_params(cfg, seed=0, device="cpu")
    params["embed"]["table"].mul_(cs.EMBED_SCALE)
    return cfg, params, cs.lm_batch(cfg, CPU, batch=8, prompt=8, new=16)


def test_phase11a_train_on_cpu(cs):
    cfg, params, batch = small_train(cs)
    r = cs.phase_tp_train(cfg, params, batch, cs.TRAIN_LAYOUT, impl="reference")
    assert max(r["loss_err"], r["grad_norm_err"], r["global_err"],
               r["worst_leaf_err"]) <= cs.FP32_GRAD_TOL
    assert r["replicas_equal"] and r["finite"] and r["moved"]
    assert r["bytes"] > 0 and r["copies"] > 0
    want = cs.tp_train_predicted(cfg, cs.TRAIN_LAYOUT)
    assert want["flash_mha"] == 4 * cfg.num_layers * 2
    # the batch's replicas hold unequal mask counts
    half = batch["mask"].shape[0] // 2
    assert batch["mask"][:half].sum() != batch["mask"][half:].sum()


def test_phase11a_catches_a_dropped_all_reduce(cs, monkeypatch):
    """The attention output of the first layer not summed over the model
    axis (each rank keeps its own heads' share): FP32_GRAD_TOL fails."""
    cfg, params, batch = small_train(cs)
    calls = {"n": 0}
    reduce = CTX.ShardingCtx.tp_reduce

    def dropping(self, xs, op="sum"):
        calls["n"] += 1
        return xs if calls["n"] == 2 else reduce(self, xs, op)  # 1: the embedding
    monkeypatch.setattr(CTX.ShardingCtx, "tp_reduce", dropping)
    r = cs.phase_tp_train(cfg, params, batch, cs.TRAIN_LAYOUT, impl="reference")
    assert r["global_err"] > 100 * cs.FP32_GRAD_TOL


def test_phase11b_serve_on_cpu(cs):
    cfg = cs.get_config("llama-7b").reduced(n_heads=8, n_kv_heads=4)
    params = TM.init_params(cfg, seed=0, device="cpu")
    r = cs.phase_tp_serve(cfg, params, cs.GEN_LAYOUT, impl="reference", batch=2,
                          prompt_len=16, steps=3)
    assert r["prefill_err"] <= 1e-5 and r["decode_err"] <= 1e-5
    assert r["argmax_agreement"] == 1.0 and r["cache_diff"] <= 1e-5
    assert r["n_ranks"] == 4 and r["prefill_bytes"] > 0 and r["decode_bytes"] > 0


def test_phase11c_ep_on_cpu(cs):
    cfg = cs.get_config("granite-moe-1b-a400m").reduced()
    params = TM.init_params(cfg, seed=0, device="cpu")
    params["embed"]["table"].mul_(cs.EMBED_SCALE)
    r = cs.phase_ep(cfg, params, cs.EP_LAYOUT, impl="reference", batch=2, prompt_len=16)
    assert r["err"] <= 1e-5 and r["ranks_route_alike"]
    assert r["routes"]["agreement"] == 1.0
    with pytest.raises(ValueError, match="data size 1"):
        cs.phase_ep(cfg, params, (2, 2), impl="reference", batch=2, prompt_len=16)


def test_phase11d_pipeline_on_cpu(cs):
    cfg = cs.get_config("qwen2-0.5b").reduced(n_superblocks=8, num_layers=8)
    params = TM.init_params(cfg, seed=0, device="cpu")
    r = cs.phase_pipeline(cfg, params, impl="reference", batch=8, seq=16)
    assert r["bit_equal"] and r["ticks"] == cs.PIPE_MICRO + cs.PIPE_STAGES - 1


def test_phase11e_compressed_psum_on_cpu(cs):
    cfg = cs.get_config("qwen2-0.5b").reduced()
    params = TM.init_params(cfg, seed=0, device="cpu")
    grads = cs.rank_grads(cfg, params, 4, impl="reference", batch=2, seq=16)
    runs = cs.phase_compressed(grads, CPU)
    assert len(runs) == 3
    assert all(r["of_bound"] <= 1.0 and r["alike"] for r in runs)
    assert all(0 < r["rel_err"] < 0.1 for r in runs)
    n = sum(t.numel() for t in grads[0])
    assert runs[0]["bytes"] < 2 * 3 * 4 * n / 3  # int8: a third of an fp32 ring's bytes


def test_phase11e_catches_local_scales(cs, monkeypatch):
    """Every rank dequantizing its peers' chunks with its own scales (the
    scales' all_to_all skipped) breaks the quantization bound."""
    cfg = cs.get_config("qwen2-0.5b").reduced()
    params = TM.init_params(cfg, seed=0, device="cpu")
    grads = cs.rank_grads(cfg, params, 4, impl="reference", batch=2, seq=16)
    grads = [[g * (1 + r) for g in gs] for r, gs in enumerate(grads)]  # unequal scales
    all_to_all = C.all_to_all

    def local_scales(xs, mesh, axis, split_dim=0, concat_dim=0):
        if next(iter(xs.values())).dtype == torch.float32:
            return dict(xs)
        return all_to_all(xs, mesh, axis, split_dim, concat_dim)
    monkeypatch.setattr(C, "all_to_all", local_scales)
    assert max(r["of_bound"] for r in cs.phase_compressed(grads, CPU, steps=1)) > 1.0
