"""``chip_smoke.py``'s phase 15 (sharded compute of the recurrent mixers
and of the capacity dispatch) rehearsed on logical CPU devices at the
reduced size with ``impl="reference"``, in fp32: (a, b) reduced mamba2 and
recurrentgemma trained on (2, 2), the trained tree moved to (1, 4) by
``prefetch_reshard`` and served there (mamba2 at full depth behind the
trained layer) against one device, the collectives' bytes equal to the
phase's prediction from the shapes; (c) reduced Arctic's capacity
dispatch on (2, 2) with FSDP off, its router skewed so that expert 0
overflows.  Planted faults show that the checks catch what they are for:
a per-rank SSD norm (a, b) and per-rank capacity slots (c).
"""

import os
import sys

import pytest
import torch

from repro_torch.models import moe as TMOE
from repro_torch.models import ssm as TSSM

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cs():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def rec_case(cs, name):
    """(trained config, params of its layers, batch, rest): mamba2 trains
    its first layer and serves both (``rest``), recurrentgemma trains and
    serves RG-LRU, RG-LRU, local attention."""
    full = cs.get_config(name).reduced()
    n = 1 if name == "mamba2-1.3b" else 3
    cfg = cs.first_layers(full, n)
    params = cs.make_params(full, seed=0, device=CPU)
    rest = (full, params["layers"][n:]) if name == "mamba2-1.3b" else None
    params["layers"] = params["layers"][:n]
    return cfg, params, cs.lm_batch(cfg, CPU, batch=8, prompt=8, new=16), rest


@pytest.mark.parametrize("name", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_phase15ab_train_reshard_serve_on_cpu(cs, name):
    cfg, params, batch, rest = rec_case(cs, name)
    train, move, serve = cs.phase_rec_sharded(cfg, params, batch, impl="reference", rest=rest,
                                              steps=3, serve_batch=2, prompt_len=12)
    assert max(train["loss_err"], train["grad_norm_err"], train["global_err"],
               train["worst_leaf_err"]) <= cs.FP32_GRAD_TOL
    assert train["replicas_equal"] and train["finite"] and train["moved"]
    assert move["finite"] and move["n_moved"] > 0
    assert max(serve["prefill_err"], serve["decode_err"]) <= cs.FP32_LOGIT_TOL
    assert serve["cache_diff"] <= 1e-4 and serve["argmax_agreement"] == 1.0
    assert (serve["prefill_bytes"], serve["decode_bytes"]) == serve["predicted_bytes"]
    assert serve["n_ranks"] == 4
    want = cs.tp_train_predicted(cfg, cs.TRAIN_LAYOUT)
    key = "ssd_scan" if name == "mamba2-1.3b" else "rglru_scan"
    assert want[key] == 4 * sum(s.kind != "attn" for s in cfg.layers) * 2


def test_phase15a_catches_a_per_rank_norm(cs, monkeypatch):
    """The SSD layer's norm over each rank's slice alone: the trained step
    and the served logits part from one device past the fp32 limits."""
    from test_torch_tp_recurrent import per_rank_norm
    cfg, params, batch, rest = rec_case(cs, "mamba2-1.3b")
    monkeypatch.setattr(TSSM, "_norm_out", per_rank_norm)
    train, _, serve = cs.phase_rec_sharded(cfg, params, batch, impl="reference", rest=rest,
                                           steps=2, serve_batch=2, prompt_len=12)
    assert train["global_err"] > cs.FP32_GRAD_TOL
    assert serve["prefill_err"] > cs.FP32_LOGIT_TOL


def cap_case(cs):
    """Reduced Arctic (capacity dispatch, 1 layer) whose embedding rows all
    lean along one unit vector u and whose router column 0 is 8 u: almost
    every token picks expert 0, past its capacity."""
    cfg = cs.first_layers(cs.get_config(cs.ARCTIC).reduced(moe_dispatch="capacity"), 1)
    params = cs.make_dense_params(cfg, seed=0, device=CPU)
    u = torch.randn(cfg.d_model, generator=torch.Generator().manual_seed(0))
    u /= u.norm()
    params["embed"]["table"] += 0.5 * u
    params["layers"][0]["ffn"]["router"]["w"][:, 0] = 8.0 * u
    return cfg, params


def test_phase15c_capacity_on_cpu(cs):
    cfg, params = cap_case(cs)
    r = cs.phase_cap_sharded(cfg, params, cs.CAP_LAYOUT, impl="reference", batch=4,
                             prompt_len=16)
    assert r["dropped"][0] > 0 and r["sharded_dropped"] == r["dropped"]
    assert r["kept_agree"] == r["compared"] == 2 * 64 and r["ranks_route_alike"]
    assert r["routes"]["flips"] == 0 and r["tokens"] == 64
    assert r["err"] <= 1e-5 and r["alike"] == 64
    assert r["bytes"] == r["predicted_bytes"] > 0
    assert not params  # the dense tree went with its placement


def test_phase15c_catches_per_rank_capacity(cs, monkeypatch):
    """Each replica slots its assignments from 0: replica 1 keeps what the
    global cohort drops."""
    cfg, params = cap_case(cs)
    monkeypatch.setattr(TMOE, "_count_offsets",
                        lambda counts, ctx: {r: torch.zeros_like(n) for r, n in counts.items()})
    r = cs.phase_cap_sharded(cfg, params, cs.CAP_LAYOUT, impl="reference", batch=4,
                             prompt_len=16)
    assert r["kept_agree"] < r["compared"] == 2 * 64
    assert r["sharded_dropped"][0] < r["dropped"][0]


def test_kept_agreement_compares_up_to_each_experts_first_parting(cs):
    """Token 1's route parts on experts 0 and 2: expert 1's assignments
    are all compared, expert 0's and 2's only before token 1."""
    sets = torch.tensor([[0, 1], [1, 2], [0, 1], [1, 2]])
    ref = torch.tensor([[0, 1], [0, 1], [0, 1], [1, 2]])
    kept = torch.tensor([[0, 1], [1, 2], [-1, 1], [1, -1]])
    assert cs.kept_agreement(sets, ref, kept, kept.clone(), 3) == (1 + 4, 5)
    other = torch.tensor([[0, 1], [0, 1], [0, 1], [-1, 2]])
    assert cs.kept_agreement(sets, ref, kept, other, 3) == (5, 4)


def test_phase15_full_size(cs):
    """The full configs pass ``check_sharded`` at the phase's degrees; the
    fp32 recurrentgemma cut holds its local attention layer; the bytes
    predicted for the serve grow with the SSD's gathers and the replicated
    KV; the capacity of 4 x 256 tokens."""
    for name, layers, fp32_layers, _ in cs.REC_SHARDED:
        cfg = cs.get_config(name)
        for tp in (cs.TRAIN_LAYOUT[1], cs.GEN_LAYOUT[1]):
            cs.T.check_sharded(cfg, tp)
        assert cs.first_layers(cfg, layers).num_layers == layers
    rg = cs.first_layers(cs.get_config("recurrentgemma-9b"), 3, dtype="float32")
    assert [s.kind for s in rg.layers] == ["lru", "lru", "attn"] and rg.dtype == "float32"
    assert cs.T.kv_replicated(rg, 4) and rg.head_dim == 256
    arctic = cs.dataclasses.replace(cs.shallow(cs.get_config(cs.ARCTIC), 1),
                                    moe_dispatch="capacity")
    cs.T.check_sharded(arctic, cs.CAP_LAYOUT[1])
    assert cs.MOE.capacity(cs.CAP_TOKENS[0] * cs.CAP_TOKENS[1], arctic) == 20
    m = cs.get_config("mamba2-1.3b")
    # per SSD layer at 4 x 256: the fp32 shares, the in_proj gather (8,512
    # columns), the conv weights (5 x 4,352) and the sums of squares
    per_layer = (6 * 1024 * 2048 * 4 + 12 * 1024 * 8512 // 4 * 2 + 12 * 5 * 4352 // 4 * 2
                 + 6 * 1024 * 4)
    assert cs.sharded_serve_bytes(m, 4, 4, 256) == 6 * 1024 * 2048 * 2 + 48 * per_layer
