"""``chip_smoke.py``'s phase 13 rehearsed on the CPU at the reduced size
with ``impl="reference"``, in fp32: (a) seamless-m4t-medium's tiers and
the frames' reach, greedy ``generate`` against ``BucketedGenerator`` on
ragged requests, the train steps and the gradient tiers; (b)
internvl2-76b's tiers, the prefix's reach with the token ids under it
ignored, and the loss that keeps its bits when the labels under the prefix
change; the launch predictions and phase 2's shapes at full size.  Planted
faults show that the checks catch what they are for: a cross-attention
that returns nothing (the frames never reach the logits), a prefix splice
left out, a mask left at one over the prefix.
"""

import os
import sys

import pytest
import torch

from repro_torch.models import attention as ATT
from repro_torch.models import model as TM

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


def model(cs, name, seed=0):
    cfg = cs.get_config(name).reduced()
    return cfg, cs.make_dense_params(cfg, seed=seed, device=CPU)


# ------------------------------------------------------------------ 13a

def test_phase13a_slice_and_the_frames_reach(cs, monkeypatch):
    cfg, params = model(cs, cs.ENCDEC)
    assert len(params["encoder"]["layers"]) == cfg.num_layers
    batch = cs.modal_batch(cfg, CPU, batch=2, seq=12)
    assert batch["frames"].shape == (2, cfg.prefix_len, cfg.d_model)
    sl = cs.phase_modal_slice(cfg, params, batch, impl="reference", steps=3)
    assert sl["forward_err"] == sl["prefill_err"] == sl["decode_err"] == 0
    assert sl["argmax_agreement"] == 1.0 and sl["moved_by"] > cs.LOGIT_TOL
    assert "prefix_tokens_ignored" not in sl
    monkeypatch.setattr(ATT, "cross_attn_apply", lambda p, cfg, x, *a, **kw: torch.zeros_like(x))
    fault = cs.phase_modal_slice(cfg, params, batch, impl="reference", steps=3)
    assert fault["moved_by"] == 0


def test_phase13a_generate_and_bucketed(cs):
    """Ragged requests, the first of a bucket's length (128): bucketed
    equals generate there; every output in range."""
    cfg, params = model(cs, cs.ENCDEC)
    reqs = cs.encdec_requests(cfg, CPU, requests=3, min_prompt=5, max_prompt=20)
    assert [r["tokens"].shape[1] for r in reqs][0] == 128
    assert all(r["frames"].shape == (1, cfg.prefix_len, cfg.d_model) for r in reqs)
    runs = cs.phase_modal_generate(cfg, params, reqs, impl="reference", new=5)
    assert runs["same_at_bucket"] == [True]
    assert all(t.shape == (5,) for t in runs["generate"]["tokens"])
    # the reference tier launches no kernel; the prediction is the card's
    assert runs["generate"]["launches"]["flash_mha"] == 0
    n = cfg.num_layers
    assert runs["bucketed"]["predicted"] == {"flash_mha": 3 * (3 * n + 15 * n),
                                             "flash_decode": 3 * 15 * n}


def test_phase13a_train_and_gradient_tiers(cs):
    cfg, params = model(cs, cs.ENCDEC)
    batch = cs.modal_batch(cfg, CPU, batch=2, seq=8, train=True)
    assert torch.equal(batch["labels"][:, :-1], batch["tokens"][:, 1:])
    tr = cs.phase_modal_train(cfg, params, batch, impl="reference", steps=2)
    assert tr["finite"] and tr["moved"] == tr["leaves"] == len(cs.adamw.leaves(params))
    assert tr["params_moved"] == tr["leaves"]  # fp32: nothing rounds back
    assert all(m["loss"] > 0 for m in tr["steps"])
    assert tr["predicted"] == {"flash_mha": 2 * 2 * 3 * cfg.num_layers}
    gt = cs.grad_tiers(cfg, params, batch, impl="reference")
    assert gt["loss_err"] == gt["global_err"] == gt["worst_leaf_err"] == 0
    assert gt["n_leaves"] == tr["leaves"]


# ------------------------------------------------------------------ 13b

def test_phase13b_slice_and_the_prefix_reach(cs, monkeypatch):
    cfg, params = model(cs, cs.PREFIX)
    batch = cs.modal_batch(cfg, CPU, batch=2, seq=16)
    sl = cs.phase_modal_slice(cfg, params, batch, impl="reference", steps=3)
    assert sl["forward_err"] == sl["prefill_err"] == sl["decode_err"] == 0
    assert sl["moved_by"] > cs.LOGIT_TOL and sl["prefix_tokens_ignored"]
    monkeypatch.setattr(TM, "_embed_inputs", lambda p, cfg, b: TM._embed(p, cfg, b["tokens"]))
    fault = cs.phase_modal_slice(cfg, params, batch, impl="reference", steps=3)
    assert fault["moved_by"] == 0 and not fault["prefix_tokens_ignored"]


def test_phase13b_loss_keeps_its_bits_under_the_prefix(cs):
    cfg, params = model(cs, cs.PREFIX)
    batch = cs.modal_batch(cfg, CPU, batch=2, seq=16, seed=4, train=True)
    assert batch["mask"][:, :cfg.prefix_len].sum() == 0
    pl = cs.prefix_loss_check(cfg, params, batch, impl="reference")
    assert pl["grads_finite"] and pl["loss"] == pl["loss_moved"]
    assert all(not t.requires_grad for t in cs.adamw.leaves(params))
    ones = dict(batch, mask=torch.ones_like(batch["mask"]))
    fault = cs.prefix_loss_check(cfg, params, ones, impl="reference")
    assert fault["loss"] != fault["loss_moved"]


# ------------------------------------------------------------- full size

def test_phase13_full_size_shapes_and_predictions(cs):
    """The launch predictions at seamless's full depth, internvl2's
    8-layer cut (~18 GB in bf16), and phase 2's shapes read off the
    configs."""
    s = cs.get_config(cs.ENCDEC)
    assert cs.encdec_gen_predicted(s, 64) == {"flash_mha": 36 + 12 * 63,
                                              "flash_decode": 12 * 63}
    assert cs.modal_train_predicted(s, 3) == {"flash_mha": 216}
    v = cs.shallow(cs.get_config(cs.PREFIX), cs.PREFIX_LAYERS)
    assert v.num_layers == 8 and v.d_model == 8192
    assert 17 < 2 * v.param_count() / 1e9 < 19
    assert cs.PREFIX_SLICE["seq"] == 2 * cs.get_config(cs.PREFIX).prefix_len
    shapes = {key: rest for key, _, *rest in cs.MODAL_MHA}
    assert shapes["seamless_encoder"][1:] == [s.prefix_len, s.prefix_len, s.n_heads,
                                              s.n_kv_heads, s.head_dim, False]
    assert shapes["seamless_cross_prefill"][1:3] == [cs.ENCDEC_SLICE["seq"], s.prefix_len]
    assert shapes["seamless_cross_decode"][1:3] == [1, s.prefix_len]
    full = cs.get_config(cs.PREFIX)
    assert shapes["internvl2_prefill"][3:] == [full.n_heads, full.n_kv_heads, full.head_dim,
                                               True]
