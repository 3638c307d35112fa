"""``chip_smoke.py``'s phase 16 (sharded compute of the encoder-decoder and
prefix configs) rehearsed on logical CPU devices at the reduced size with
``impl="reference"``, in fp32: (a) reduced seamless-m4t-medium trained on
(2, 2), the trained tree moved to (1, 4) by ``prefetch_reshard`` and served
there (4 query heads over 2 KV heads: every rank gathers wk/wv and holds
every KV head at TP 4) against one device, the gathered caches, "xkv"
included, and the collectives' bytes equal to the phase's prediction from
the shapes; (b) reduced internvl2-76b served on (1, 4) and its loss with
the backward on (2, 2).  Planted faults show that the checks catch what
they are for: the sharded encoder run causal (a) and the prefix spliced
before the vocabulary-parallel sum (b).
"""

import os
import sys

import pytest
import torch

from repro_torch.models import model as TM
from repro_torch.models import transformer as TT

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


def encdec_runs(cs):
    cfg = cs.get_config(cs.ENCDEC).reduced()
    params = cs.make_dense_params(cfg, seed=0, device=CPU)
    batch = cs.modal_batch(cfg, CPU, train=True, seed=2, batch=2, seq=10)
    return cfg, cs.phase_rec_sharded(cfg, params, batch, impl="reference", steps=2,
                                     serve_batch=2, prompt_len=10)


def test_phase16a_train_reshard_serve_on_cpu(cs):
    cfg, (train, move, serve) = encdec_runs(cs)
    assert max(train["loss_err"], train["grad_norm_err"], train["global_err"],
               train["worst_leaf_err"]) <= cs.FP32_GRAD_TOL
    assert train["replicas_equal"] and train["finite"] and train["moved"]
    assert move["finite"] and move["n_moved"] > 0
    assert max(serve["prefill_err"], serve["decode_err"]) <= cs.FP32_LOGIT_TOL
    assert serve["cache_err"] <= cs.FP32_LOGIT_TOL and serve["argmax_agreement"] == 1.0
    assert (serve["prefill_bytes"], serve["decode_bytes"]) == serve["predicted_bytes"]
    assert cs.T.kv_replicated(cfg, 4)  # the cross wk/wv gathered in the prefill's bytes
    assert cs.tp_train_predicted(cfg, cs.TRAIN_LAYOUT)["flash_mha"] == 4 * 2 * 3 * 2
    pre, dec = cs.serve_predicted(cfg, 4, 2)
    assert pre["flash_mha"] == 4 * 3 * 2 and dec == {"flash_decode": 16, "flash_mha": 16}


def test_phase16a_catches_a_causal_encoder(cs, monkeypatch):
    stack = TT.stack_apply_sharded
    monkeypatch.setattr(TT, "stack_apply_sharded",
                        lambda *a, **kw: stack(*a, **dict(kw, causal=True)))
    _, (train, _, serve) = encdec_runs(cs)
    assert train["global_err"] > cs.FP32_GRAD_TOL
    assert serve["prefill_err"] > cs.FP32_LOGIT_TOL and serve["cache_err"] > cs.FP32_LOGIT_TOL


def prefix_case(cs):
    cfg = cs.get_config(cs.PREFIX).reduced()
    return cfg, cs.make_dense_params(cfg, seed=0, device=CPU)


def test_phase16b_serve_and_loss_on_cpu(cs):
    cfg, params = prefix_case(cs)
    r = cs.phase_tp_serve(cfg, params, cs.GEN_LAYOUT, impl="reference", batch=2,
                          prompt_len=12, steps=3)
    assert max(r["prefill_err"], r["decode_err"]) <= cs.FP32_LOGIT_TOL
    assert r["cache_err"] <= cs.FP32_LOGIT_TOL and r["argmax_agreement"] == 1.0
    assert r["prefill_bytes"] == cs.sharded_serve_bytes(cfg, 4, 2, 12)
    assert r["decode_bytes"] == cs.sharded_serve_bytes(cfg, 4, 2, 1, decode=True)
    batch = cs.modal_batch(cfg, CPU, train=True, seed=4, batch=2, seq=12)
    g = cs.phase_prefix_loss_sharded(cfg, params, batch, cs.TRAIN_LAYOUT, impl="reference")
    assert max(g["loss_err"], g["global_err"], g["worst_leaf_err"]) <= cs.FP32_GRAD_TOL
    assert g["loss"] == g["loss_moved"] and g["finite"] and g["replicas_equal"]
    assert g["n_leaves"] == len(cs.leaf_names(params)) and g["bytes"] > 0


def test_phase16b_catches_a_prefix_spliced_before_the_sum(cs, monkeypatch):
    from test_torch_tp_modal import splice_before_sum
    monkeypatch.setattr(TM, "_embed_inputs_sharded", splice_before_sum)
    cfg, params = prefix_case(cs)
    r = cs.phase_tp_serve(cfg, params, cs.GEN_LAYOUT, impl="reference", batch=2,
                          prompt_len=12, steps=1)
    assert r["prefill_err"] > cs.FP32_LOGIT_TOL
    batch = cs.modal_batch(cfg, CPU, train=True, seed=4, batch=2, seq=12)
    g = cs.phase_prefix_loss_sharded(cfg, params, batch, cs.TRAIN_LAYOUT, impl="reference")
    assert g["global_err"] > cs.FP32_GRAD_TOL


def test_phase16_full_size(cs):
    """The full configs pass ``check_sharded`` at the phase's degrees; the
    bytes predicted for the serves: seamless's vocabulary whole at TP 4, its
    encoder's two all-reduces per layer over 512 frames in the prefill and
    its decoder's three; internvl2's vocabulary split."""
    s = cs.get_config(cs.ENCDEC)
    v = cs.shallow(cs.get_config(cs.PREFIX), cs.PREFIX_LAYERS)
    for cfg in (s, v):
        for tp in (cs.TRAIN_LAYOUT[1], cs.GEN_LAYOUT[1]):
            cs.T.check_sharded(cfg, tp)
    assert v.num_layers == cs.PREFIX_LAYERS and cs.first_layers(v, 2).num_layers == 2
    ar = 2 * 3  # an all-reduce over 4 ranks moves each value 6 times
    assert cs.sharded_serve_bytes(s, 4, 4, 128) == ar * (12 * 3 * 4 * 128 * 1024 * 4
                                                         + 12 * 2 * 4 * 512 * 1024 * 4)
    assert cs.sharded_serve_bytes(s, 4, 4, 1, decode=True) == ar * 12 * 3 * 4 * 1024 * 4
    assert cs.sharded_serve_bytes(v, 4, 2, 512) == ar * (2 * 512 * 8192 * 2
                                                         + 8 * 2 * 2 * 512 * 8192 * 4)
    assert cs.sharded_serve_bytes(s, 2, 4, 1, decode=True) == 2 * (4 * 1024 * 2
                                                                  + 12 * 3 * 4 * 1024 * 4)
