"""``chip_smoke.py``'s phase 18 (decode caches split by slot) rehearsed on
logical CPU devices at the reduced size with ``impl="reference"``, in fp32:
(b) reduced internvl2-76b (2 query heads over 1 KV head, the 8-embedding
prefix) served on (1, 4) from a cache of 20 slots in blocks of 5, the
prompt of 13 on ranks 0-2 and none on rank 3, the 4 decode steps crossing
into rank 3's block; (c) the gemma-like 2-layer config on (1, 4) past its
16-slot ring.  The logits within ``SPLIT_FP32_TOL`` of one device, the
collectives' bytes, the launches and each rank's k/v bytes equal to the
phase's predictions from the shapes.  A planted fault, the ranks' partials
averaged without their log-sum-exp weights, must be caught; the full
configs' per-rank k/v bytes are checked against the arithmetic.
"""

import os
import sys

import pytest
import torch

from repro_torch.models import transformer as TT
from repro_torch.parallel import collectives as C
from test_torch_split_heads import GEMMA2

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")
LAYOUT = (1, 4)


@pytest.fixture(scope="module")
def cs():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def serve(cs, name, kw, prompt_len, extra_len, rows=2, steps=4):
    cfg = cs.get_config(name).reduced(**kw)
    params = cs.make_dense_params(cfg, seed=0, device=CPU)
    r = cs.phase_tp_serve(cfg, params, LAYOUT, impl="reference", batch=rows,
                          prompt_len=prompt_len, steps=steps, extra_len=extra_len)
    return cfg, r


@pytest.mark.parametrize("name,kw,prompt_len,extra_len", [
    ("internvl2-76b", dict(n_heads=2, n_kv_heads=1), 13, 7),
    ("gemma3-1b", GEMMA2, 19, 4)])
def test_phase18_split_serve_on_cpu(cs, name, kw, prompt_len, extra_len):
    cfg, r = serve(cs, name, kw, prompt_len, extra_len)
    assert TT.seq_split(cfg, 4)
    assert max(r["prefill_err"], r["decode_err"]) <= cs.SPLIT_FP32_TOL
    assert r["cache_err"] <= cs.SPLIT_FP32_TOL and r["argmax_agreement"] == 1.0
    assert r["prefill_bytes"] == cs.sharded_serve_bytes(cfg, 4, 2, prompt_len)
    assert r["decode_bytes"] == cs.sharded_serve_bytes(cfg, 4, 2, 1, decode=True)
    assert r["kv_bytes"] == cs.kv_cache_bytes(cfg, 4, 2, prompt_len + extra_len)
    whole = cs.kv_cache_bytes(cfg, 4, 2, prompt_len + extra_len, split=False)
    assert sum(whole) > 3 * sum(r["kv_bytes"])


def test_phase18_catches_partials_merged_without_their_weights(cs, monkeypatch):
    def mean(outs, lses, mesh, axis):
        total = C.all_reduce(outs, mesh, axis)
        return {rk: x / C.axis_size(mesh, axis) for rk, x in total.items()}
    monkeypatch.setattr(C, "lse_merge", mean)
    _, r = serve(cs, "internvl2-76b", dict(n_heads=2, n_kv_heads=1), 13, 7, steps=2)
    assert r["decode_err"] > cs.SPLIT_FP32_TOL


def test_phase18_full_size(cs):
    """internvl2-76b on 2 layers at 16 ranks, 2 rows of 1,024 slots: each
    rank 64 slots of all 8 KV heads of 128, k and v, bf16; gemma3-1b at 8
    ranks, 4 rows of 608 positions: 64 of each 512-slot ring and 76 of the
    global layers' 608; the fp32 configs the phase builds."""
    v = cs.shallow(cs.get_config(cs.SEQ_MODEL), cs.SEQ_LAYERS)
    assert v.num_layers == 2 and TT.seq_split(v, 16) and not TT.heads_split(v, 16)
    assert cs.kv_cache_bytes(v, 16, 2, cs.SEQ_SLOTS) == [2 * 2 * 2 * 64 * 8 * 128 * 2] * 16
    assert cs.kv_cache_bytes(v, 16, 2, cs.SEQ_SLOTS, split=False) == [
        16 * 2 * 2 * 2 * 64 * 8 * 128 * 2] * 16
    g = cs.get_config(cs.GEMMA)
    per_slot = 2 * 4 * 256 * 2
    want = [per_slot * (22 * 64 + 4 * (76 if i < 7 else 608 - 7 * 76)) for i in range(8)]
    assert cs.kv_cache_bytes(g, 8, 4, cs.GEMMA_PROMPT + cs.SEQ_STEPS) == want
    g32 = cs.seq_fp32(g, cs.GEMMA_SEQ_LAYERS)
    assert [s.window for s in g32.layers] == [512, None] and g32.dtype == "float32"
    assert cs.seq_fp32(v, cs.SEQ_LAYERS).num_layers == 2
    assert cs.SEQ_PROMPT < 10 * 64 < cs.SEQ_PROMPT + cs.SEQ_STEPS <= cs.SEQ_SLOTS
