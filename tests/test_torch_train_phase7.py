"""A CPU rehearsal of ``chip_smoke.py``'s phase 7 through its own functions:
one padded PPO iteration of each reduced model the port serves (and a
packed one of the attention models), on the reference tier, as
``test_torch_train.py::test_chip_smoke_train_phase_on_cpu`` rehearses
phase 6.  Each run updates both trained models with finite stats, the
comparison of the tiers reads 0 (one tier here), the packed step equals
the padded one in fp32 (``FP32_GRAD_TOL``), and the ops calls that stand in
for kernel launches equal the prediction plus the comparisons' own train
forwards.
"""

import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs.base import ATTN, LRU, SSM
from repro_torch.kernels import ops

# the ops call that stands in for each kernel's launch on the reference tier
OPS_OF = {"flash_mha": "mha", "flash_mha_varlen": "varlen_mha", "flash_decode": "decode_mha",
          "grouped_ffn": "grouped_ffn", "ssd_scan": "ssd", "rglru_scan": "rglru_scan"}


@pytest.fixture(scope="module")
def chip_smoke():
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    return chip_smoke


def _forward_calls(cfg, packed):
    """Ops calls of one train forward and its recompute (remat) for the
    actor and the critic."""
    kinds = [s.kind for s in cfg.layers]
    out = {"varlen_mha" if packed else "mha": kinds.count(ATTN), "ssd": kinds.count(SSM),
           "rglru_scan": kinds.count(LRU),
           "grouped_ffn": sum(s.has_ffn for s in cfg.layers) if cfg.ffn_kind == "moe" else 0}
    return {k: 2 * 2 * v for k, v in out.items()}


@pytest.mark.parametrize("arch,packed", [("qwen2-0.5b", False), ("granite-moe-1b-a400m", True),
                                         ("granite-moe-1b-a400m", False),
                                         ("mamba2-1.3b", False), ("recurrentgemma-9b", False)])
def test_chip_smoke_phase7_on_cpu(chip_smoke, monkeypatch, arch, packed):
    cfg = chip_smoke.get_config(arch).reduced()
    exp = chip_smoke.train_experiment(batch=4, prompt_len=8, new=8, impl="reference",
                                      packed=packed)
    layouts = not packed and all(s.kind == ATTN for s in cfg.layers)
    calls = {name: 0 for name in OPS_OF.values()}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    for name in calls:
        monkeypatch.setattr(ops, name, count(name, getattr(ops, name)))
    tr = chip_smoke.phase_train(cfg, exp, "cpu", iters=1, min_valid=2, layouts=layouts)
    (r,) = tr["iters"]
    assert all(np.isfinite(v) for v in (*r["actor_stats"].values(), *r["critic_stats"].values()))
    for st in r["state"].values():
        assert st["finite"] and st["changed"] == st["leaves"]
    assert r["train_launches"] == {}  # no kernel on the reference tier
    assert r["padded_tokens"] == 4 * 16
    for c in (*tr["compare"].values(), *tr["compare_fp32"].values()):
        assert c["loss_err"] == c["grad_norm_err"] == c["worst_leaf_err"] == 0.0
        assert c["routes"] is None if cfg.ffn_kind != "moe" else c["routes"]["agreement"] == 1.0
    # the comparisons' train forwards: the tiers' (one run here) at full
    # and fp32 depth, and the packed and padded runs of the layouts' one
    small = chip_smoke.shallow(cfg, 2, dtype="float32")
    extra = Counter(_forward_calls(cfg, packed)) + Counter(_forward_calls(small, packed))
    if layouts:
        for c in tr["compare_layouts"].values():
            assert max(c["loss_err"], c["grad_norm_err"], c["global_err"],
                       c["worst_leaf_err"]) <= chip_smoke.FP32_GRAD_TOL
        extra += Counter(_forward_calls(small, True)) + Counter(_forward_calls(small, False))
    else:
        assert tr["compare_layouts"] is None
    train = tr["train_per_iter"]
    assert train == {k: v for k, v in {
        "flash_mha_varlen" if packed else "flash_mha": 2 * 2 * 2 * chip_smoke.attn_layers(cfg),
        "grouped_ffn": 2 * 2 * 2 * chip_smoke.moe_layers(cfg),
        **chip_smoke.scan_launches(cfg, 2 * 2 * 2)}.items() if v}
    want = Counter({OPS_OF[k]: v for k, v in tr["predicted"].items()}) + extra
    assert calls == {k: want[k] for k in calls}
