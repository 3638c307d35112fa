"""``chip_smoke.py``'s phase 12 rehearsed on the CPU at the reduced size
with ``impl="reference"``, in fp32: (a) each dense config's attention
layers against the plain transcription of the published layer, (c) DPO's
three steps on one preference batch, (d) a GRPO step on a sampled grouped
rollout with a value-head reward model, (e) a ReMax step on a sampled and a
greedy rollout; and the launch predictions at full size.  Planted faults
show that the checks catch what they are for: qk-norm applied after RoPE
and a key left out of the paged decode (a), the sample std in
``group_advantages`` (d).
"""

import math
import os
import sys

import pytest
import torch

from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.rlhf import grpo as TGRPO

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


def dense(cs, name, seed=0):
    cfg = cs.get_config(name).reduced()
    return cfg, cs.make_dense_params(cfg, seed=seed, device=CPU)


def qk_norm_after_rope(p, cfg, x, rope):
    """The planted fault: ``attention._project_qkv`` with qk-norm applied
    after RoPE."""
    b, s, _ = x.shape
    q = L.dense_apply(p["wq"], x).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = L.dense_apply(p["wk"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = L.dense_apply(p["wv"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q, k = L.rope_apply(q, rope), L.rope_apply(k, rope)
    if "q_norm" in p:
        q = L.rmsnorm_apply(p["q_norm"], q, cfg.norm_eps)
        k = L.rmsnorm_apply(p["k_norm"], k, cfg.norm_eps)
    return q, k, v


# ------------------------------------------------------------------ 12a

@pytest.mark.parametrize("name", ["qwen3-1.7b", "gemma3-1b", "qwen2.5-14b"])
def test_phase12a_layers_match_the_plain_transcription(cs, name):
    """Each attention kind's layer against ``plain_attention`` at S 40 (past
    reduced gemma3's window of 16); the fp32 slice of the tiers."""
    cfg, params = dense(cs, name)
    errs = cs.layer_check(cfg, params, impl="reference", seq=40)
    assert set(errs) == ({"local layer 0", "global layer 5"} if name == "gemma3-1b"
                         else {"global layer 0"})
    assert max(errs.values()) <= 1e-5
    sl = cs.phase_slice(cfg, params, impl="reference", batch=2, prompt_len=24, steps=3)
    assert sl["prefill_err"] == 0 and sl["decode_err"] == 0


@pytest.mark.parametrize("name", ["qwen3-1.7b", "gemma3-1b"])
def test_phase12a_catches_qk_norm_after_rope(cs, name, monkeypatch):
    """With every norm scale 1 qk-norm commutes with the rotation; the
    phase draws the scales (``randomize_dense``), so the order shows."""
    cfg, params = dense(cs, name)
    monkeypatch.setattr(ATT, "_project_qkv", qk_norm_after_rope)
    errs = cs.layer_check(cfg, params, impl="reference", seq=40)
    assert min(errs.values()) > 100 * cs.FP32_LOGIT_TOL
    raw = TM.init_params(cfg, seed=0, device="cpu")  # unit scales: the fault hides
    assert max(cs.layer_check(cfg, raw, impl="reference", seq=40).values()) <= 1e-5


@pytest.mark.parametrize("name", ["qwen3-1.7b", "gemma3-1b", "qwen2.5-14b"])
def test_phase12a_paged_slice_catches_a_key_left_out(cs, name, monkeypatch):
    """Phase 3's paged-vs-dense decode reads the same bits on one split
    grid; each row's own new key left out of the last global layer's
    paged decode (``cache_len`` one short) moves the logits off them."""
    cfg, params = dense(cs, name)
    sound = cs.phase_paged_slice(cfg, params, impl="reference", batch=2, prompt_len=40,
                                 steps=3)
    assert sound["same_grid"] and sound["paged_err"] == 0
    real, calls = ATT.paged_attn_decode_apply, [0]
    n_global = cs.attn_layers(cfg, local=False)

    def late(p, cfg, x, cache, block_table, dest, rope, cache_len, **kw):
        calls[0] += 1
        last = calls[0] % n_global == 0
        return real(p, cfg, x, cache, block_table, dest, rope,
                    cache_len - 1 if last else cache_len, **kw)
    monkeypatch.setattr(ATT, "paged_attn_decode_apply", late)
    fault = cs.phase_paged_slice(cfg, params, impl="reference", batch=2, prompt_len=40, steps=3)
    assert calls[0] == 3 * n_global and fault["paged_err"] > 1e-4


def test_phase12a_shallow_configs_keep_both_kinds(cs):
    g = cs.dense_shallow(cs.get_config("gemma3-1b"))
    assert [s.window for s in g.layers] == [512, None, 512, None] and g.dtype == "float32"
    q = cs.dense_shallow(cs.get_config("qwen2.5-14b"))
    assert q.num_layers == 4 and q.d_model == 5120


# ------------------------------------------------------------------ 12c

def test_phase12c_dpo_on_cpu(cs):
    cfg, params = dense(cs, "qwen3-1.7b")
    r = cs.phase_dpo(cfg, params, impl="reference", pairs=2, seq=16, gen_start=8)
    losses = [st["loss"] for st in r["steps"]]
    assert abs(losses[0] - math.log(2)) <= 1e-6 and r["steps"][0]["dpo_acc"] == 0.0
    assert all(b < a for a, b in zip(losses, losses[1:]))
    assert r["state"]["finite"] and r["state"]["changed"] == r["state"]["leaves"]
    assert r["predicted"] == {"flash_mha": cfg.num_layers * (2 + 4 * cs.DPO_STEPS)}
    cmp = cs.algo_tiers("dpo", cs.DPO.dpo_grads, cfg, params, r["hp"],
                        {"reference": r["batch"]}, 8, impl="reference")
    assert cmp["dpo"]["global_err"] == 0 and cmp["dpo"]["loss_err"] == 0


# ------------------------------------------------------------------ 12d, 12e

@pytest.fixture(scope="module")
def reward(cs):
    rcfg = cs.get_config(cs.REWARD).reduced()
    return rcfg, TM.init_params(rcfg, seed=3, device="cpu", head="value")


SHAPE = dict(prompt_len=8, new=6)


def rl_step(cs, kind, reward, group, prompts, compare=False):
    """``rl_batch`` then ``phase_rl`` at the reduced size; with ``compare``
    also the reference tier against itself on the batch, as the card runs
    the tiers between the two."""
    cfg, params = dense(cs, "qwen3-1.7b")
    batch = cs.rl_batch(kind, cfg, params, *reward, impl="reference", prompts=prompts,
                        group=group, **SHAPE)
    hp = cs.RL[kind][2](group)
    cmp = None
    if compare:
        cmp = cs.algo_tiers(kind, cs.RL[kind][0], cfg, params, hp, {"reference": batch},
                            SHAPE["prompt_len"], impl="reference",
                            adv_scale=cs.algo_scale(kind, hp, batch))[kind]
    r = cs.phase_rl(kind, cfg, params, batch, hp, SHAPE["prompt_len"], impl="reference")
    return batch, cmp, r


def test_phase12d_grpo_on_cpu(cs, reward):
    batch, cmp, r = rl_step(cs, "grpo", reward, group=4, prompts=2, compare=True)
    assert batch["tokens"].shape == (8, 14) and cmp["global_err"] == 0
    assert r["mean_err"] <= cs.ADV_MEAN_TOL and r["std_err"] <= cs.ADV_STD_TOL
    assert all(math.isfinite(v) for v in r["stats"].values())
    assert r["state"]["finite"] and r["state"]["changed"] > 0
    assert batch["rewards"].std() > 1e-3  # the groups have spread to whiten


def test_phase12d_catches_the_sample_std(cs, reward, monkeypatch):
    """torch.std's default (Bessel's correction) whitens each group of 4 to
    a population std of sqrt(3/4)."""
    def sample_std(rewards, group_size):
        r = rewards.reshape(-1, group_size)
        return ((r - r.mean(-1, keepdim=True)) / (r.std(-1, keepdim=True) + 1e-6)).reshape(-1)
    monkeypatch.setattr(TGRPO, "group_advantages", sample_std)
    _, _, r = rl_step(cs, "grpo", reward, group=4, prompts=2)
    assert r["std_err"] > 100 * cs.ADV_STD_TOL


def test_phase12e_remax_on_cpu(cs, reward):
    batch, cmp, r = rl_step(cs, "remax", reward, group=1, prompts=4, compare=True)
    assert cmp["global_err"] == 0
    assert all(math.isfinite(v) for v in r["stats"].values())
    assert r["state"]["finite"] and r["state"]["changed"] > 0
    assert batch["rewards"].mean() != batch["rewards_baseline"].mean()


def test_phase12_launch_predictions(cs):
    """At full size: qwen3-1.7b's 28 attention layers, the reward trunk's 24."""
    q, rcfg = cs.get_config("qwen3-1.7b"), cs.get_config(cs.REWARD)
    assert cs.dpo_predicted(q, 3) == {"flash_mha": 28 * 14}
    assert cs.dpo_predicted(cs.get_config("gemma3-1b"), 3) == {"flash_mha": 26 * 14}
    assert cs.rl_predicted("grpo", q, rcfg, 128) == {"flash_mha": 28 + 4 * 28 + 24,
                                                     "flash_decode": 28 * 127}
    assert cs.rl_predicted("remax", q, rcfg, 128) == {"flash_mha": 2 * 28 + 2 * 24 + 3 * 28,
                                                      "flash_decode": 2 * 28 * 127}
    g = cs.get_config("gemma3-1b")
    assert (cs.attn_layers(g, local=True), cs.attn_layers(g, local=False)) == (22, 4)
