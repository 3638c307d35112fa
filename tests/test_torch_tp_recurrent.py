"""The sharded steps of the recurrent mixers and of attention with KV heads
replicated over the tensor axis (``parallel/steps.py`` with a mesh) on
logical CPU meshes: reduced mamba2-1.3b (SSD: its 296 ``in_proj`` columns
and 160 conv channels split across head boundaries at TP 2 and 4) and
reduced recurrentgemma-9b (RG-LRU and local attention with one KV head).

One JAX subprocess (4 forced host devices) runs the JAX package's train
step of both models under ``jit`` with ``in_shardings`` on a (2, 2)
("data", "model") mesh, as ``tests/test_torch_tp_step.py`` does for qwen;
the port's explicit-SPMD step on the same params and batch is held at
``tests/test_multidevice.py``'s tolerance (loss 1e-3; leaves atol 5e-3,
rtol 1e-2).  Against the port's single-device steps in fp32: the train
step at ``test_torch_tp_step.assert_close_runs``' 1e-5, prefill and decode
logits at 1e-5 of their largest magnitude with equal greedy tokens, the
gathered caches at 1e-5 (``test_torch_tp_serve``'s limits), on (2, 2),
(1, 2) and (1, 4).  Replicas stay bit-equal after two steps.  A per-rank
norm in the SSD layer (no all-reduce of the sum of squares over the inner
width) is a planted fault the checks must catch.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.base import ATTN, LayerSpec
from repro_torch.models import model as TM
from repro_torch.models import ssm as TSSM
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw
from repro_torch.parallel import ctx as CTX
from repro_torch.parallel import steps
from repro_torch.parallel.layout import P, tree_leaves
from test_torch_tp_step import (FLATTEN, assert_close_runs, cpu_mesh, place, replicas_bit_equal,
                                run_jax, sharded_step, single_step, unflatten)

ARCHS = ("mamba2-1.3b", "recurrentgemma-9b")
SHAPES = ((2, 2), (1, 2), (1, 4))
SEQ = 20  # past recurrentgemma's reduced window of 16; pads mamba2's chunks of 8
TOL = 1e-5
# recurrentgemma on one superblock and its tail: RG-LRU, RG-LRU, local
# attention, RG-LRU, RG-LRU
RG_SMALL = {"n_superblocks": 1, "num_layers": 5}

JAX_STEPS = FLATTEN + '''
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCHS
from repro.models import init_params, synth_batch
from repro.optim import adamw
from repro.parallel import sharding as SH
from repro.parallel.compat import auto_axis_types, make_mesh
from repro.parallel.steps import make_train_step

mesh = make_mesh((2, 2), ("data", "model"), axis_types=auto_axis_types(2))
rules = SH.ShardingRules()
out = {}
for arch, kw in (("mamba2-1.3b", {}), ("recurrentgemma-9b", %r)):
    cfg = ARCHS[arch].reduced(**kw)
    p = init_params(jax.random.PRNGKey(0), cfg)
    p["embed"]["table"] = p["embed"]["table"] * 0.05
    opt_cfg = adamw.AdamWConfig(lr=1e-3)
    opt = adamw.init(opt_cfg, p)
    batch = synth_batch(jax.random.PRNGKey(1), cfg, %d, 4, "train")
    psh = jax.tree.map(lambda s: NamedSharding(mesh, s), SH.param_specs(p, rules))
    osh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                       SH.opt_state_specs(SH.param_specs(p, rules), rules))
    bsh = jax.tree.map(lambda x: NamedSharding(mesh, P("data", *([None] * (x.ndim - 1)))),
                       batch)
    p2, o2, m2 = jax.jit(make_train_step(cfg, opt_cfg), in_shardings=(psh, osh, bsh))(
        jax.device_put(p, psh), jax.device_put(opt, osh), jax.device_put(batch, bsh))
    flatten(jax.tree.map(np.asarray, p), arch + "/before", out)
    flatten(jax.tree.map(np.asarray, p2), arch + "/after", out)
    flatten(jax.tree.map(np.asarray, batch), arch + "/batch", out)
    out[arch + "/loss"] = np.asarray(m2["loss"])
    out[arch + "/grad_norm"] = np.asarray(m2["grad_norm"])
np.savez("{out}", **out)
''' % (RG_SMALL, SEQ)


def reduced(arch):
    return get_config(arch).reduced(**(RG_SMALL if arch == "recurrentgemma-9b" else {}))


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    return run_jax(JAX_STEPS, str(tmp_path_factory.mktemp("jax") / "steps.npz"))


def model(arch, seed=0):
    cfg = reduced(arch)
    params = TM.init_params(cfg, seed=seed, device="cpu")
    params["embed"]["table"].mul_(0.05)
    return cfg, params


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_jax_sharded_step(jax_steps, arch):
    cfg = reduced(arch)
    params = params_from_jax(unflatten(jax_steps, arch + "/before"), cfg, device="cpu")
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in unflatten(jax_steps, arch + "/batch").items()}
    batch["tokens"], batch["labels"] = batch["tokens"].long(), batch["labels"].long()
    p2, o2, m2 = sharded_step(cfg, params, batch, adamw.AdamWConfig(lr=1e-3), cpu_mesh((2, 2)))
    assert abs(float(m2["loss"]) - float(jax_steps[arch + "/loss"])) < 1e-3
    np.testing.assert_allclose(float(m2["grad_norm"]), float(jax_steps[arch + "/grad_norm"]),
                               rtol=1e-3)
    want = params_from_jax(unflatten(jax_steps, arch + "/after"), cfg, device="cpu")
    got, want = tree_leaves(p2), tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.gather().detach().numpy(), b.numpy(), atol=5e-3, rtol=1e-2)
    assert replicas_bit_equal(p2) and replicas_bit_equal(o2["m"])


def train_case(arch, seed=0):
    cfg, params = model(arch, seed)
    batch = TM.synth_batch(seed + 1, cfg, SEQ, 4, device="cpu")
    batch["mask"][0, 5:] = 0.0
    batch["mask"][3, :3] = 0.0
    return cfg, params, batch


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_single_device_fp32(arch, shape):
    cfg, params, batch = train_case(arch)
    opt = adamw.AdamWConfig(lr=1e-6)
    assert_close_runs(single_step(cfg, params, batch, opt),
                      sharded_step(cfg, params, batch, opt, cpu_mesh(shape)))


def serve_runs(cfg, params, mesh, *, batch=4, prompt_len=SEQ, new=5, seed=0):
    """The single-device and the sharded prefill then ``new - 1`` decode
    steps, both fed the single-device greedy tokens: [(logits, sharded
    logits, caches, sharded caches)] per call."""
    sp = place(params, mesh)
    prompt = TM.synth_batch(seed + 1, cfg, prompt_len, batch, "prefill", device="cpu")
    lg1, c1 = steps.make_prefill_step(cfg, impl="reference", extra_len=new)(params, prompt)
    lg2, c2 = steps.make_prefill_step(cfg, impl="reference", extra_len=new, mesh=mesh)(
        sp, prompt)
    out = [(lg1, lg2, c1, c2)]
    d1 = steps.make_decode_step(cfg, impl="reference")
    d2 = steps.make_decode_step(cfg, impl="reference", mesh=mesh)
    for t in range(prompt_len, prompt_len + new - 1):
        tok = lg1.argmax(-1)
        lg1, c1 = d1(params, tok, c1, t)
        lg2, c2 = d2(sp, tok, c2, t)
        out.append((lg1, lg2, c1, c2))
    return out


def assert_serve_step(lg1, lg2, c1, c2):
    scale = float(lg1.abs().max())
    assert float((lg2.gather() - lg1).abs().max()) <= TOL * scale
    assert torch.equal(lg2.gather().argmax(-1), lg1.argmax(-1))
    got = steps.gathered_caches(c2)
    assert len(got) == len(c1)
    for a, b in zip(c1, got):
        assert sorted(a) == sorted(b)
        for k in a:
            assert b[k].shape == a[k].shape and b[k].dtype == a[k].dtype
            np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_single_device(arch, shape):
    cfg, params = model(arch)
    mesh = cpu_mesh(shape)
    runs = serve_runs(cfg, params, mesh)
    for run in runs:
        assert_serve_step(*run)
    tp = shape[1]
    for spec, layer in zip(cfg.layers, runs[-1][3]):
        specs = {k: st.layout.spec for k, st in layer.items()}
        if spec.kind == ATTN:  # one KV head: its slots split over the model axis at every TP
            slot = P("data", "model" if tp > 1 else None, None, None)
            assert specs == {"k": slot, "v": slot}
            assert layer["k"].blocks[mesh.device_ids[-1]].shape[2] == 1
            assert layer["k"].blocks[0].shape[1] == -(-layer["k"].shape[1] // tp)
        elif "h" in layer:
            assert specs == {"h": P("data", "model"), "conv": P("data", None, "model")}
            assert layer["h"].blocks[0].shape[1] == cfg.lru_width // tp
        else:
            assert specs == {"ssm": P("data", "model", None, None),
                             "conv_x": P("data", None, "model"),
                             "conv_bc": P("data", None, None)}
            assert layer["ssm"].blocks[0].shape[1] == cfg.ssm_heads // tp


@pytest.mark.parametrize("arch,kw", [("gemma3-1b", {}), ("qwen2-0.5b", {}),
                                     ("qwen2-0.5b", dict(n_heads=8, n_kv_heads=2))])
def test_kv_heads_replicated_at_tp4(arch, kw):
    """TP 4 over fewer KV heads: gemma3 (4 query heads, 1 KV head), qwen
    (4 / 2: a rank's one query head in one group; 8 / 2: two heads in one
    group), train and serve against one device, the KV caches holding every
    KV head for a block of the slots over the model axis."""
    cfg = get_config(arch).reduced(**kw)
    assert cfg.n_kv_heads % 4 and TT.kv_replicated(cfg, 4)
    params = TM.init_params(cfg, seed=0, device="cpu")
    params["embed"]["table"].mul_(0.05)
    mesh = cpu_mesh((1, 4))
    runs = serve_runs(cfg, params, mesh, prompt_len=12, new=3)
    for run in runs:
        assert_serve_step(*run)
    assert all(st.layout.spec == P("data", "model", None, None) and
               st.blocks[3].shape[2] == cfg.n_kv_heads
               and st.blocks[0].shape[1] == -(-st.shape[1] // 4)
               for layer in runs[-1][3] for st in layer.values())
    batch = TM.synth_batch(1, cfg, 12, 4, device="cpu")
    opt = adamw.AdamWConfig(lr=1e-6)
    assert_close_runs(single_step(cfg, params, batch, opt),
                      sharded_step(cfg, params, batch, opt, mesh))


@pytest.mark.parametrize("arch", ARCHS)
def test_two_steps_keep_replicas_bit_equal(arch):
    cfg, params = model(arch, seed=3)
    mesh = cpu_mesh((2, 2))
    opt = adamw.AdamWConfig(lr=1e-3)
    sp = place(params, mesh)
    state = adamw.init(opt, sp)
    step = steps.make_train_step(cfg, opt, impl="reference", mesh=mesh)
    for seed in (1, 2):
        sp, state, _ = step(sp, state, TM.synth_batch(seed, cfg, SEQ, 4, device="cpu"))
        assert replicas_bit_equal(sp) and replicas_bit_equal(state["m"])
        assert replicas_bit_equal(state["v"]) and replicas_bit_equal(state["master"])
    assert state["step"] == 2


def per_rank_norm(ps, cfg, ys, *, ctx):
    """The planted fault: each rank normalises its own slice of the inner
    width, with no all-reduce of the sum of squares."""
    out = {}
    for r, (g, inner) in ys.items():
        g32 = g.to(torch.float32)
        y = g32 * torch.rsqrt(g32.square().mean(dim=-1, keepdim=True) + cfg.norm_eps)
        y = (y * ps[r]["norm"]["scale"][inner].to(torch.float32)).to(g.dtype)
        out[r] = y @ ps[r]["out_proj"]["w"].to(torch.float32)
    return out


@pytest.mark.parametrize("tp", [1, 2])
def test_a_per_rank_ssd_norm_is_caught(monkeypatch, tp):
    """With the fault the train step and the prefill logits part from one
    device far past the limits at TP 2; at TP 1 the fault is the sound
    norm and the checks pass."""
    cfg, params, batch = train_case("mamba2-1.3b")
    opt = adamw.AdamWConfig(lr=1e-6)
    single = single_step(cfg, params, batch, opt)
    mesh = cpu_mesh((2, tp))
    monkeypatch.setattr(TSSM, "_norm_out", per_rank_norm)
    sharded = sharded_step(cfg, params, batch, opt, mesh)
    lg1, lg2, _, _ = serve_runs(cfg, params, mesh, new=1)[0]
    err = float((lg2.gather() - lg1).abs().max()) / float(lg1.abs().max())
    if tp == 1:
        assert_close_runs(single, sharded)
        assert err <= TOL
        return
    with pytest.raises(AssertionError):
        assert_close_runs(single, sharded)
    assert err > 100 * TOL


def test_check_sharded_accepts_the_recurrent_and_capacity_configs():
    """Full configs: mamba2-1.3b and recurrentgemma-9b at TP 2 and 4,
    gemma3-1b at TP 4, arctic-480b's capacity dispatch at TP 2; the
    encoder-decoder and prefix configs run at TP 2, 3 and 4; a rank's
    query heads that straddle KV groups run (every rank computes every
    head); an RG-LRU width or SSD head count the axis does not divide runs
    whole on every rank (``layer_plan``); a ring shorter than the ranks
    that would split its slots is refused."""
    for arch in ARCHS:
        for tp in (2, 4):
            TT.check_sharded(get_config(arch), tp)
    rg = get_config("recurrentgemma-9b")
    assert TT.kv_replicated(rg, 2) and TT.tp_cfg(rg, 4).n_kv_heads == 1
    assert TT.tp_cfg(rg, 4).lru_width == 1024 and get_config(ARCHS[0]).ssm_heads == 64
    TT.check_sharded(get_config("gemma3-1b"), 4)
    TT.check_sharded(dataclasses.replace(get_config("arctic-480b"), moe_dispatch="capacity"), 2)
    for arch in ("seamless-m4t-medium", "internvl2-76b"):
        for tp in (2, 3, 4):
            TT.check_sharded(get_config(arch), tp)
    straddle = get_config("qwen2-0.5b").reduced(n_heads=6, n_kv_heads=3)
    TT.check_sharded(straddle, 2)  # 3 query heads a rank over groups of 2: every head
    assert TT.heads_split(straddle, 2) and TT.tp_cfg(straddle, 2).n_heads == 6
    for cfg, tp in ((get_config("recurrentgemma-9b").reduced(lru_width=60, n_heads=8), 8),
                    (get_config("mamba2-1.3b").reduced(), 16)):
        TT.check_sharded(cfg, tp)
        mesh = cpu_mesh((1, tp))
        c = CTX.ShardingCtx(mesh, ("data",), "model")
        layer = place(TM.init_params(cfg, seed=0, device="cpu"), mesh)["layers"][0]
        assert TT.layer_plan(cfg, cfg.layers[0], c, layer)["mixer"].tp_axis is None
    ring = get_config("qwen2-0.5b").reduced(n_kv_heads=1, superblock=(LayerSpec(ATTN, 2),))
    with pytest.raises(ValueError, match="ring of 2 slots"):
        TT.check_sharded(ring, 4)
