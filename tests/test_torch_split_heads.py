"""A tensor axis that splits a query head, and ZeRO-1 over the pod axis, in
the port's sharded steps (``parallel/steps.py``) on logical CPU meshes.

Where the tensor axis does not divide the query heads, or gives a rank
query heads of two KV groups, every rank all-gathers wq (wk, wv) over the
axis, computes every head and takes its own q_dim / tp columns of the
output into its wo rows (``transformer.heads_split``), as GSPMD splits
wq's columns.  One JAX subprocess (4 forced host devices) runs the JAX
package's GSPMD train step on the same params and batch: a reduced config
of 6 query heads over 2 KV heads on (1, 4) and (2, 2), a gemma-like one
with 2 query heads on (1, 4) (fewer than the axis), and ZeRO-1 on a (2, 1,
2) ("pod", "data", "model") mesh with ``opt_state_specs(...,
shard_opt_over_pod=True)``; the port is held at ``test_torch_tp_step.py``'s
tolerances (loss 1e-3; grad norm 1e-3; leaves atol 5e-3, rtol 1e-2).
Against its own single-device steps in fp32 the port is held at 1e-5:
the train step (``assert_close_runs``), and prefill plus 4 decode steps
with the gathered caches (gemma's window ring wrapped, an
encoder-decoder's cross-attention and a prefix model's splice at 8
ranks over 4 heads).  ZeRO-1 keeps the equal-layout update's bits.
"""

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.configs.base import ATTN, LayerSpec
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as SH
from repro_torch.parallel import steps
from repro_torch.parallel.layout import Layout, Mesh, P, tree_leaves
from test_torch_tp_modal import assert_serve_step, serve_runs
from test_torch_tp_step import (FLATTEN, assert_close_runs, cpu_mesh, place, replicas_bit_equal,
                                run_jax, sharded_step, single_step, unflatten)

SPLIT6 = dict(n_heads=6, n_kv_heads=2)      # 6 query heads over 2 KV heads
TWO = dict(n_heads=2, n_kv_heads=1)  # fewer query heads than a 4-wide axis
# gemma3 as one local (window 16) and one global layer
GEMMA2 = dict(TWO, superblock=(LayerSpec(ATTN, 16), LayerSpec(ATTN, None)), n_superblocks=1,
              tail=(), num_layers=2)
POD = ("pod", "data", "model")

JAX_STEPS = FLATTEN + '''
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCHS
from repro.configs.base import ATTN, LayerSpec
from repro.models import init_params, synth_batch
from repro.optim import adamw
from repro.parallel import sharding as SH
from repro.parallel.compat import auto_axis_types, make_mesh
from repro.parallel.steps import make_train_step

opt_cfg = adamw.AdamWConfig(lr=1e-3)
out = {}
CASES = (("split6_1x4", "qwen2-0.5b", dict(n_heads=6, n_kv_heads=2), (1, 4), None),
         ("split6_2x2", "qwen2-0.5b", dict(n_heads=6, n_kv_heads=2), (2, 2), None),
         ("gemma2_1x4", "gemma3-1b", dict(n_heads=2, n_kv_heads=1, n_superblocks=1,
                                          tail=(), num_layers=2,
                                          superblock=(LayerSpec(ATTN, 16), LayerSpec(ATTN, None))),
          (1, 4), None),
         ("zero1", "qwen2-0.5b", {}, (2, 1, 2), "pod"))
for name, arch, kw, shape, pod in CASES:
    cfg = ARCHS[arch].reduced(**kw)
    p = init_params(jax.random.PRNGKey(0), cfg)
    opt = adamw.init(opt_cfg, p)
    batch = synth_batch(jax.random.PRNGKey(1), cfg, 16, 4, "train")
    axes = ("pod", "data", "model") if pod else ("data", "model")
    mesh = make_mesh(shape, axes, axis_types=auto_axis_types(len(axes)))
    rules = SH.ShardingRules(pod_axis=pod)
    pspecs = SH.sanitize_specs(SH.param_specs(p, rules), p, mesh)
    ospecs = SH.sanitize_specs(SH.opt_state_specs(pspecs, rules, p, pod_size=2), opt, mesh)
    ns = lambda s: NamedSharding(mesh, s)
    bax = ("pod", "data") if pod else "data"
    bsh = jax.tree.map(lambda x: ns(P(bax, *([None] * (x.ndim - 1)))), batch)
    p2, o2, m2 = jax.jit(make_train_step(cfg, opt_cfg),
                         in_shardings=(jax.tree.map(ns, pspecs), jax.tree.map(ns, ospecs), bsh))(
        jax.device_put(p, jax.tree.map(ns, pspecs)), jax.device_put(opt, jax.tree.map(ns, ospecs)),
        jax.device_put(batch, bsh))
    flatten(jax.tree.map(np.asarray, p), name + "/before", out)
    flatten(jax.tree.map(np.asarray, p2), name + "/after", out)
    flatten(jax.tree.map(np.asarray, batch), name + "/batch", out)
    out[name + "/loss"] = np.asarray(m2["loss"])
    out[name + "/grad_norm"] = np.asarray(m2["grad_norm"])
np.savez("{out}", **out)
'''

JAX_CASES = {"split6_1x4": ("qwen2-0.5b", SPLIT6, (1, 4)),
             "split6_2x2": ("qwen2-0.5b", SPLIT6, (2, 2)),
             "gemma2_1x4": ("gemma3-1b", GEMMA2, (1, 4)),
             "zero1": ("qwen2-0.5b", {}, (2, 1, 2))}


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    return run_jax(JAX_STEPS, str(tmp_path_factory.mktemp("jax") / "steps.npz"))


def pod_mesh(shape=(2, 1, 2)):
    return Mesh(np.arange(int(np.prod(shape))).reshape(shape), POD, device="cpu")


def zero1_step(cfg, params, batch, opt, mesh, rules, steps_=1):
    """``steps_`` sharded train steps with the AdamW state on
    ``opt_layouts``' layouts; returns (params, state, metrics)."""
    sp = place(params, mesh, rules)
    state = adamw.init(opt, sp, steps.opt_layouts(sp, mesh, rules))
    step = steps.make_train_step(cfg, opt, impl="reference", mesh=mesh, rules=rules)
    for s in range(steps_):
        sp, state, m = step(sp, state, batch if s == 0 else
                            TM.synth_batch(s + 5, cfg, batch["tokens"].shape[1], 4,
                                           device="cpu"))
    return sp, state, m


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_sharded_step_matches_jax_gspmd_step(jax_steps, name):
    """The port's step against the JAX package's GSPMD step on the same
    params and batch: heads split mid-way on (1, 4), whole on (2, 2),
    2 query heads on 4 ranks, ZeRO-1 over the pod axis."""
    arch, kw, shape = JAX_CASES[name]
    cfg = get_config(arch).reduced(**kw)
    params = params_from_jax(unflatten(jax_steps, name + "/before"), cfg, device="cpu")
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in unflatten(jax_steps, name + "/batch").items()}
    batch["tokens"], batch["labels"] = batch["tokens"].long(), batch["labels"].long()
    opt = adamw.AdamWConfig(lr=1e-3)
    if name == "zero1":
        p2, o2, m2 = zero1_step(cfg, params, batch, opt, pod_mesh(),
                                SH.ShardingRules(pod_axis="pod"))
    else:
        assert TT.heads_split(cfg, shape[1]) == (shape[1] == 4)
        p2, o2, m2 = sharded_step(cfg, params, batch, opt, cpu_mesh(shape))
    assert abs(float(m2["loss"]) - float(jax_steps[name + "/loss"])) < 1e-3
    np.testing.assert_allclose(float(m2["grad_norm"]), float(jax_steps[name + "/grad_norm"]),
                               rtol=1e-3)
    want = tree_leaves(params_from_jax(unflatten(jax_steps, name + "/after"), cfg, device="cpu"))
    got = tree_leaves(p2)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.gather().detach().numpy(), b.numpy(), atol=5e-3, rtol=1e-2)
    assert replicas_bit_equal(p2) and replicas_bit_equal(o2["m"])


@pytest.mark.parametrize("arch,kw,shape", [
    ("qwen2-0.5b", SPLIT6, (1, 4)), ("qwen2-0.5b", SPLIT6, (2, 2)),
    ("gemma3-1b", GEMMA2, (1, 4)), ("qwen2-0.5b", dict(n_heads=6, n_kv_heads=3), (1, 2)),
    ("seamless-m4t-medium", TWO, (1, 4)), ("internvl2-76b", TWO, (1, 4))])
def test_split_head_step_matches_single_device_fp32(arch, kw, shape):
    """Every case but (2, 2) splits a head or straddles KV groups (6 over
    3 KV heads at 2: 3 query heads a rank over groups of 2); the
    encoder-decoder's encoder and cross-attention and the prefix splice
    with 2 query heads over 4 ranks."""
    cfg = get_config(arch).reduced(**kw)
    assert TT.heads_split(cfg, shape[1]) == (shape != (2, 2))
    params = TM.init_params(cfg, seed=0, device="cpu")
    params["embed"]["table"].mul_(0.05)
    batch = TM.synth_batch(1, cfg, 16, 4, device="cpu")
    batch["mask"][0, 11:] = 0.0
    opt = adamw.AdamWConfig(lr=1e-6)
    assert_close_runs(single_step(cfg, params, batch, opt),
                      sharded_step(cfg, params, batch, opt, cpu_mesh(shape)))


@pytest.mark.parametrize("arch,kw,shape,prompt_len", [
    ("qwen2-0.5b", SPLIT6, (1, 4), 16), ("gemma3-1b", GEMMA2, (1, 4), 20),
    ("qwen2-0.5b", SPLIT6, (2, 4), 16), ("seamless-m4t-medium", TWO, (1, 4), 16),
    ("internvl2-76b", TWO, (1, 4), 16)])
def test_split_head_prefill_and_decode_match_single_device_fp32(arch, kw, shape, prompt_len):
    """Prefill then 4 decode steps: logits within 1e-5 of the largest, the
    greedy tokens, and the gathered caches (every KV head on every rank for
    its block of the slots, ``P(batch, model, None, None)``; an
    encoder-decoder's "xkv" on every rank, ``P(batch, None, None, None)``);
    gemma's prompt of 20 and 4 steps wrap its 16-slot rings."""
    cfg = get_config(arch).reduced(**kw)
    assert TT.heads_split(cfg, shape[1])
    params = TM.init_params(cfg, seed=0, device="cpu")
    params["embed"]["table"].mul_(0.05)
    runs = serve_runs(cfg, params, cpu_mesh(shape), prompt_len=prompt_len, new=5)
    for run in runs:
        assert_serve_step(*run)
    for layer in runs[-1][3]:
        for part, slot in (((layer["self"], "model"), (layer["xkv"], None)) if "xkv" in layer
                           else ((layer, "model"),)):
            assert {st.layout.spec for st in part.values()} == {P("data", slot, None, None)}
            assert part["k"].blocks[0].shape[2] == cfg.n_kv_heads


@pytest.mark.parametrize("fsdp", ["data", None])
def test_zero1_keeps_the_equal_layout_bits(fsdp):
    """Two ZeRO-1 steps on (2, 1, 2) equal, bit for bit, the same steps with
    ``shard_opt_over_pod=False``; replicas bit-equal; each widened m, v and
    master block is half its parameter's block where the dim divides (with
    FSDP off a matrix's first dim takes the pod axis too)."""
    cfg = get_config("qwen2-0.5b").reduced()
    params = TM.init_params(cfg, seed=0, device="cpu")
    batch = TM.synth_batch(1, cfg, 16, 4, device="cpu")
    opt = adamw.AdamWConfig(lr=1e-3)
    mesh = pod_mesh()
    runs = [zero1_step(cfg, params, batch, opt, mesh,
                       SH.ShardingRules(fsdp_axis=fsdp, pod_axis="pod", shard_opt_over_pod=z),
                       steps_=2) for z in (True, False)]
    for a, b in zip(tree_leaves(runs[0][0]), tree_leaves(runs[1][0])):
        assert torch.equal(a.gather(), b.gather())
    for k in ("m", "v", "master"):
        for a, b in zip(tree_leaves(runs[0][1][k]), tree_leaves(runs[1][1][k])):
            assert torch.equal(a.gather(), b.gather())
    assert replicas_bit_equal(runs[0][0]) and replicas_bit_equal(runs[0][1]["master"])
    halved = 0
    for p, m in zip(tree_leaves(runs[0][0]), tree_leaves(runs[0][1]["m"])):
        if "pod" in [a for part in m.layout.spec if part for a in
                     (part if isinstance(part, tuple) else (part,))]:
            assert m.blocks[0].numel() * 2 == p.blocks[0].numel()
            halved += 1
        else:
            assert m.layout == p.layout
    assert halved >= (10 if fsdp is None else 4)


def test_zero1_over_the_data_axis():
    """The dry run's ``dp_zero1``: params replicated, the batch over
    (data, model), the state split over the data axis of (1, 4, 1); the
    step equals the equal-layout one bit for bit."""
    cfg = get_config("qwen2-0.5b").reduced()
    params = TM.init_params(cfg, seed=2, device="cpu")
    batch = TM.synth_batch(3, cfg, 16, 4, device="cpu")
    opt = adamw.AdamWConfig(lr=1e-3)
    mesh = Mesh(np.arange(4).reshape(1, 4, 1), POD, device="cpu")
    rules = SH.ShardingRules(tp_axis=None, fsdp_axis=None, dp_axes=("data", "model"))
    z1 = SH.ShardingRules(tp_axis=None, fsdp_axis=None, pod_axis="data")
    outs = []
    for lay_rules in (z1, None):
        sp = place(params, mesh, rules)
        lay = steps.opt_layouts(sp, mesh, lay_rules, pod_size=4) if lay_rules else None
        state = adamw.init(opt, sp, lay)
        outs.append(steps.make_train_step(cfg, opt, impl="reference", mesh=mesh, rules=rules)(
            sp, state, batch))
    (p1, o1, _), (p2, o2, _) = outs
    assert any(m.blocks[0].numel() * 4 == p.blocks[0].numel()
               for p, m in zip(tree_leaves(p1), tree_leaves(o1["m"])))
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert torch.equal(a.gather(), b.gather())
    assert replicas_bit_equal(p1)


def test_adamw_refuses_other_state_layouts():
    """A state layout that is not the parameter's plus one axis on a dim
    it keeps whole raises; the ZeRO-1 one names its dim and axis."""
    mesh = pod_mesh()
    lay = Layout(mesh, P(None, "model"))
    assert adamw.zero1_dim(lay, Layout(mesh, P("pod", "model"))) == (0, "pod")
    assert adamw.zero1_dim(lay, lay) is None
    for bad in (P("pod", None), P(("pod", "data"), "model"), P("data", "pod")):
        with pytest.raises(ValueError, match="one more axis"):
            adamw.zero1_dim(lay, Layout(mesh, bad))


def test_cuda_split_head_step_on_cpu_tensors_raises():
    cfg = get_config("qwen2-0.5b").reduced(**SPLIT6)
    params = TM.init_params(cfg, seed=0, device="cpu")
    mesh = cpu_mesh((1, 4))
    sp = place(params, mesh)
    opt = adamw.AdamWConfig()
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        steps.make_train_step(cfg, opt, impl="cuda", mesh=mesh)(
            sp, adamw.init(opt, sp), TM.synth_batch(1, cfg, 8, 4, device="cpu"))
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        steps.make_prefill_step(cfg, impl="cuda", mesh=mesh)(
            sp, TM.synth_batch(1, cfg, 8, 4, "prefill", device="cpu"))


@pytest.mark.parametrize("arch", ASSIGNED)
def test_every_assigned_config_runs_at_a_tensor_axis_of_16(arch):
    """``check_sharded`` accepts all ten at 16; qwen2-0.5b's 14, qwen2.5-14b's
    40, gemma3-1b's 4 and arctic-480b's 56 query heads split mid-way, and
    a rank's block config then holds every head."""
    cfg = get_config(arch)
    TT.check_sharded(cfg, 16)
    split = arch in ("qwen2-0.5b", "qwen2.5-14b", "gemma3-1b", "arctic-480b")
    assert TT.heads_split(cfg, 16) == split
    if split:
        lcfg = TT.tp_cfg(cfg, 16)
        assert (lcfg.n_heads, lcfg.n_kv_heads) == (cfg.n_heads, cfg.n_kv_heads)
        assert cfg.q_dim % 16 == 0
