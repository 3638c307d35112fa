"""The port's sharded steps at tensor degrees that do not divide a block's
width (``parallel/steps.py`` with a mesh, ``transformer.layer_plan``).

Where the tensor axis does not divide q_dim, d_ff, the experts, lru_width
or the SSD heads, the JAX package's ``sanitize_specs`` leaves that block's
weights whole and GSPMD replicates the block over the axis; the port runs
it whole on every tensor rank and keeps each rank's result, never summed
over the axis.  The reduced dims below mix split and whole blocks at
degree 3:

- qwen2-0.5b with 6 query heads over 3 KV heads and a vocabulary of 513:
  attention and vocabulary split, the FFN (d_ff 128) whole;
- granite-moe-1b-a400m with a vocabulary of 513: the vocabulary split,
  attention (q_dim 64) and the 4 experts whole;
- mamba2-1.3b at d_model 96 and head_dim 24: the vocabulary and
  ``out_proj``'s 192 rows split, the 8 SSD heads whole (``out_proj``
  gathered inside the layer);
- recurrentgemma-9b on (lru, lru, attn) at d_ff 96: the FFN split, the
  RG-LRU (width 64), attention and the vocabulary (512) whole.

One JAX subprocess (6 forced host devices) runs the JAX package's train
step under ``jit`` on a (2, 3) ("data", "model") mesh with
``sanitize_specs``'d shardings for the four; the port bridges the same
params and runs its (2, 3) step, held at the JAX multidevice test's
tolerance (loss 1e-3; leaves atol 5e-3, rtol 1e-2).  Against the port's
own single-device step in fp32 the (1, 3) and (2, 3) steps are held at
1e-5 (``test_torch_tp_step.assert_close_runs``: loss, grad norm, first
moment, parameters, every replica bit-equal, whole blocks included), the
prefill and decode logits at 2e-5 of their largest magnitude, padded and
packed, seamless's cross-attention, Arctic's dense residual beside whole
experts, and degrees 5 and 7.  A planted fault, a whole block's output
summed over the tensor axis, must be caught.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw
from repro_torch.parallel import collectives as C
from repro_torch.parallel import ctx as CTX
from repro_torch.parallel import steps
from repro_torch.parallel.layout import tree_leaves
from test_torch_packed_sharded import packed_lm_batch
from test_torch_tp_step import (FLATTEN, assert_close_runs, cpu_mesh, place, run_jax,
                                sharded_step, single_step, unflatten)

MIXES = {
    "qwen2-0.5b": dict(n_heads=6, n_kv_heads=3, vocab_size=513),
    "granite-moe-1b-a400m": dict(vocab_size=513),
    "mamba2-1.3b": dict(vocab_size=513, d_model=96, ssm_head_dim=24),
    "recurrentgemma-9b": dict(n_superblocks=1, num_layers=3, tail=(), d_ff=96),
}
OPT = adamw.AdamWConfig(lr=1e-6)
LOGIT_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads, as ``test_torch_lm_head.py`` takes: the narrow
    configs' ops are many and small, and a thread per core in each test
    worker oversubscribes the machine under the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

JAX_STEP = FLATTEN + '''
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCHS
from repro.models import init_params, synth_batch
from repro.optim import adamw
from repro.parallel import sharding as SH
from repro.parallel.compat import auto_axis_types, make_mesh
from repro.parallel.steps import make_train_step

mesh = make_mesh((2, 3), ("data", "model"), axis_types=auto_axis_types(2))
rules = SH.ShardingRules()
out = {}
for arch, kw in MIXES.items():
    cfg = ARCHS[arch].reduced(**kw)
    p = init_params(jax.random.PRNGKey(0), cfg)
    p["embed"]["table"] = p["embed"]["table"] * 0.05
    opt_cfg = adamw.AdamWConfig(lr=1e-3)
    opt = adamw.init(opt_cfg, p)
    batch = synth_batch(jax.random.PRNGKey(1), cfg, 16, 4, "train")
    psp = SH.sanitize_specs(SH.param_specs(p, rules), p, mesh)
    psh = jax.tree.map(lambda s: NamedSharding(mesh, s), psp)
    osh = jax.tree.map(lambda s: NamedSharding(mesh, s), SH.opt_state_specs(psp, rules))
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
'''


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    script = f"MIXES = {MIXES!r}\n" + JAX_STEP
    return run_jax(script, str(tmp_path_factory.mktemp("jax") / "whole.npz"), n=6)


def mixed(arch, **kw):
    return get_config(arch).reduced(**{**MIXES[arch], **kw})


def params_of(cfg, seed=0):
    params = TM.init_params(cfg, seed=seed, device="cpu")
    params["embed"]["table"].mul_(0.05)
    return params


def mixer_plans(cfg, shape):
    """{layer kind: whether the tensor axis splits its mixer, FFN} on a
    ``shape`` mesh, read from the placed layouts."""
    mesh = cpu_mesh(shape)
    c = CTX.ShardingCtx(mesh, ("data",), "model")
    sp = place(params_of(cfg), mesh)
    return {(spec.kind, part): plan[part].tp_axis is not None
            for spec, plan in zip(cfg.layers, TT.layer_plans(sp["layers"], cfg, c))
            for part in plan}


def test_the_mixes_split_some_blocks_and_leave_others_whole():
    """What each mix splits at degree 3, read from the layouts."""
    assert mixer_plans(mixed("qwen2-0.5b"), (1, 3)) == {("attn", "mixer"): True,
                                                        ("attn", "ffn"): False}
    assert mixer_plans(mixed("granite-moe-1b-a400m"), (1, 3)) == {("attn", "mixer"): False,
                                                                  ("attn", "ffn"): False}
    assert mixer_plans(mixed("mamba2-1.3b"), (1, 3)) == {("ssm", "mixer"): False}
    assert mixer_plans(mixed("recurrentgemma-9b"), (1, 3)) == {
        ("lru", "mixer"): False, ("lru", "ffn"): True, ("attn", "mixer"): False,
        ("attn", "ffn"): True}
    assert mixer_plans(get_config("qwen2-0.5b").reduced(n_heads=5, n_kv_heads=5), (1, 5)) == {
        ("attn", "mixer"): True, ("attn", "ffn"): False}


@pytest.mark.parametrize("arch", list(MIXES))
def test_whole_blocks_match_the_jax_sharded_step(jax_steps, arch):
    """The port's (2, 3) step against the JAX package's (2, 3) ``jit`` step
    on the same params and batch, at the JAX multidevice test's tolerance."""
    cfg = mixed(arch)
    params = params_from_jax(unflatten(jax_steps, arch + "/before"), cfg, device="cpu")
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in unflatten(jax_steps, arch + "/batch").items()}
    batch["tokens"], batch["labels"] = batch["tokens"].long(), batch["labels"].long()
    mesh = cpu_mesh((2, 3))
    p2, o2, m2 = sharded_step(cfg, params, batch, adamw.AdamWConfig(lr=1e-3), mesh)
    assert abs(float(m2["loss"]) - float(jax_steps[arch + "/loss"])) < 1e-3
    np.testing.assert_allclose(float(m2["grad_norm"]), float(jax_steps[arch + "/grad_norm"]),
                               rtol=1e-3)
    want = tree_leaves(params_from_jax(unflatten(jax_steps, arch + "/after"), cfg,
                                       device="cpu"))
    got = tree_leaves(p2)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.gather().detach().numpy(), b.numpy(), atol=5e-3,
                                   rtol=1e-2)


FP32 = {
    "qwen-mix-1x3": ("qwen2-0.5b", {}, (1, 3)),
    "qwen-mix-2x3": ("qwen2-0.5b", {}, (2, 3)),
    "granite-2x3": ("granite-moe-1b-a400m", {}, (2, 3)),
    "granite-capacity-1x3": ("granite-moe-1b-a400m", dict(moe_dispatch="capacity"), (1, 3)),
    "mamba2-1x3": ("mamba2-1.3b", {}, (1, 3)),
    "mamba2-2x3": ("mamba2-1.3b", {}, (2, 3)),
    "recurrentgemma-1x3": ("recurrentgemma-9b", {}, (1, 3)),
    "recurrentgemma-2x3": ("recurrentgemma-9b", {}, (2, 3)),
    "heads-split-ffn-whole-1x5": ("qwen2-0.5b", dict(n_heads=5, n_kv_heads=5, vocab_size=515),
                                  (1, 5)),
    "mamba2-heads-whole-vocab-split-1x7": ("mamba2-1.3b",
                                           dict(d_model=64, ssm_head_dim=16, vocab_size=511),
                                           (1, 7)),
}


@pytest.mark.parametrize("name", list(FP32))
def test_whole_blocks_match_single_device_fp32(name):
    """Padded train steps against one device (1e-5), every whole block's
    copies bit-equal over the tensor ranks after the step."""
    arch, kw, shape = FP32[name]
    cfg = mixed(arch, **kw)
    params = params_of(cfg, seed=1)
    batch = TM.synth_batch(2, cfg, 12, 6 if shape[0] == 2 else 3, device="cpu")
    batch["mask"][0, 7:] = 0.0
    assert_close_runs(single_step(cfg, params, batch, OPT),
                      sharded_step(cfg, params, batch, OPT, cpu_mesh(shape)))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-1b-a400m"])
def test_packed_cohort_with_whole_blocks_matches_single_device_fp32(arch):
    """A packed cohort dealt to two replicas of (2, 3): qwen's FFN and
    granite's attention and experts whole on each tensor rank."""
    cfg = mixed(arch)
    params = params_of(cfg, seed=3)
    batch, _ = packed_lm_batch(cfg.vocab_size)
    assert_close_runs(single_step(cfg, params, batch, OPT),
                      sharded_step(cfg, params, batch, OPT, cpu_mesh((2, 3))))


def test_cross_attention_and_dense_residual_whole_fp32():
    """seamless on (2, 3): q_dim 64, so every attention, cross-attention
    and FFN runs whole; Arctic on (2, 3) with d_ff 96: its dense residual
    split over the tensor axis beside its 4 whole experts."""
    seamless = get_config("seamless-m4t-medium").reduced()
    params = params_of(seamless, seed=4)
    batch = TM.synth_batch(5, seamless, 8, 4, device="cpu")
    assert_close_runs(single_step(seamless, params, batch, OPT),
                      sharded_step(seamless, params, batch, OPT, cpu_mesh((2, 3))))
    arctic = dataclasses.replace(get_config("arctic-480b").reduced(), d_ff=96)
    c = CTX.ShardingCtx(cpu_mesh((2, 3)), ("data",), "model")
    params = params_of(arctic, seed=5)
    plan = TT.layer_plan(arctic, arctic.layers[0], c, place(params, cpu_mesh((2, 3)))["layers"][0])
    assert plan["ffn"].tp_axis is None and plan["dense"].tp_axis == "model"
    batch = TM.synth_batch(6, arctic, 8, 4, device="cpu")
    assert_close_runs(single_step(arctic, params, batch, OPT),
                      sharded_step(arctic, params, batch, OPT, cpu_mesh((2, 3))))


def serve_runs(cfg, shape, *, rows=4, prompt_len=8, new=4, seed=0):
    """The single-device and sharded prefill, then ``new`` decode steps fed
    the single device's greedy tokens: [(logits, sharded logits, caches,
    sharded caches)] per call, and the sharded caches' leaves."""
    params = params_of(cfg, seed=seed)
    mesh = cpu_mesh(shape)
    sp = place(params, mesh)
    prompt = TM.synth_batch(seed + 1, cfg, prompt_len, rows, "prefill", device="cpu")
    lg1, c1 = steps.make_prefill_step(cfg, impl="reference", extra_len=new)(params, prompt)
    lg2, c2 = steps.make_prefill_step(cfg, impl="reference", extra_len=new, mesh=mesh)(
        sp, prompt)
    out = [(lg1, lg2)]
    d1 = steps.make_decode_step(cfg, impl="reference")
    d2 = steps.make_decode_step(cfg, impl="reference", mesh=mesh)
    for t in range(prompt_len, prompt_len + new):
        tok = lg1.argmax(-1)
        lg1, c1 = d1(params, tok, c1, t)
        lg2, c2 = d2(sp, tok, c2, t)
        out.append((lg1, lg2))
    return out, c1, c2


@pytest.mark.parametrize("arch,shape", [("qwen2-0.5b", (1, 3)), ("granite-moe-1b-a400m", (2, 3)),
                                        ("mamba2-1.3b", (1, 3)),
                                        ("recurrentgemma-9b", (2, 3))])
def test_whole_blocks_serve_as_one_device(arch, shape):
    """Prefill and decode logits within 2e-5 of their largest magnitude, the
    gathered caches equal to one device's; a whole mixer's caches hold
    every KV head, SSD head or RG-LRU channel on each tensor rank (no
    model axis in their layouts), as the JAX package's sanitized cache
    specs leave them at degree 3."""
    cfg = mixed(arch)
    runs, c1, c2 = serve_runs(cfg, shape)
    for lg1, lg2 in runs:
        scale = float(lg1.abs().max())
        assert float((lg2.gather() - lg1).abs().max()) <= LOGIT_TOL * scale
    for a, b in zip(tree_leaves(c1), tree_leaves(steps.gathered_caches(c2))):
        np.testing.assert_allclose(b.float().numpy(), a.float().numpy(), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
    mesh = cpu_mesh(shape)
    sp = place(params_of(cfg), mesh)
    plans = TT.layer_plans(sp["layers"], cfg, CTX.ShardingCtx(mesh, ("data",), "model"))
    for spec, plan, layer in zip(cfg.layers, plans, c2):
        split = any("model" in str(st.layout.spec) for st in tree_leaves(layer))
        assert split == (plan["mixer"].tp_axis is not None), spec
        if not split:
            for st in tree_leaves(layer):
                assert all(blk.shape[1:] == st.shape[1:] for blk in st.blocks.values())


@pytest.mark.parametrize("tp", [3, 5, 6, 7])
def test_every_config_builds_and_prefills_at_odd_degrees(tp):
    """The train, prefill and decode steps of every reduced config build at
    tensor degrees 3, 5, 6 and 7; at 6 each config's prefill equals one
    device's (2e-5), every block it cannot split whole."""
    mesh = cpu_mesh((1, tp))
    for name in ARCHS:
        cfg = get_config(name).reduced()
        assert callable(steps.make_train_step(cfg, OPT, impl="reference", mesh=mesh))
        assert callable(steps.make_prefill_step(cfg, impl="reference", mesh=mesh))
        assert callable(steps.make_decode_step(cfg, impl="reference", mesh=mesh))
        if tp != 6:
            continue
        params = params_of(cfg, seed=7)
        prompt = TM.synth_batch(8, cfg, cfg.prefix_len + 6, 1, "prefill", device="cpu")
        lg1, _ = steps.make_prefill_step(cfg, impl="reference")(params, prompt)
        lg2, _ = steps.make_prefill_step(cfg, impl="reference", mesh=mesh)(place(params, mesh),
                                                                           prompt)
        scale = float(lg1.abs().max())
        assert float((lg2.gather() - lg1).abs().max()) <= LOGIT_TOL * scale, name


def test_a_whole_block_summed_over_the_tensor_axis_is_caught(monkeypatch):
    """The planted fault: a whole block's per-rank result summed over the
    tensor axis (its output, and so its gradient, counted tp times)."""
    class Summed(CTX.ShardingCtx):
        def tp_reduce(self, xs, op="sum"):
            return C.all_reduce(xs, self.mesh, "model", op=op)
    monkeypatch.setattr(CTX.ShardingCtx, "whole",
                        lambda self, **kw: Summed(self.mesh, self.batch_axes, None))
    cfg = mixed("qwen2-0.5b")  # the FFN whole at 3
    params = params_of(cfg, seed=1)
    batch = TM.synth_batch(2, cfg, 12, 3, device="cpu")
    with pytest.raises(AssertionError):
        assert_close_runs(single_step(cfg, params, batch, OPT),
                          sharded_step(cfg, params, batch, OPT, cpu_mesh((1, 3))))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-1.3b"])
def test_whole_gradients_summed_over_the_tensor_axis_are_caught(monkeypatch, arch):
    """The other planted fault: a whole sublayer's weight gradients, whole
    on every tensor rank once the stream's shares are summed, all-reduced
    over the tensor axis as well (counted tp times).  mamba2's ``out_proj``
    rows stay split at 3, so its gather's backward is held too."""
    monkeypatch.setattr(TT, "full_grad_leaves", lambda *a: [])
    cfg = mixed(arch)
    params = params_of(cfg, seed=1)
    batch = TM.synth_batch(2, cfg, 12, 3, device="cpu")
    with pytest.raises(AssertionError):
        assert_close_runs(single_step(cfg, params, batch, OPT),
                          sharded_step(cfg, params, batch, OPT, cpu_mesh((1, 3))))


def test_a_whole_stack_sums_its_gradient_once_and_no_whole_weight():
    """Reduced qwen2-0.5b at q_dim 64 and d_ff 128 on (1, 3): attention and
    FFN whole in every layer, the vocabulary (513) split.  The backward
    all-reduces the stream's gradient once, where the stack meets the head,
    in the activations' dtype, and no fp32 all-reduce is as large as a
    layer weight: the whole copies' gradients are summed over no axis."""
    cfg = get_config("qwen2-0.5b").reduced(vocab_size=513)
    params = params_of(cfg, seed=2)
    batch = TM.synth_batch(3, cfg, 12, 2, device="cpu")
    mesh = cpu_mesh((1, 3))
    C.reset_stats()
    sharded_step(cfg, params, batch, OPT, mesh)
    act = 2 * 12 * cfg.d_model * 4
    reduces = {k: n for k, n in C.RECORD.items() if k[0] == "all-reduce"}
    assert reduces.get(("all-reduce", act, 3, 1), 0) >= 3  # lookup, its backward, the stream
    smallest = min(t.numel() * 4 for t in tree_leaves(params["layers"]) if t.dim() == 2)
    assert all(k[1] < smallest for k in reduces), reduces
