"""The sharded steps of the encoder-decoder config (reduced
seamless-m4t-medium: an encoder over ``frames`` and cross-attention in every
decoder layer) and the prefix config (reduced internvl2-76b:
``prefix_embeds`` spliced over the first positions) on logical CPU meshes
(``parallel/steps.py`` with a mesh).

One JAX subprocess (4 forced host devices) runs the JAX package's train
step of both models under ``jit`` with ``in_shardings`` on a (2, 2)
("data", "model") mesh, as ``tests/test_torch_tp_recurrent.py`` does for
the recurrent mixers; the port's explicit-SPMD step on the same params and
batch is held at ``tests/test_multidevice.py``'s tolerance (loss 1e-3;
leaves atol 5e-3, rtol 1e-2).  Against the port's single-device steps in
fp32, on (2, 2), (1, 2) and (1, 4): the train step at
``test_torch_tp_step.assert_close_runs``' 1e-5, prefill and decode logits
at 1e-5 of their largest magnitude with equal greedy tokens, the gathered
caches, the cross-attention's "xkv" included, at 1e-5.  The reduced
configs have 4 query heads over 2 KV heads, so at TP 4 every rank gathers
the self- and cross-attention's wk/wv and the "xkv" cache is replicated
over the model axis.  Replicas stay bit-equal after two steps.  Two planted
faults the checks must catch: the prefix spliced into each rank's
vocabulary-shard lookup before the sum over the tensor axis (the reduced
vocabulary of 512 is split at TP 2 and 4), and the sharded encoder run
causal.
"""

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw
from repro_torch.parallel import ctx as CTX
from repro_torch.parallel import sharding as SH
from repro_torch.parallel import steps
from repro_torch.parallel.layout import P, tree_leaves, tree_map_with_path
from test_torch_tp_step import (FLATTEN, assert_close_runs, cpu_mesh, place, replicas_bit_equal,
                                run_jax, sharded_step, single_step, unflatten)

SEAMLESS, INTERNVL = "seamless-m4t-medium", "internvl2-76b"
ARCHS = (SEAMLESS, INTERNVL)
SHAPES = ((2, 2), (1, 2), (1, 4))
SEQ = 16  # past the reduced prefix of 8 embeddings (and 8 frames)
TOL = 1e-5

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
for arch in %r:
    cfg = ARCHS[arch].reduced()
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
''' % (ARCHS, SEQ)


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    return run_jax(JAX_STEPS, str(tmp_path_factory.mktemp("jax") / "steps.npz"))


def model(arch, seed=0):
    cfg = get_config(arch).reduced()
    params = TM.init_params(cfg, seed=seed, device="cpu")
    params["embed"]["table"].mul_(0.05)
    return cfg, params


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_jax_sharded_step(jax_steps, arch):
    cfg = get_config(arch).reduced()
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
    batch["mask"][0, 11:] = 0.0
    batch["mask"][3, :10] = 0.0
    return cfg, params, batch


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_single_device_fp32(arch, shape):
    cfg, params, batch = train_case(arch)
    opt = adamw.AdamWConfig(lr=1e-6)
    assert_close_runs(single_step(cfg, params, batch, opt),
                      sharded_step(cfg, params, batch, opt, cpu_mesh(shape)))


def serve_runs(cfg, params, mesh, *, batch=4, prompt_len=SEQ, new=4, seed=0):
    """The single-device and the sharded prefill (of the tokens and the
    frames or prefix embeddings) then ``new - 1`` decode steps, both fed
    the single-device greedy tokens: [(logits, sharded logits, caches,
    sharded caches)] per call."""
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


def leaves_by_path(tree) -> dict:
    out = {}
    tree_map_with_path(lambda path, leaf: out.__setitem__(path, leaf), tree)
    return out


def logit_err(lg1, lg2) -> float:
    return float((lg2.gather() - lg1).abs().max()) / float(lg1.abs().max())


def assert_serve_step(lg1, lg2, c1, c2):
    assert logit_err(lg1, lg2) <= TOL
    assert torch.equal(lg2.gather().argmax(-1), lg1.argmax(-1))
    want, got = leaves_by_path(c1), leaves_by_path(steps.gathered_caches(c2))
    assert sorted(got) == sorted(want)
    for path, a in want.items():
        b = got[path]
        assert b.shape == a.shape and b.dtype == a.dtype, path
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=TOL, rtol=TOL, err_msg=str(path))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_single_device(arch, shape):
    """Logits, greedy tokens and the gathered caches at every call; each
    cache leaf's layout: KV heads over the model axis, or at TP 4 (2 KV
    heads) every KV head, "self" for a block of its slots over the model
    axis and "xkv" replicated over it."""
    cfg, params = model(arch)
    mesh = cpu_mesh(shape)
    runs = serve_runs(cfg, params, mesh)
    for run in runs:
        assert_serve_step(*run)
    tp = shape[1]
    heads = P("data", None, "model", None) if tp < 4 else P("data", None, None, None)
    slots = heads if tp < 4 else P("data", "model", None, None)
    local = 2 if tp == 4 else 2 // tp
    for layer in runs[-1][3]:
        for part, spec in (((layer["self"], slots), (layer["xkv"], heads)) if arch == SEAMLESS
                           else ((layer, slots),)):
            assert {k: st.layout.spec for k, st in part.items()} == {"k": spec, "v": spec}
            assert part["k"].blocks[mesh.device_ids[-1]].shape[2] == local
    if arch == SEAMLESS:
        assert runs[-1][3][0]["xkv"]["k"].shape == (4, cfg.prefix_len, 2, cfg.head_dim)


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


def test_the_prefix_keeps_the_sharded_loss_and_short_prompts_raise():
    """The sharded loss keeps its bits when the labels and token ids under
    the prefix change (the mask is zero there and the splice replaces
    them), as ``chip_smoke.prefix_loss_check`` holds it on one device; a
    prompt shorter than the prefix raises, as ``model._embed_inputs``."""
    cfg, params, batch = train_case(INTERNVL)
    mesh = cpu_mesh((2, 2))
    sp = place(params, mesh)
    rules = SH.ShardingRules()
    moved = {k: v.clone() for k, v in batch.items()}
    n = cfg.prefix_len
    moved["labels"][:, :n] = (moved["labels"][:, :n] + 3) % cfg.vocab_size
    moved["tokens"][:, :n] = (moved["tokens"][:, :n] + 5) % cfg.vocab_size
    with torch.no_grad(), CTX.use(mesh, rules.batch_axes, rules.tp_axis) as c:
        a, _ = TM.lm_loss_sharded(sp, cfg, steps.split_batch(batch, mesh, rules), ctx=c,
                                  impl="reference")
        b, _ = TM.lm_loss_sharded(sp, cfg, steps.split_batch(moved, mesh, rules), ctx=c,
                                  impl="reference")
    assert torch.equal(a, b)
    short = TM.synth_batch(1, cfg, n - 1, 2, "prefill", device="cpu")
    with pytest.raises(ValueError, match="fewer than the prefix"):
        steps.make_prefill_step(cfg, impl="reference", mesh=mesh)(sp, short)


def splice_before_sum(params, top, cfg, batch, ctx):
    """The planted fault: each rank splices the prefix into its own
    vocabulary-shard lookup, so the sum over the tensor axis counts it once
    per rank."""
    if not ctx.tp_splits(params["embed"]["table"], 0):
        return {r: TM._embed_inputs(top[r], cfg, b) for r, b in batch.items()}
    xs = {r: TM._splice_prefix(cfg, L.embed_apply_vocab_shard(
        top[r]["embed"], b["tokens"], ctx.tp_index(r) * top[r]["embed"]["table"].shape[0]), b)
        for r, b in batch.items()}
    return {r: x.to(L.dtype_of(cfg)) for r, x in ctx.tp_reduce(xs).items()}


@pytest.mark.parametrize("tp", [1, 2])
def test_a_prefix_spliced_before_the_vocabulary_sum_is_caught(monkeypatch, tp):
    """With the fault the train step and the prefill logits part from one
    device far past the limits at TP 2; at TP 1 (no vocabulary split) the
    fault is the sound splice and the checks pass."""
    cfg, params, batch = train_case(INTERNVL)
    opt = adamw.AdamWConfig(lr=1e-6)
    single = single_step(cfg, params, batch, opt)
    mesh = cpu_mesh((2, tp))
    monkeypatch.setattr(TM, "_embed_inputs_sharded", splice_before_sum)
    sharded = sharded_step(cfg, params, batch, opt, mesh)
    err = logit_err(*serve_runs(cfg, params, mesh, new=1)[0][:2])
    if tp == 1:
        assert_close_runs(single, sharded)
        assert err <= TOL
        return
    with pytest.raises(AssertionError):
        assert_close_runs(single, sharded)
    assert err > 100 * TOL


def test_a_causal_sharded_encoder_is_caught(monkeypatch):
    """The planted fault: the sharded encoder's self-attention run causal.
    The train step, the prefill logits and the gathered "xkv" caches part
    from one device far past the limits."""
    cfg, params, batch = train_case(SEAMLESS)
    opt = adamw.AdamWConfig(lr=1e-6)
    single = single_step(cfg, params, batch, opt)
    mesh = cpu_mesh((1, 2))
    stack = TT.stack_apply_sharded

    def causal_encoder(*args, **kw):
        return stack(*args, **dict(kw, causal=True))
    monkeypatch.setattr(TT, "stack_apply_sharded", causal_encoder)
    with pytest.raises(AssertionError):
        assert_close_runs(single, sharded_step(cfg, params, batch, opt, mesh))
    lg1, lg2, c1, c2 = serve_runs(cfg, params, mesh, new=1)[0]
    assert logit_err(lg1, lg2) > 100 * TOL
    got = steps.gathered_caches(c2)[0]["xkv"]["k"]
    assert float((got - c1[0]["xkv"]["k"]).abs().max()) > 100 * TOL


def test_check_sharded_accepts_the_modal_configs():
    """Full configs at TP 2 and 4: seamless's 16 KV heads and internvl2's 8
    split by head (no replication); seamless's vocabulary of 256,206 split
    at TP 2 and whole at TP 4, internvl2's 128,256 split at both; a degree
    that does not divide q_dim runs too, its attention and cross-attention
    whole on every rank (``layer_plan``) as the JAX package's
    ``sanitize_specs`` leaves them."""
    for arch in ARCHS:
        cfg = get_config(arch)
        for tp in (2, 4):
            TT.check_sharded(cfg, tp)
            assert not TT.kv_replicated(cfg, tp)
        TT.check_sharded(cfg, 3)
        mesh = cpu_mesh((1, 3))
        c = CTX.ShardingCtx(mesh, ("data",), "model")
        layer = D.meta_params(cfg, mesh, SH.ShardingRules())["layers"][0]
        plan = TT.layer_plan(cfg, cfg.layers[0], c, layer)
        assert cfg.q_dim % 3 and all(plan[k].tp_axis is None for k in ("mixer", "xattn")
                                     if k in plan)
    assert get_config(SEAMLESS).vocab_size % 2 == 0 and get_config(SEAMLESS).vocab_size % 4
    assert get_config(INTERNVL).vocab_size % 4 == 0
