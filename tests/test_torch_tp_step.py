"""The port's sharded train step (``parallel/steps.make_train_step(mesh=)``)
on logical CPU meshes, against the JAX package's sharded step and against
the port's own single-device step.

One JAX subprocess (4 forced host devices) runs the JAX package's train
step under ``jit`` with ``in_shardings`` on a (2, 2) ("data", "model") mesh,
as ``tests/test_multidevice.py::test_tp_sharded_train_step_matches_single_device``
does, and returns its params, batch and results through an ``.npz``; the
port bridges the same params and runs its explicit-SPMD step on a (2, 2)
mesh of logical CPU devices, held at the JAX test's own tolerance (loss
1e-3; leaves atol 5e-3, rtol 1e-2).  Against its single-device step in
fp32 the port is held at 1e-5 (relative, on the loss, the grad norm and
the first moment m = (1 - b1) x the clipped gradient; absolute on the
parameters, with lr 1e-6 so that a gradient sign that flips in fp32
summation order moves a parameter by 2e-6 at most).  Replicated blocks
are held bit-equal after every step.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as SH
from repro_torch.parallel import steps
from repro_torch.parallel.layout import Layout, Mesh, place_tree, tree_leaves, tree_map

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def run_jax(script: str, out: str, n: int = 4, timeout: int = 300):
    """Run ``script`` (its ``{out}`` replaced by the .npz path ``out``) in a
    subprocess with ``n`` forced host devices; returns the loaded .npz."""
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={n}",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(script).replace("{out}", out)],
                       capture_output=True, text=True, env=env, timeout=timeout)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return dict(np.load(out, allow_pickle=False))


# Nested dicts and lists as flat "a/b/0/c" keys (the .npz carries no tree).
FLATTEN = '''
def flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flatten(v, f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flatten(v, f"{prefix}/{i}", out)
    else:
        out[prefix] = np.asarray(tree)
    return out
'''


def unflatten(flat: dict, prefix: str):
    """The tree under ``prefix`` of a ``flatten``ed dict (lists where the
    keys are indices)."""
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node, parts = tree, key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def lists(t):
        if not isinstance(t, dict):
            return t
        if all(k.isdigit() for k in t):
            return [lists(t[str(i)]) for i in range(len(t))]
        return {k: lists(v) for k, v in t.items()}
    return lists(tree)


JAX_STEP = FLATTEN + '''
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCHS
from repro.models import init_params, synth_batch
from repro.optim import adamw
from repro.parallel import sharding as SH
from repro.parallel.compat import auto_axis_types, make_mesh
from repro.parallel.steps import make_train_step

cfg = ARCHS["qwen2-0.5b"].reduced()
p = init_params(jax.random.PRNGKey(0), cfg)
opt_cfg = adamw.AdamWConfig(lr=1e-3)
opt = adamw.init(opt_cfg, p)
batch = synth_batch(jax.random.PRNGKey(1), cfg, 16, 4, "train")
step = make_train_step(cfg, opt_cfg)
mesh = make_mesh((2, 2), ("data", "model"), axis_types=auto_axis_types(2))
rules = SH.ShardingRules()
psh = jax.tree.map(lambda s: NamedSharding(mesh, s), SH.param_specs(p, rules))
osh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                   SH.opt_state_specs(SH.param_specs(p, rules), rules))
bsh = jax.tree.map(lambda x: NamedSharding(mesh, P("data", *([None] * (x.ndim - 1)))), batch)
p2, o2, m2 = jax.jit(step, in_shardings=(psh, osh, bsh))(
    jax.device_put(p, psh), jax.device_put(opt, osh), jax.device_put(batch, bsh))
out = {}
flatten(jax.tree.map(np.asarray, p), "before", out)
flatten(jax.tree.map(np.asarray, p2), "after", out)
flatten(jax.tree.map(np.asarray, batch), "batch", out)
out["loss"] = np.asarray(m2["loss"])
out["grad_norm"] = np.asarray(m2["grad_norm"])
np.savez("{out}", **out)
'''


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    return run_jax(JAX_STEP, str(tmp_path_factory.mktemp("jax") / "step.npz"))


def cpu_mesh(shape):
    return Mesh(np.arange(int(np.prod(shape))).reshape(shape), ("data", "model"), device="cpu")


def clone(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def place(params, mesh, rules=SH.ShardingRules()):
    specs = SH.sanitize_specs(SH.param_specs(params, rules), params, mesh)
    return place_tree(clone(params), tree_map(lambda s: Layout(mesh, s), specs))


def replicas_bit_equal(tree) -> bool:
    for st in tree_leaves(tree):
        first = {}
        for _, reg, blk in st.shards:
            if not torch.equal(first.setdefault(reg, blk), blk):
                return False
    return True


def single_step(cfg, params, batch, opt, n_micro=1):
    p = clone(params)
    for t in adamw.leaves(p):
        t.requires_grad_(True)
    return steps.make_train_step(cfg, opt, impl="reference", n_micro=n_micro)(
        p, adamw.init(opt, p), batch)


def sharded_step(cfg, params, batch, opt, mesh, rules=SH.ShardingRules(), n_micro=1):
    sp = place(params, mesh, rules)
    return steps.make_train_step(cfg, opt, impl="reference", mesh=mesh, rules=rules,
                                 n_micro=n_micro)(sp, adamw.init(opt, sp), batch)


def assert_close_runs(single, sharded, tol=1e-5):
    """Loss, grad norm and first moment relative to ``tol``; the parameters
    absolute; every replica bit-equal."""
    (p1, o1, m1), (p2, o2, m2) = single, sharded
    for k in ("loss", "lm_loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=tol, atol=tol, err_msg=k)
    for a, b in zip(adamw.leaves(o1["m"]), tree_leaves(o2["m"])):
        scale = float(a.abs().max()) + 1e-30
        assert float((b.gather() - a).abs().max()) <= tol * scale
    for a, b in zip(adamw.leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(b.gather().detach().numpy(), a.detach().numpy(), atol=tol,
                                   rtol=0)
    assert replicas_bit_equal(p2) and replicas_bit_equal(o2["m"])
    assert replicas_bit_equal(o2["v"]) and replicas_bit_equal(o2["master"])


def reduced(arch="qwen2-0.5b", **kw):
    return get_config(arch).reduced(**kw)


def test_sharded_train_step_matches_jax_sharded_step(jax_step):
    """The port's (2, 2) step against the JAX package's (2, 2) step on the
    same params and batch, at the JAX multidevice test's tolerance."""
    cfg = reduced()
    params = params_from_jax(unflatten(jax_step, "before"), cfg, device="cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in unflatten(jax_step, "batch").items()}
    batch["tokens"], batch["labels"] = batch["tokens"].long(), batch["labels"].long()
    p2, o2, m2 = sharded_step(cfg, params, batch, adamw.AdamWConfig(lr=1e-3), cpu_mesh((2, 2)))
    assert abs(float(m2["loss"]) - float(jax_step["loss"])) < 1e-3
    np.testing.assert_allclose(float(m2["grad_norm"]), float(jax_step["grad_norm"]),
                               rtol=1e-3)
    want = tree_leaves(params_from_jax(unflatten(jax_step, "after"), cfg, device="cpu"))
    got = tree_leaves(p2)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.gather().detach().numpy(), b.numpy(), atol=5e-3,
                                   rtol=1e-2)
    assert replicas_bit_equal(p2) and replicas_bit_equal(o2["m"])


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 2)])
@pytest.mark.parametrize("fsdp", [None, "data"])
def test_sharded_step_matches_single_device_fp32(shape, fsdp):
    """Data-parallel replicas, tensor parallelism and (with ``fsdp``) FSDP
    against the single-device step, with unequal mask counts per replica."""
    cfg = reduced()
    params = TM.init_params(cfg, seed=0, device="cpu")
    batch = TM.synth_batch(1, cfg, 16, 4, device="cpu")
    batch["mask"][0, 5:] = 0.0
    batch["mask"][3, :3] = 0.0
    opt = adamw.AdamWConfig(lr=1e-6)
    rules = SH.ShardingRules(fsdp_axis=fsdp)
    assert_close_runs(single_step(cfg, params, batch, opt),
                      sharded_step(cfg, params, batch, opt, cpu_mesh(shape), rules))


def test_microbatched_sharded_step_matches_single_device():
    """``n_micro=2``: microbatch j is the j-th slice of the global batch
    split over the replicas, so the step equals the single-device step with
    ``n_micro=2`` even where the microbatches' mask counts differ."""
    cfg = reduced()
    params = TM.init_params(cfg, seed=2, device="cpu")
    batch = TM.synth_batch(3, cfg, 12, 8, device="cpu")
    batch["mask"][:4, 6:] = 0.0
    opt = adamw.AdamWConfig(lr=1e-6)
    assert_close_runs(single_step(cfg, params, batch, opt, n_micro=2),
                      sharded_step(cfg, params, batch, opt, cpu_mesh((2, 2)), n_micro=2))


def test_loss_is_the_mean_over_the_global_mask():
    """Replicas with unequal mask counts: the sharded loss is the single
    device's mean over the whole mask, not the mean of the replicas' means
    (which differs here by far more than the tolerance)."""
    cfg = reduced()
    params = TM.init_params(cfg, seed=0, device="cpu")
    batch = TM.synth_batch(4, cfg, 16, 4, device="cpu")
    batch["mask"][:2, 2:] = 0.0  # replica 0 keeps 4 tokens, replica 1 all 32
    opt = adamw.AdamWConfig(lr=1e-6)
    single, sharded = single_step(cfg, params, batch, opt), sharded_step(
        cfg, params, batch, opt, cpu_mesh((2, 1)))
    halves = [TM.lm_loss(params, cfg, {k: v[i:i + 2] for k, v in batch.items()},
                         impl="reference")[1]["lm_loss"].item() for i in (0, 2)]
    assert abs(np.mean(halves) - float(single[2]["lm_loss"])) > 1e-2
    assert_close_runs(single, sharded)


def test_moe_aux_loss_uses_global_means():
    """Reduced granite on (2, 2): the Switch aux loss multiplies the global
    expert shares and mean probabilities (all-reduced over data), as one
    device does; the mean of the replicas' aux losses differs."""
    cfg = reduced("granite-moe-1b-a400m")
    params = TM.init_params(cfg, seed=0, device="cpu")
    batch = TM.synth_batch(1, cfg, 16, 4, device="cpu")
    opt = adamw.AdamWConfig(lr=1e-6)
    single = single_step(cfg, params, batch, opt)
    halves = [TM.lm_loss(params, cfg, {k: v[i:i + 2] for k, v in batch.items()},
                         impl="reference")[1]["aux_loss"].item() for i in (0, 2)]
    assert abs(np.mean(halves) - float(single[2]["aux_loss"])) > 1e-4
    assert_close_runs(single, sharded_step(cfg, params, batch, opt, cpu_mesh((2, 2))))


def test_sanitized_axis_is_replicated_and_all_reduced():
    """A vocabulary of 511 does not split over the model axis:
    ``sanitize_specs`` leaves the tied table ``P(None, "data")``, its
    lookup and logits run whole on each model rank, and its gradient is
    all-reduced over model (and reduce-scattered over data by the FSDP
    gather's backward)."""
    cfg = reduced(vocab_size=511)
    params = TM.init_params(cfg, seed=0, device="cpu")
    mesh = cpu_mesh((2, 2))
    assert place(params, mesh)["embed"]["table"].layout.spec == SH.P(None, "data")
    batch = TM.synth_batch(1, cfg, 16, 4, device="cpu")
    opt = adamw.AdamWConfig(lr=1e-6)
    assert_close_runs(single_step(cfg, params, batch, opt),
                      sharded_step(cfg, params, batch, opt, mesh))


def test_two_steps_keep_replicas_bit_equal():
    cfg = reduced()
    params = TM.init_params(cfg, seed=3, device="cpu")
    mesh = cpu_mesh((2, 2))
    opt = adamw.AdamWConfig(lr=1e-3)
    sp = place(params, mesh)
    state = adamw.init(opt, sp)
    step = steps.make_train_step(cfg, opt, impl="reference", mesh=mesh)
    for seed in (1, 2):
        sp, state, _ = step(sp, state, TM.synth_batch(seed, cfg, 16, 4, device="cpu"))
        assert replicas_bit_equal(sp) and replicas_bit_equal(state["v"])
    assert state["step"] == 2


def test_global_norm_counts_each_region_once():
    cfg = reduced()
    params = TM.init_params(cfg, seed=0, device="cpu")
    sp = place(params, cpu_mesh((2, 2)))
    np.testing.assert_allclose(float(adamw.global_norm(sp)), float(adamw.global_norm(params)),
                               rtol=1e-6)


def test_non_dividing_meshes_and_cuda_on_the_host_raise():
    """A tensor axis that divides no block width runs, as the JAX package
    runs it (``sanitize_specs`` leaves those blocks whole): qwen's q_dim of
    64 and d_ff of 128 at 3, granite's 4 experts at 8, seamless at 3, each
    step against one device; CUDA on the host and dense params raise."""
    opt = adamw.AdamWConfig(lr=1e-6)
    steps.make_train_step(reduced(), opt, impl="reference", mesh=cpu_mesh((1, 8)))  # split heads
    steps.make_train_step(reduced("seamless-m4t-medium"), opt, impl="reference",
                          mesh=cpu_mesh((2, 1)))
    for cfg, shape in ((reduced(), (1, 3)),
                       (reduced("granite-moe-1b-a400m", n_heads=8, n_kv_heads=8), (1, 8)),
                       (reduced("seamless-m4t-medium"), (1, 3))):
        params = TM.init_params(cfg, seed=0, device="cpu")
        params["embed"]["table"].mul_(0.05)
        batch = TM.synth_batch(1, cfg, 8, 2, device="cpu")
        if cfg.family == "encdec":
            batch["frames"] = torch.randn(2, cfg.prefix_len, cfg.d_model)
        assert_close_runs(single_step(cfg, params, batch, opt),
                          sharded_step(cfg, params, batch, opt, cpu_mesh(shape)))
    cfg = reduced()
    params = TM.init_params(cfg, seed=0, device="cpu")
    mesh = cpu_mesh((2, 2))
    sp = place(params, mesh)
    step = steps.make_train_step(cfg, opt, impl="cuda", mesh=mesh)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        step(sp, adamw.init(opt, sp), TM.synth_batch(1, cfg, 8, 4, device="cpu"))
    with pytest.raises(ValueError, match="ShardedTensor"):
        steps.make_train_step(cfg, opt, impl="reference", mesh=mesh)(
            params, adamw.init(opt, params), TM.synth_batch(1, cfg, 8, 4, device="cpu"))


def test_cache_and_rule_helpers_equal_jax():
    """``cache_specs`` / ``cache_partition_specs`` are the JAX package's with
    each group's stack dim dropped; ``shardings_for_cell`` its rules."""
    import jax
    from repro.configs import ARCHS as JARCHS
    from repro.parallel import steps as jsteps
    for arch in ("qwen2-0.5b", "granite-moe-1b-a400m", "llama-7b"):
        jcfg, tcfg = JARCHS[arch].reduced(), get_config(arch).reduced()
        jshapes = jsteps.cache_specs(jcfg, 4, 32)
        tshapes = steps.cache_specs(tcfg, 4, 32)
        jleaves = [x for g in jshapes for x in jax.tree.leaves(g)]
        want = [tuple(x.shape[1:]) for x in jleaves for _ in range(x.shape[0])]
        got = [tuple(x.shape) for x in tree_leaves(tshapes)]
        assert sorted(got) == sorted(want) and len(got) == 2 * jcfg.num_layers
        for multi_pod in (False, True):
            jr = jsteps.shardings_for_cell(jcfg, None, multi_pod=multi_pod)
            tr = steps.shardings_for_cell(tcfg, None, multi_pod=multi_pod)
            assert (jr.tp_axis, jr.fsdp_axis, jr.dp_axes, jr.pod_axis) == (
                tr.tp_axis, tr.fsdp_axis, tr.dp_axes, tr.pod_axis)
            jspecs = [tuple(s)[1:] for s, x in zip(jax.tree.leaves(
                jsteps.cache_partition_specs(jshapes, jr),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)), jleaves)
                for _ in range(x.shape[0])]
            tspecs = [tuple(s) for s in tree_leaves(steps.cache_partition_specs(tshapes, tr))]
            assert sorted(map(repr, tspecs)) == sorted(map(repr, jspecs))
        assert all(x.device.type == "meta" for x in tree_leaves(tshapes))
