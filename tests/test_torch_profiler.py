"""The port's profiler, checkpoint manager and profiled train step against the
JAX package's: ``ProfileTable`` lookups, ``calibrate``, ``fit_type_scales``,
the bench folds and the ``ProfileStore`` file on the same measurements
(exact equality: framework-free copies); ``profile_model`` on the CPU;
``lm_loss``, ``synth_batch`` and one ``make_train_step`` update against the
JAX package's on bridged weights (``test_torch_train.py``'s tolerances:
losses 1e-5 relative, parameters after an AdamW update at eps 1e-6 within
``PARAM_TOL``); checkpoints that round-trip bit for bit, bf16 leaves
included, also restored onto layouts and saved from them, and an fp32
checkpoint written by the JAX manager that restores bit for bit in the
port.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import hw as jhw
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import ARCHS as JARCHS
from repro.core import profiler as JPROF
from repro.core.plan import Cluster as JCluster
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.parallel.steps import make_train_step as jmake_train_step
from repro_torch import hw as thw
from repro_torch.checkpoint.manager import CheckpointManager as TCheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import profiler as TPROF
from repro_torch.core.plan import Cluster as TCluster
from repro_torch.models import model as TM
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel.layout import Layout, Mesh, P, ShardedTensor
from repro_torch.parallel.steps import make_train_step as tmake_train_step
from test_torch_train import PARAM_TOL, _np, _t, assert_trees_close, jax_params

# (kind, batch, seq, seconds): a grid with two token counts shared by two
# shapes (8 x 96 and 24 x 32 collapse), as measured tables have
ROWS = [("train", 2, 32, 0.011), ("train", 4, 32, 0.019), ("train", 4, 64, 0.041),
        ("train", 8, 96, 0.150), ("train", 24, 32, 0.170), ("inference", 2, 32, 0.004),
        ("inference", 4, 64, 0.012), ("inference", 8, 96, 0.050), ("generate", 4, 64, 0.300)]


def tables(asg_key="d1t1p1m1"):
    jt, tt = JPROF.ProfileTable("qwen2-0.5b", {}), TPROF.ProfileTable("qwen2-0.5b", {})
    for i, (kind, b, s, sec) in enumerate(ROWS):
        for t in (jt, tt):
            t.add(kind, b, s, sec, asg_key=asg_key if i % 2 else None)
            t.add(kind, b, s, sec * 1.1)  # a second sample: running means
    return jt, tt


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-1.3b"])
def test_table_fits_and_lookups_equal_jax(arch):
    """The same measurements give the same running means, interpolations
    and extrapolations, global fit and per-call-type scales."""
    jt, tt = tables()
    assert tt.entries == jt.entries and tt.counts == jt.counts and tt.by_asg == jt.by_asg
    for kind in ("train", "inference", "generate"):
        for b, s in ((1, 8), (4, 48), (8, 96), (16, 384), (64, 512)):
            assert tt.lookup(kind, b, s) == jt.lookup(kind, b, s)
            assert tt.lookup(kind, b, s, asg_key="d1t1p1m1", min_points=2) == \
                jt.lookup(kind, b, s, asg_key="d1t1p1m1", min_points=2)
    jcfg, tcfg = JARCHS[arch], get_config(arch)
    for jcl, tcl in ((JCluster(1, 1), TCluster(1, 1)),
                     (JCluster(1, 1, chip=jhw.H100), TCluster(1, 1, chip=thw.H100))):
        jprof, tprof = JPROF.calibrate(jcfg, jt, jcl), TPROF.calibrate(tcfg, tt, tcl)
        assert tprof.__dict__ == jprof.__dict__
        assert TPROF.fit_type_scales(tcfg, tt, tcl, tprof) == \
            JPROF.fit_type_scales(jcfg, jt, jcl, jprof)
    assert TPROF.SINGLE_DEV_KEY == JPROF.SINGLE_DEV_KEY


def test_bench_folds_equal_jax():
    jt, tt = JPROF.ProfileTable("m", {}), TPROF.ProfileTable("m", {})
    roll = {"batch": 8, "prompt_len": 32, "gen_len": 64, "tok_s": {"seed": 1e3, "fused": 2e3}}
    serve = {"workload": {"requests": 24, "mean_new": 10.0, "mean_prompt": 14.0},
             "continuous": {"wall_s": 0.6}}
    JPROF.fold_rollout_summary(jt, roll)
    JPROF.fold_serve_summary(jt, serve)
    TPROF.fold_rollout_summary(tt, roll)
    TPROF.fold_serve_summary(tt, serve)
    assert tt.to_json() == jt.to_json()


def test_profile_store_files_equal_jax(tmp_path):
    """The same entry written by each package's store is the same JSON; each
    store reads the other's file back to the same entry, and a stale entry
    or a foreign fingerprint reads as absent in the port as in the JAX
    package."""
    jt, tt = tables()
    jcl, tcl = JCluster(1, 1), TCluster(1, 1)
    jcfg, tcfg = JARCHS["qwen2-0.5b"], get_config("qwen2-0.5b")
    jprof, tprof = JPROF.calibrate(jcfg, jt, jcl), TPROF.calibrate(tcfg, tt, tcl)
    jentry = JPROF.ProfileEntry("qwen2-0.5b", "gpu-1xH100", 1000.0, jt, jprof,
                                JPROF.fit_type_scales(jcfg, jt, jcl, jprof), 1.25)
    tentry = TPROF.ProfileEntry("qwen2-0.5b", "gpu-1xH100", 1000.0, tt, tprof,
                                TPROF.fit_type_scales(tcfg, tt, tcl, tprof), 1.25)
    for pkg, store, entry in (("jax", JPROF.ProfileStore, jentry),
                              ("torch", TPROF.ProfileStore, tentry)):
        s = store(str(tmp_path / f"{pkg}.json"))
        s.put(entry)
        s.put(entry)  # a merge doubles every count
        s.save()
    files = {pkg: json.loads((tmp_path / f"{pkg}.json").read_text()) for pkg in ("jax", "torch")}
    assert files["torch"] == files["jax"]
    back = TPROF.ProfileStore(str(tmp_path / "jax.json")).get("qwen2-0.5b", "gpu-1xH100")
    assert back.to_json() == files["jax"]["entries"][0]
    assert back.cost_model(tcl).type_scales == tentry.type_scales
    assert TPROF.ProfileStore(str(tmp_path / "jax.json")).get(
        "qwen2-0.5b", "gpu-1xH100", max_age_s=1.0) is None
    assert TPROF.ProfileStore(str(tmp_path / "jax.json")).get("qwen2-0.5b") is None
    assert thw.fingerprint() == "cpu-1xcpu"  # this host has no card


def test_profile_model_on_cpu_calibrates_a_cost_model(tmp_path):
    """``profile_model`` times the port's train step and LM loss on the CPU
    over its grid (every point also an exact hit under the single-device
    key); ``profile_and_store`` fits and persists it, and loads it back on
    the second call instead of measuring again."""
    cfg = get_config("qwen2-0.5b").reduced()
    store = TPROF.ProfileStore(str(tmp_path / "p.json"))
    entry = TPROF.profile_and_store(cfg, store, TCluster(1, 1), batches=(2,), seqs=(8, 16),
                                    device="cpu")
    assert set(entry.table.entries) == {(k, 2, s) for k in ("train", "inference")
                                        for s in (8, 16)}
    assert all(v > 0 for v in entry.table.entries.values())
    assert set(entry.type_scales) == {"train", "inference"}
    assert entry.fingerprint == "cpu-1xcpu"
    again = TPROF.profile_and_store(cfg, TPROF.ProfileStore(str(tmp_path / "p.json")),
                                    TCluster(1, 1), device="cpu")
    assert again.to_json() == entry.to_json()
    calls = []
    assert TPROF.measure(lambda: calls.append(1), reps=3) >= 0 and len(calls) == 5


def test_lm_loss_and_train_step_match_jax():
    """``lm_loss`` on a ``synth_batch``-shaped batch (the JAX package's
    tokens and labels) and one ``make_train_step`` update with AdamW against
    the JAX package's on bridged weights."""
    jcfg, tcfg = JARCHS["qwen2-0.5b"].reduced(), get_config("qwen2-0.5b").reduced()
    jp, tp = jax_params(7)
    jb = JM.synth_batch(jax.random.PRNGKey(2), jcfg, 12, 3, "train")
    tb = {k: _t(v) for k, v in jb.items()}
    tb["tokens"], tb["labels"] = tb["tokens"].long(), tb["labels"].long()
    jloss, jaux = JM.lm_loss(jp, jcfg, jb)
    tloss, taux = TM.lm_loss(tp, tcfg, tb, impl="reference")
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(taux["lm_loss"].item(), float(jaux["lm_loss"]), rtol=1e-5)
    assert taux["aux_loss"].item() == float(jaux["aux_loss"]) == 0.0
    opt_j, opt_t = jadamw.AdamWConfig(eps=1e-6), tadamw.AdamWConfig(eps=1e-6)
    jp2, _, jst = jmake_train_step(jcfg, opt_j)(jp, jadamw.init(opt_j, jp), jb)
    for p in tadamw.leaves(tp):
        p.requires_grad_(True)
    tp2, tstate, tst = tmake_train_step(tcfg, opt_t, impl="reference")(
        tp, tadamw.init(opt_t, tp), tb)
    for k in ("loss", "lm_loss", "grad_norm"):
        np.testing.assert_allclose(float(tst[k]), float(jst[k]), rtol=1e-5, err_msg=k)
    assert_trees_close(tp2, jp2, atol=PARAM_TOL)
    assert tstate["step"] == 1
    tsb = TM.synth_batch(4, tcfg, 12, 3, device="cpu")
    assert tsb["tokens"].shape == tsb["labels"].shape == (3, 12)
    assert torch.equal(tsb["mask"], torch.ones(3, 12))
    assert torch.equal(TM.synth_batch(4, tcfg, 12, 3, device="cpu")["tokens"], tsb["tokens"])


def test_microbatched_train_step_matches_one_batch():
    """``n_micro=2`` accumulates the two halves' fp32 gradients: the mean
    loss and the update equal one full-batch step's (the loss is a mean
    per microbatch of equal token counts)."""
    tcfg = get_config("qwen2-0.5b").reduced()
    opt = tadamw.AdamWConfig(eps=1e-6)
    batch = TM.synth_batch(5, tcfg, 8, 4, device="cpu")
    runs = []
    for n_micro in (1, 2):
        _, tp = jax_params(9)
        for p in tadamw.leaves(tp):
            p.requires_grad_(True)
        tp, _, st = tmake_train_step(tcfg, opt, impl="reference", n_micro=n_micro)(
            tp, tadamw.init(opt, tp), batch)
        runs.append((st, tadamw.leaves(tp)))
    (s1, p1), (s2, p2) = runs
    np.testing.assert_allclose(float(s2["loss"]), float(s1["loss"]), rtol=1e-5)
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(_np(a), _np(b), atol=PARAM_TOL)


def port_tree(seed):
    """A port parameter and AdamW tree: fp32 and bf16 tensors, an int
    tensor, the step counter as a Python int, a tensor that requires
    grad."""
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(4, 3, generator=g).requires_grad_(True),
              "layers": [{"b": torch.randn(5, generator=g).to(torch.bfloat16)},
                         {"b": torch.randn(5, generator=g).to(torch.bfloat16)}],
              "idx": torch.arange(6, dtype=torch.int32)}
    return params, tadamw.init(tadamw.AdamWConfig(state_dtype="bfloat16"),
                               {"w": params["w"].detach(), "layers": params["layers"]})


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_round_trip_is_bit_identical(tmp_path, async_save):
    params, opt = port_tree(1)
    opt["step"] = 7
    mgr = TCheckpointManager(tmp_path, keep=2)
    trees = {"actor": params, "actor_opt": opt}
    for step in (1, 2, 3):
        if async_save:
            mgr.save_async(step, trees, extra={"iteration": step})
        else:
            mgr.save(step, trees, extra={"iteration": step})
    mgr.wait()
    assert mgr.list_steps() == [2, 3] and mgr.latest_step() == 3
    manifest = json.loads((tmp_path / "step_000000003" / "manifest.json").read_text())
    assert manifest["models"]["actor"]["layers/0/b"]["dtype"] == "bfloat16"
    template = {"actor": port_tree(2)[0], "actor_opt": port_tree(2)[1]}
    step, got, extra = mgr.restore(template)
    assert step == 3 and extra == {"iteration": 3}
    for a, b in zip(tadamw.leaves(got), tadamw.leaves(trees)):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b.detach())
        else:
            assert a == b and type(a) is type(b)
    assert got["actor"]["w"].requires_grad and not got["actor_opt"]["m"]["w"].requires_grad
    # restored onto layouts (as ``jax.device_put(arr, sharding)``): every
    # leaf a ShardedTensor on its layout, bit-equal after gather(); saved
    # again (the manager gathers it) it restores bit for bit
    mesh = Mesh([[0, 1], [2, 3]], ("data", "model"), device="cpu")
    lay = {"w": Layout(mesh, P("data", None)),
           "layers": [{"b": Layout(mesh, P())}, {"b": Layout(mesh, P(None))}],
           "idx": Layout(mesh, P("model"))}
    step, placed, _ = mgr.restore({"actor": template["actor"]}, shardings={"actor": lay})
    assert step == 3
    for leaf, want, layout in zip(tadamw.leaves(placed["actor"]), tadamw.leaves(params),
                                  tadamw.leaves(lay)):
        assert isinstance(leaf, ShardedTensor) and leaf.layout == layout
        assert leaf.dtype == want.dtype and torch.equal(leaf.gather(), want.detach())
    mgr.save(4, {"actor": placed["actor"]})
    _, again, _ = mgr.restore({"actor": params}, step=4)
    for a, b in zip(tadamw.leaves(again["actor"]), tadamw.leaves(params)):
        assert torch.equal(a, b.detach())


def test_jax_fp32_checkpoint_restores_bit_identical(tmp_path):
    """An fp32 checkpoint the JAX manager writes restores bit for bit in the
    port, into the port's tensors; the port's fp32 checkpoint restores bit
    for bit in the JAX package."""
    rng = np.random.default_rng(3)
    tree = {"embed": {"table": rng.standard_normal((6, 4)).astype(np.float32)},
            "layers": [{"w": rng.standard_normal((4, 4)).astype(np.float32)} for _ in range(2)]}
    JCheckpointManager(tmp_path / "jax").save(4, {"actor": jax.tree.map(jnp.asarray, tree)},
                                             extra={"iteration": 4})
    template = {"actor": jax.tree.map(lambda a: torch.zeros(a.shape), tree)}
    step, got, extra = TCheckpointManager(tmp_path / "jax").restore(template)
    assert step == 4 and extra == {"iteration": 4}
    for a, b in zip(tadamw.leaves(got["actor"]), jax.tree.leaves(tree)):
        assert a.dtype == torch.float32 and np.array_equal(a.numpy(), b)
    TCheckpointManager(tmp_path / "torch").save(5, got)
    _, back, _ = JCheckpointManager(tmp_path / "torch").restore(
        {"actor": jax.tree.map(jnp.asarray, tree)})
    for a, b in zip(jax.tree.leaves(back["actor"]), jax.tree.leaves(tree)):
        assert np.array_equal(np.asarray(a), b)


def test_jax_bf16_checkpoint_restores_bit_identical(tmp_path):
    """A bf16 checkpoint the JAX manager writes (``np.save`` of an
    ``ml_dtypes.bfloat16`` array, which loads back as dtype ``|V2``)
    restores bit for bit in the port, into bf16 tensors, beside an fp32
    leaf of the same tree.  The JAX manager's own bf16 restore is not
    the yardstick: it raises on ``|V2``."""
    rng = np.random.default_rng(4)
    tree = {"embed": {"table": rng.standard_normal((6, 4)).astype(np.float32)},
            "layers": [{"w": rng.standard_normal((4, 4)).astype(np.float32)} for _ in range(2)]}
    jtree = {"embed": {"table": jnp.asarray(tree["embed"]["table"], jnp.bfloat16)},
             "layers": [{"w": jnp.asarray(tree["layers"][0]["w"], jnp.bfloat16)},
                        {"w": jnp.asarray(tree["layers"][1]["w"])}]}
    JCheckpointManager(tmp_path).save(2, {"actor": jtree})
    manifest = json.loads((tmp_path / "step_000000002" / "manifest.json").read_text())
    assert manifest["models"]["actor"]["embed/table"]["dtype"] == "bfloat16"
    assert np.load(tmp_path / "step_000000002" /
                   manifest["models"]["actor"]["embed/table"]["file"]).dtype.kind == "V"
    template = {"actor": jax.tree.map(
        lambda a: torch.zeros(a.shape, dtype=torch.bfloat16 if a.dtype == jnp.bfloat16
                              else torch.float32), jtree)}
    assert TCheckpointManager(tmp_path).valid_step(2)
    step, got, _ = TCheckpointManager(tmp_path).restore(template)
    assert step == 2
    for a, b in zip(tadamw.leaves(got["actor"]), jax.tree.leaves(jtree)):
        want = np.asarray(b)
        if want.dtype == np.float32:
            assert a.dtype == torch.float32 and np.array_equal(a.numpy(), want)
        else:
            assert a.dtype == torch.bfloat16
            assert np.array_equal(a.view(torch.int16).numpy().view(np.uint16),
                                  want.view(np.uint16))
