"""The port's sharding rules against the JAX package's ``parallel/sharding.py``.

The JAX tree stacks each layer group on a leading dim
(``groups[g]["b{i}"]``) where the port keeps one dict per layer, so a port
leaf's spec must be the JAX leaf's spec with the stack dim dropped.  Shapes
come from ``jax.eval_shape`` of the JAX package's ``init_params`` at full
width (nothing is allocated: the port's side holds ``meta`` tensors of the
same shapes) and, reduced, from the port's own ``init_params``.  Held for
the four ported configs and llama-7b: ``param_specs`` under three rule sets
(tp + fsdp, tp only, a pod axis), ``sanitize_specs`` on meshes whose model
axis (16, 3) leaves odd vocabularies undivided, ``opt_state_specs`` (the
JAX function applied to the same unstacked input) and ``batch_specs``.
"""

import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import model as JM
from repro.parallel import sharding as JSH
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.models import model as TM
from repro_torch.parallel import sharding as TSH
from repro_torch.parallel.layout import Layout, Mesh, P, tree_leaves, tree_map

ARCHS = ("qwen2-0.5b", "granite-moe-1b-a400m", "mamba2-1.3b", "recurrentgemma-9b", "llama-7b")
RULES = {"tp+fsdp": dict(), "tp": dict(fsdp_axis=None),
         "pod": dict(pod_axis="pod", dp_axes=("data",))}


def unstack(jtree, cfg, fn):
    """The JAX ``init_params``-shaped tree in the port's structure: each
    group's stacked leaf split into its layers through ``fn(leaf)`` (one
    value per layer, shared), the rest through ``fn`` unchanged."""
    groups = [(cfg.superblock, cfg.n_superblocks)] + ([(cfg.tail, 1)] if cfg.tail else [])
    layers = []
    for (specs, n), group in zip(groups, jtree["groups"]):
        for _ in range(n):
            for i in range(len(specs)):
                layers.append(jax.tree.map(fn, group[f"b{i}"],
                                           is_leaf=lambda x: isinstance(x, JSH.P)))
    out = {k: v for k, v in jtree.items() if k != "groups"}
    out["layers"] = layers
    return out


def jax_shapes(arch, reduced, head="lm"):
    cfg = JARCHS[arch].reduced() if reduced else JARCHS[arch]
    return cfg, jax.eval_shape(lambda k: JM.init_params(k, cfg, head=head),
                               jax.random.PRNGKey(0))


def port_meta_tree(cfg, shapes):
    """The port's tree of ``meta`` tensors with the JAX shapes less the
    stack dim."""
    def meta(s, stacked):
        return torch.empty(s.shape[1:] if stacked else s.shape, device="meta")
    tree = unstack(shapes, cfg, lambda s: meta(s, True))
    return {k: (v if k == "layers" else jax.tree.map(lambda s: meta(s, False), v))
            for k, v in tree.items()}


def dropped(jspecs, cfg):
    """JAX specs in the port's structure, stacked specs without their first
    entry, each as a plain tuple."""
    tree = unstack(jspecs, cfg, lambda p: tuple(p)[1:])
    return {k: (v if k == "layers" else jax.tree.map(tuple, v,
                                                      is_leaf=lambda x: isinstance(x, JSH.P)))
            for k, v in tree.items()}


def as_tuples(tree):
    return tree_map(tuple, tree)


CASES = [pytest.param(a, r, id=f"{a}-{'reduced' if r else 'full'}")
         for a in ARCHS for r in (False, True)]


@pytest.mark.parametrize("arch,reduced", CASES)
@pytest.mark.parametrize("rules", sorted(RULES))
def test_param_specs_equal_jax_without_the_stack_dim(arch, reduced, rules):
    jcfg, shapes = jax_shapes(arch, reduced)
    tcfg = TARCHS[arch].reduced() if reduced else TARCHS[arch]
    jspecs = JSH.param_specs(shapes, JSH.ShardingRules(**RULES[rules]))
    tree = port_meta_tree(tcfg, shapes)
    got = as_tuples(TSH.param_specs(tree, TSH.ShardingRules(**RULES[rules])))
    assert got == dropped(jspecs, jcfg)
    assert all(isinstance(p, P) for p in tree_leaves(
        TSH.param_specs(tree, TSH.ShardingRules())))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_tree_matches_the_unstacked_jax_shapes(arch):
    """The reduced port ``init_params`` tree has exactly the structure and
    shapes the tests above build from the JAX shapes, so its specs are the
    same too; for the value head as well."""
    for head in ("lm", "value"):
        jcfg, shapes = jax_shapes(arch, True, head=head)
        tcfg = TARCHS[arch].reduced()
        params = TM.init_params(tcfg, seed=0, device="cpu", head=head)
        want = port_meta_tree(tcfg, shapes)
        assert tree_map(lambda t: tuple(t.shape), params) == \
            tree_map(lambda t: tuple(t.shape), want)
        assert as_tuples(TSH.param_specs(params, TSH.ShardingRules())) == \
            dropped(JSH.param_specs(shapes, JSH.ShardingRules()), jcfg)


def test_moe_experts_take_the_expert_axis():
    """granite's expert weights (E, D, F) / (E, F, D): EP over the tp axis,
    FSDP on the D dim, as in JAX."""
    params = TM.init_params(TARCHS["granite-moe-1b-a400m"].reduced(), seed=0, device="cpu")
    specs = TSH.param_specs(params, TSH.ShardingRules())
    ffn = specs["layers"][0]["ffn"]
    assert ffn["w_gate"] == ("model", "data", None) == ffn["w_in"]
    assert ffn["w_out"] == ("model", None, "data")
    assert ffn["router"]["w"] == ("data", None)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_shape", [(2, 16), (2, 3)], ids=["model16", "model3"])
def test_sanitize_specs_equals_jax(arch, mesh_shape):
    """Axes that do not divide a dim are dropped, as JAX drops them (the
    JAX function reads only ``mesh.shape``); at full width, where the odd
    vocabularies (granite 49155, mamba2 50280) meet a 16-way axis."""
    jcfg, shapes = jax_shapes(arch, False)
    tcfg = TARCHS[arch]
    fake = types.SimpleNamespace(shape=dict(zip(("data", "model"), mesh_shape)))
    want = JSH.sanitize_specs(JSH.param_specs(shapes, JSH.ShardingRules()), shapes, fake)
    mesh = Mesh(np.arange(np.prod(mesh_shape)).reshape(mesh_shape), ("data", "model"),
                device="cpu")
    tree = port_meta_tree(tcfg, shapes)
    got = TSH.sanitize_specs(TSH.param_specs(tree, TSH.ShardingRules()), tree, mesh)
    assert as_tuples(got) == dropped(want, jcfg)
    table = got["embed"]["table"]
    assert table[0] == ("model" if tcfg.vocab_size % mesh_shape[1] == 0 else None)
    # every sanitized spec lays its leaf out on the mesh
    for spec, leaf in zip(tree_leaves(got), tree_leaves(tree)):
        regions = Layout(mesh, spec).regions(leaf.shape)
        assert len(regions) == mesh.size


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("rules", sorted(RULES))
def test_opt_state_specs_equal_jax(arch, rules):
    """``opt_state_specs`` mirrors the param specs (ZeRO-1 over the pod axis
    widens the first free divisible dim): the JAX function and the port's
    on the same unstacked specs and shapes give the same trees, with and
    without shapes."""
    jcfg, shapes = jax_shapes(arch, True)
    tcfg = TARCHS[arch].reduced()
    params = TM.init_params(tcfg, seed=0, device="cpu")
    jr, tr = JSH.ShardingRules(**RULES[rules]), TSH.ShardingRules(**RULES[rules])
    tspecs = TSH.param_specs(params, tr)
    jspecs_port = tree_map(lambda p: JSH.P(*p), tspecs)
    jshapes = tree_map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape), np.float32), params)
    for kw in (dict(params_shapes=params), dict()):
        got = TSH.opt_state_specs(tspecs, tr, **kw)
        jkw = dict(params_shapes=jshapes) if kw else {}
        want = JSH.opt_state_specs(jspecs_port, jr, **jkw)
        assert tuple(got["step"]) == tuple(want["step"])
        for k in ("m", "v", "master"):
            assert as_tuples(got[k]) == jax.tree.map(
                tuple, want[k], is_leaf=lambda x: isinstance(x, JSH.P))
    if rules != "pod":
        assert as_tuples(TSH.opt_state_specs(tspecs, tr)["m"]) == dropped(
            JSH.param_specs(shapes, jr), jcfg)


@pytest.mark.parametrize("rules", sorted(RULES))
def test_batch_specs_equal_jax(rules):
    batch = {"tokens": np.zeros((8, 16), np.int32), "mask": np.zeros((8, 16, 1), np.float32)}
    want = JSH.batch_specs(batch, JSH.ShardingRules(**RULES[rules]))
    got = TSH.batch_specs(batch, TSH.ShardingRules(**RULES[rules]))
    assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}


def test_param_shardings_lay_every_leaf_out():
    """``param_shardings`` gives one ``Layout`` per leaf on the mesh; placed
    and gathered, every leaf of reduced llama comes back bit for bit."""
    from repro_torch.parallel.layout import place_tree
    params = TM.init_params(TARCHS["llama-7b"].reduced(), seed=0, device="cpu")
    mesh = Mesh(np.arange(4).reshape(2, 2), ("data", "model"), device="cpu")
    lays = TSH.param_shardings(mesh, params, TSH.ShardingRules())
    assert all(isinstance(x, Layout) and x.mesh == mesh for x in tree_leaves(lays))
    for a, b in zip(tree_leaves(place_tree(params, lays)), tree_leaves(params)):
        assert torch.equal(a.gather(), b)
