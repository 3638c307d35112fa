"""The port's dry run on H100 clusters (``launch/mesh.make_production_mesh``,
``launch/roofline.py``, ``launch/dryrun.py``) and the collective record
it reads (``parallel/collectives.RECORD``), against the JAX package.

No production-mesh cell runs here (a cell's step on 256 ranks takes tens
of seconds to minutes): ``run_cell`` runs reduced configs on a (2, 2) mesh
of ``meta`` ranks.  One JAX subprocess (4 forced host devices) compiles
the JAX package's train step of reduced qwen2-0.5b on (2, 2) as its dry
run lowers it, for ``memory_analysis().argument_size_in_bytes``, which the
port's argument bytes per device equal to the byte, less the 4-byte
step counter (an int32 array in JAX, a Python int in the port).  The
production meshes' id order is JAX's ``create_device_mesh`` on as many
host devices; the roofline's math is the JAX file's on the same inputs.
"""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import hw
from repro_torch.configs import ASSIGNED, SHAPES, ShapeSpec, get_config
from repro_torch.kernels import ref
from repro_torch.launch import dryrun as DR
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as TM
from repro_torch.parallel import collectives as C
from repro_torch.parallel.layout import Mesh, tree_leaves
from test_torch_tp_step import run_jax

META = torch.device("meta")

JAX_MEMORY = '''
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCHS
from repro.models import init_params
from repro.models import model as MDL
from repro.optim import adamw
from repro.parallel import ctx
from repro.parallel import sharding as SH
from repro.parallel.compat import auto_axis_types, make_mesh
from repro.parallel.steps import make_train_step

cfg = ARCHS["qwen2-0.5b"].reduced()
mesh = make_mesh((2, 2), ("data", "model"), axis_types=auto_axis_types(2))
rules = SH.ShardingRules()
ps = jax.eval_shape(lambda k: init_params(k, cfg), jax.random.PRNGKey(0))
pspecs = SH.sanitize_specs(SH.param_specs(ps, rules), ps, mesh)
opt_cfg = adamw.AdamWConfig()
os_ = jax.eval_shape(lambda p: adamw.init(opt_cfg, p), ps)
ospecs = SH.sanitize_specs(SH.opt_state_specs(pspecs, rules, ps, pod_size=2), os_, mesh)
ns = lambda s: NamedSharding(mesh, s)
ins = MDL.input_specs(cfg, 32, 8, "train")
bsh = jax.tree.map(lambda x: ns(P("data", *([None] * (x.ndim - 1)))), ins)
def step(*a):
    with ctx.use(mesh, ("data",), rules.tp_axis):
        return make_train_step(cfg, opt_cfg, impl="reference", remat=True)(*a)
j = jax.jit(step, in_shardings=(jax.tree.map(ns, pspecs), jax.tree.map(ns, ospecs), bsh),
            out_shardings=(jax.tree.map(ns, pspecs), jax.tree.map(ns, ospecs), None),
            donate_argnums=(0, 1))
ma = j.lower(ps, os_, ins).compile().memory_analysis()
np.savez("{out}", argument=np.int64(ma.argument_size_in_bytes),
         alias=np.int64(ma.alias_size_in_bytes))
'''


@pytest.fixture(scope="module")
def jax_memory(tmp_path_factory):
    return run_jax(JAX_MEMORY, str(tmp_path_factory.mktemp("jax") / "memory.npz"))


def meta_mesh(shape=(2, 2), names=("data", "model")):
    return Mesh(np.arange(int(np.prod(shape))).reshape(shape), names, device=lambda i: META)


def reduced_cell(kind, cfg=None, *, batch=8, seq=32, **kw):
    cfg = cfg or get_config("qwen2-0.5b").reduced()
    return DR.run_cell(DR.CellSpec("qwen2-0.5b", "reduced", False), cfg=cfg,
                       shape=ShapeSpec("reduced", seq, batch, kind), mesh=meta_mesh(),
                       save=False, **kw)


# ------------------------------------------------------------------ mesh

@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_equals_jax(multi_pod):
    """Shape, axis names and id order of the JAX package's production mesh:
    ``jax.make_mesh``'s ``create_device_mesh`` on as many host devices
    (stand-ins with ids, as ``make_mesh`` passes ``jax.devices()``)."""
    from jax.experimental import mesh_utils
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = [types.SimpleNamespace(id=i, platform="cpu", device_kind="cpu", process_index=0)
            for i in range(int(np.prod(shape)))]
    want = np.vectorize(lambda d: d.id)(mesh_utils.create_device_mesh(shape, devs))
    mesh = make_production_mesh(multi_pod)
    assert mesh.axis_names == names and tuple(mesh.devices.shape) == shape
    assert np.array_equal(mesh.devices, want)
    assert {mesh.torch_device(i) for i in mesh.device_ids} == {META}


def test_production_mesh_nodes():
    """Node-major ids, 8 a node, the model axis innermost: a 16-wide model
    group spans two nodes, a data group 16, a pod group (stride 256) 2."""
    mesh = make_production_mesh(True)
    spans = {ax: {len({i // C.NODE_CARDS for i in g}) for g in C.groups(mesh, ax)}
             for ax in mesh.axis_names}
    assert spans == {"model": {2}, "data": {16}, "pod": {2}} and C.NODE_CARDS == 8


def test_production_mesh_places_no_ids_on_a_card_unasked():
    for device in ("cuda", "cpu", torch.device("cuda", 0)):
        with pytest.raises(ValueError, match="meta"):
            make_production_mesh(device=device)
    mesh = make_production_mesh(device=lambda i: torch.device("cpu"))
    assert mesh.size == 256 and mesh.torch_device(255).type == "cpu"


# -------------------------------------------------------------- roofline

TERMS = [(3.1e12, 2.2e11, 4.0e9, 2.5e15, 256), (1e9, 8e11, 0.0, 1e12, 512),
         (5e14, 1e10, 9e10, 0.0, 256), (0.0, 0.0, 0.0, 0.0, 1)]


@pytest.mark.parametrize("flops,hbm,wire,mf,n", TERMS)
def test_roofline_terms_equal_jax(flops, hbm, wire, mf, n):
    from repro import hw as jhw
    from repro.launch import roofline as JRL
    got = RL.RooflineTerms(flops, hbm, wire, hw.H100, model_flops_total=mf, n_chips=n)
    want = JRL.RooflineTerms(flops, hbm, wire, jhw.H100, model_flops_total=mf, n_chips=n)
    assert got.row() == want.row() and got.bound_s == want.bound_s


def test_wire_bytes_and_model_flops_equal_jax():
    from repro.configs import get_config as jget
    from repro.launch import roofline as JRL
    assert RL.COLLECTIVES == JRL.COLLECTIVES
    for kind in RL.COLLECTIVES:
        for k in (1, 2, 16, 32):
            assert RL._wire_bytes(kind, 1 << 20, k) == JRL._wire_bytes(kind, 1 << 20, k)
    for arch in ASSIGNED:
        for s in SHAPES.values():
            assert RL.model_flops(get_config(arch), s.kind, s.global_batch, s.seq_len) == \
                JRL.model_flops(jget(arch), s.kind, s.global_batch, s.seq_len)


def test_collective_stats_price_each_link():
    record = {("all-reduce", 1000, 16, 2): 3, ("all-gather", 4000, 8, 1): 2,
              ("reduce-scatter", 4000, 16, 16): 1}
    st = RL.collective_stats(record)
    assert st.counts == {"all-reduce": 3, "all-gather": 2, "reduce-scatter": 1}
    assert st.bytes_by_kind == {"all-reduce": 3000.0, "all-gather": 8000.0,
                                "reduce-scatter": 4000.0}
    ar, ag, rs = 2 * 15 / 16 * 1000 * 3, 7 / 8 * 4000 * 2, 15 / 16 * 4000
    assert st.total_wire_bytes == pytest.approx(ar + ag + rs)
    ratio = hw.H100.ici_link_bw / hw.H100.dcn_bw
    assert RL.link_weighted_wire_bytes(record) == pytest.approx(ar * ratio + ag + rs * ratio)


# ----------------------------------------------------- collective record

def test_the_record_counts_calls_and_their_duals():
    """One entry per call, not per group; an all-gather's backward is a
    reduce-scatter of the same payload, an all-reduce's an all-reduce; a
    max, a group of one and a call under no_grad record no backward."""
    mesh = Mesh(np.arange(4).reshape(2, 2), ("data", "model"), device="cpu")
    xs = {r: torch.ones(3, 5, requires_grad=True) for r in mesh.device_ids}
    C.reset_stats()
    g = C.all_gather(xs, mesh, "model", 1)
    s = C.all_reduce({r: v * 2 for r, v in g.items()}, mesh, "data")
    C.all_reduce({r: v.detach() for r, v in s.items()}, mesh, "model", op="max")
    C.all_gather(xs, Mesh(np.arange(4).reshape(4, 1), ("data", "model"), device="cpu"),
                 "model", 0)
    forward = dict(C.RECORD)
    assert forward == {("all-gather", 120, 2, 1): 1, ("all-reduce", 120, 2, 1): 2}
    sum(v.sum() for v in s.values()).backward()
    assert dict(C.RECORD) == {("all-gather", 120, 2, 1): 1, ("all-reduce", 120, 2, 1): 3,
                              ("reduce-scatter", 120, 2, 1): 1}
    big = make_production_mesh(device=lambda i: torch.device("cpu"))
    C.reset_stats()
    C.all_reduce({r: torch.zeros(1) for r in big.device_ids}, big, "model")
    C.all_reduce({r: torch.zeros(1) for r in big.device_ids}, big, "data")
    assert dict(C.RECORD) == {("all-reduce", 4, 16, 2): 1, ("all-reduce", 4, 16, 16): 1}


# ------------------------------------------------------------ the dry run

def test_meta_params_draw_nothing():
    cfg = get_config("qwen2-0.5b").reduced()
    meta, real = TM.init_params(cfg, device="meta"), TM.init_params(cfg, device="cpu")
    for a, b in zip(tree_leaves(meta), tree_leaves(real)):
        assert a.is_meta and a.shape == b.shape and a.dtype == b.dtype


def test_grouped_ffn_reference_on_meta_counts_every_row():
    """On ``meta`` the group sizes are unknown: the N rows split evenly over
    the experts, so the reference runs N rows and reads each expert once."""
    assert ref.group_ends(torch.empty(4, dtype=torch.int32, device=META), 10) == [2, 5, 7, 10]
    assert ref.group_ends(torch.tensor([3, 0, 5]), 8) == [3, 3, 8]
    xs = torch.empty(10, 8, device=META)
    w = torch.empty(4, 8, 16, device=META)
    with DR.CostMode() as m:
        out = ref.grouped_ffn_ref(xs, torch.empty(4, dtype=torch.int32, device=META), w, w,
                                  torch.empty(4, 16, 8, device=META))
    assert out.shape == (10, 8) and m.flops == 3 * 2 * 10 * 8 * 16


def test_cost_mode_counts_flop_counter_modes_flops():
    """The flops of a reduced sharded train step on (2, 2) under
    ``CostMode`` equal ``FlopCounterMode``'s total on the same step."""
    cfg = get_config("qwen2-0.5b").reduced()
    mesh = meta_mesh()
    rules, b_axes, _ = DR._variant_setup(DR.CellSpec("x", "x", False), mesh)
    shape = ShapeSpec("reduced", 32, 8, "train")
    got = DR.measure(cfg, shape, mesh, rules, b_axes)
    srules, params, opt, args = DR._setup(cfg, shape, mesh, rules, b_axes)
    with FlopCounterMode(display=False) as fc:
        DR._call(cfg, shape, mesh, srules, params, opt, args, 1)
    assert got["flops"] == fc.get_total_flops() > 0


def test_argument_bytes_equal_jax_memory_analysis(jax_memory):
    r = reduced_cell("train")
    assert r["memory"]["argument_bytes"] + 4 == int(jax_memory["argument"])
    assert r["memory"]["alias_bytes"] + 4 == int(jax_memory["alias"])
    assert r["memory"]["peak_per_device"] > r["memory"]["argument_bytes"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_superblock_extrapolation_is_exact(kind):
    """A 3-superblock reduced config: runs at 1 and 2 superblocks
    extrapolated equal one full-depth run in flops, bytes and every
    collective's count, exactly."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), n_superblocks=3, num_layers=3)
    probed, full = (reduced_cell(kind, cfg, with_probes=p) for p in (True, False))
    assert len(probed["probes"]) == 2 and len(full["probes"]) == 1
    for key in ("flops_corrected", "bytes_unfused_corrected"):
        assert probed["cost"][key] == full["cost"][key] > 0
    assert probed["collectives"]["record"] == full["collectives"]["record"]
    assert probed["collectives"]["counts"] == full["collectives"]["counts"]
    assert probed["cost"]["flops_raw"] < probed["cost"]["flops_corrected"]


def test_artifact_fields_and_the_cli(tmp_path, monkeypatch, capsys):
    """A cell's artifact has the JAX artifact's fields (``run_s`` for
    ``lower_s`` and ``compile_s``), is written under ``ARTIFACTS`` and read
    back; the CLI prints a ``SKIP`` line per skipped cell."""
    monkeypatch.setattr(DR, "ARTIFACTS", tmp_path)
    cell = DR.CellSpec("qwen2-0.5b", "reduced", False)
    shape = ShapeSpec("reduced", 32, 4, "decode")
    cfg = get_config("qwen2-0.5b").reduced()
    r = DR.run_cell(cell, cfg=cfg, shape=shape, mesh=meta_mesh())
    assert json.loads((tmp_path / f"{cell.key}.json").read_text()) == json.loads(json.dumps(r))
    assert DR.run_cell(cell, cfg=cfg, shape=shape, mesh=meta_mesh())["run_s"] == r["run_s"]
    assert set(r) >= {"cell", "skipped", "n_chips", "run_s", "memory", "cost", "collectives",
                      "probes", "model_flops", "roofline", "terms"}
    assert set(r["memory"]) >= {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
                                "peak_per_device", "hbm_per_device", "cache_layout"}
    assert r["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert r["cost"]["flops_corrected"] > 0 and r["memory"]["peak_per_device"] > 0
    assert r["n_chips"] == 4 and r["memory"]["hbm_per_device"] == hw.H100.hbm_bytes
    assert set(r["collectives"]["counts"]) <= set(RL.COLLECTIVES)
    DR.main(["--arch", "qwen2-0.5b", "--shape", "long_500k"])
    out = capsys.readouterr().out
    assert out.count("SKIP qwen2-0.5b__long_500k__pod") == 2 and "all requested" in out


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_long_500k_cells_skip_as_jax(arch, multi_pod):
    """Full-attention configs skip ``long_500k`` with the JAX package's
    reason, before any mesh is built; the others run (not here)."""
    from repro.configs import cell_supported as jsupported
    from repro.configs import get_config as jget
    ok, why = jsupported(jget(arch), SHAPES["long_500k"])
    if ok:
        assert DR.cell_supported(get_config(arch), SHAPES["long_500k"]) == (True, "")
        return
    r = DR.run_cell(DR.CellSpec(arch, "long_500k", multi_pod), save=False)
    assert r == {"cell": dataclasses.asdict(DR.CellSpec(arch, "long_500k", multi_pod)),
                 "skipped": True, "why": why}
