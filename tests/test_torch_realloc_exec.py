"""The port's reallocation executor (``parallel/realloc_exec.py`` on
``parallel/layout.py``) against the JAX package's, on the host.

One JAX subprocess per module (8 forced host devices) runs a table of
(tree, source specs, destination specs) cases through the JAX executor:
same-mesh, cross-mesh, partial, pure-alias, size-1 axes, trailing Nones,
tuple axes, 8 devices, one device to a mesh and back, bf16 and int leaves.
(A move onto the same devices in another order, which the JAX executor's
jitted identity refuses, is held in the port alone.)  The port runs the
same table on logical CPU meshes and must give equal ``n_moved``, ``n_aliased``, ``moved_bytes`` and
``total_bytes``, alias exactly the leaves JAX aliases (by identity), and
gather every leaf bit-equal to the JAX array's bytes.  The counterparts of
``test_realloc_fastpath.py``'s donate, cross-mesh, partial and pure-alias
tests and of ``test_multidevice.py::test_reshard_preserves_values_across_shardings``
follow.
"""

import hashlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.parallel import realloc_exec as RX
from repro_torch.parallel.layout import Layout, Mesh, P, ShardedTensor, tree_leaves

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# name -> (logical device ids, axis names)
MESHES = {
    "A": ([[0, 1], [2, 3]], ("data", "model")),
    "Aperm": ([[1, 0], [3, 2]], ("data", "model")),
    "B": ([0, 1, 2, 3], ("x",)),
    "C": ([[0, 1, 2, 3]], ("data", "model")),
    "D": ([0, 1], ("model",)),
    "E": ([2, 3], ("model",)),
    "F": ([[0, 1, 2, 3], [4, 5, 6, 7]], ("data", "model")),
    "S": ([0], ("x",)),
}
# case -> [(leaf, shape, dtype, src mesh, src spec, dst mesh, dst spec)];
# a spec entry is None, an axis name or a list of names
CASES = {
    "donate": [("w", (64, 32), "float32", "A", ["data", "model"], "A", ["model", None]),
               ("b", (64,), "float32", "A", ["data"], "A", [None])],
    "cross_mesh": [("w", (64, 32), "float32", "D", ["model", None], "E", [None, "model"]),
                   ("b", (64,), "float32", "D", ["model"], "E", [None])],
    "partial": [("moves", (64, 32), "float32", "A", ["data", None], "A", ["model", None]),
                ("stays", (64, 32), "float32", "A", ["model", None], "A", ["model", None])],
    "pure_alias": [("a", (64, 32), "float32", "A", ["model", None], "A", ["model", None])],
    "size1_axis": [("p", (16, 8), "float32", "C", ["data", "model"], "C", [None, "model"]),
                   ("q", (16,), "float32", "C", ["data"], "C", []),
                   ("r", (16, 8), "float32", "C", ["model"], "C", ["data"])],
    "trailing_none": [("t", (16, 8), "float32", "A", ["data"], "A", ["data", None]),
                      ("u", (16, 8), "float32", "A", [], "A", [None, None])],
    "replicated_to_sharded": [
        ("w", (32, 16), "float32", "A", [], "A", [["data", "model"]]),
        ("h", (32, 16), "bfloat16", "A", ["model"], "A", [["model", "data"], None])],
    "tuple_axes": [("same", (16, 8), "float32", "A", [["data", "model"], None], "B", ["x", None]),
                   ("other", (16, 8), "float32", "A", [["model", "data"], None], "B",
                    ["x", None])],
    "eight_devices": [("w", (64, 32), "float32", "F", ["data", "model"], "F", ["model", None]),
                      ("b", (64,), "float32", "F", ["data"], "F", [None])],
    "one_device_and_back": [("up", (16, 8), "float32", "S", [], "A", ["data", None]),
                            ("down", (16, 8), "float32", "A", ["data", "model"], "S", [])],
    "int_leaf": [("idx", (16,), "int32", "A", ["data"], "A", ["model"]),
                 ("f", (8, 4), "float32", "A", ["model"], "A", ["model"])],
}


def values(case: str, i: int, shape, dtype):
    """The leaf's values, made with numpy from (case, leaf index) alike in
    both packages (bf16: fp32 values rounded by each package)."""
    rng = np.random.default_rng([sum(map(ord, case)), i])
    if dtype == "int32":
        return rng.integers(-1000, 1000, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


def spec_of(entries):
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


JAX_SCRIPT = """
import hashlib, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.parallel.realloc_exec import prefetch_reshard
sys.path.insert(0, {tests!r})
from test_torch_realloc_exec import CASES, MESHES, spec_of, values

devs = jax.devices()
assert len(devs) == 8, devs
meshes = {{k: Mesh(np.array(devs)[np.asarray(ids)], axes) for k, (ids, axes) in MESHES.items()}}
out = {{}}
for case, leaves in CASES.items():
    tree, dst = {{}}, {{}}
    for i, (k, shape, dt, sm, ss, dm, ds) in enumerate(leaves):
        x = jnp.asarray(values(case, i, shape, dt), dtype=dt)
        tree[k] = jax.device_put(x, NamedSharding(meshes[sm], P(*spec_of(ss))))
        dst[k] = NamedSharding(meshes[dm], P(*spec_of(ds)))
    before = dict(tree)
    task = prefetch_reshard(tree, dst)
    res = task.wait()
    out[case] = dict(n_moved=task.n_moved, n_aliased=task.n_aliased,
                     moved_bytes=task.moved_bytes, total_bytes=task.total_bytes,
                     aliased=sorted(k for k in res if res[k] is before[k]),
                     sha={{k: hashlib.sha1(np.asarray(res[k]).tobytes()).hexdigest()
                          for k in res}},
                     device_sets={{k: sorted(d.id for d in res[k].sharding.device_set)
                                  for k in res}})

# chip_smoke's phase 10 moves of llama-7b's tree at full width, counted by
# the JAX executor's split (``_plan``) on abstract leaves with shardings
sys.path.insert(0, {root!r})
import chip_smoke as cs
from repro.parallel import realloc_exec as JRX, sharding as JSH
from test_torch_sharding import jax_shapes, unstack
cfg, shapes = jax_shapes("llama-7b", False)
tree = unstack(shapes, cfg, lambda s: jax.ShapeDtypeStruct(s.shape[1:], jnp.bfloat16))
tree = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16), tree)

def shardings(dp, tp, ids):
    mesh = Mesh(np.array(devs)[np.reshape(ids, (dp, tp))], ("data", "model"))
    specs = JSH.sanitize_specs(JSH.param_specs(tree, JSH.ShardingRules()), tree, mesh)
    return jax.tree.map(lambda p: NamedSharding(mesh, p), specs,
                        is_leaf=lambda x: isinstance(x, P))

llama = {{}}
for name, s, d, _ in cs.REALLOC_MOVES + ((*cs.PREFETCH_MOVE, False),):
    src = jax.tree.map(lambda x, sh: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=sh),
                       tree, shardings(*s))
    leaves, _, _, _, moves, _ = JRX._plan(src, shardings(*d))
    llama[name] = (sum(moves), len(moves) - sum(moves),
                   sum(JRX._leaf_bytes(x) for x, m in zip(leaves, moves) if m),
                   sum(JRX._leaf_bytes(x) for x in leaves))
out["llama_moves"] = llama
print("JAX_RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_results():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    script = textwrap.dedent(JAX_SCRIPT.format(tests=os.path.dirname(__file__),
                                               root=os.path.join(os.path.dirname(__file__),
                                                                 "..")))
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    line = next(x for x in r.stdout.splitlines() if x.startswith("JAX_RESULT "))
    return json.loads(line[len("JAX_RESULT "):])


def cpu_meshes():
    return {k: Mesh(ids, axes, device="cpu") for k, (ids, axes) in MESHES.items()}


def port_case(case):
    """(tree, dst layouts, source tensors) of one table case in the port."""
    meshes = cpu_meshes()
    tree, dst, src = {}, {}, {}
    for i, (k, shape, dt, sm, ss, dm, ds) in enumerate(CASES[case]):
        x = torch.from_numpy(values(case, i, shape, dt))
        src[k] = x.to(torch.bfloat16) if dt == "bfloat16" else x
        tree[k] = ShardedTensor.place(src[k], Layout(meshes[sm], spec_of(ss)))
        dst[k] = Layout(meshes[dm], spec_of(ds))
    return tree, dst, src


def sha(t: torch.Tensor) -> str:
    a = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return hashlib.sha1(a.tobytes()).hexdigest()


@pytest.mark.parametrize("case", sorted(CASES))
def test_reshard_table_equals_jax(case, jax_results):
    want = jax_results[case]
    tree, dst, src = port_case(case)
    before = dict(tree)
    task = RX.prefetch_reshard(tree, dst)
    out = task.wait()
    assert (task.n_moved, task.n_aliased, task.moved_bytes, task.total_bytes) == \
        (want["n_moved"], want["n_aliased"], want["moved_bytes"], want["total_bytes"])
    assert sorted(k for k in out if out[k] is before[k]) == want["aliased"]
    for k, t in out.items():
        assert t.layout == dst[k] or k in want["aliased"]
        assert sorted(t.layout.device_set) == want["device_sets"][k]
        assert torch.equal(t.gather(), src[k])
        assert sha(t.gather()) == want["sha"][k], k
    # a moved leaf was donated: its source blocks are gone
    for k, t in before.items():
        assert t.donated == (k not in want["aliased"])


def test_donated_reshard_matches_undonated():
    """Donating and cloning give the same values and layouts; the donated
    source raises on use, the cloned one stays valid."""
    meshes = cpu_meshes()
    x = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)

    def tree():
        return {"w": ShardedTensor.place(x, Layout(meshes["A"], P("data", "model"))),
                "b": ShardedTensor.place(x[:, 0], Layout(meshes["A"], P("data")))}
    dst = {"w": Layout(meshes["A"], P("model", None)), "b": Layout(meshes["A"], P(None))}
    ta, tb = tree(), tree()
    a = RX.reshard(ta, dst, donate=True)
    b = RX.clone_reshard(tb, dst)
    for k in ("w", "b"):
        assert torch.equal(a[k].gather(), b[k].gather())
        assert a[k].layout == b[k].layout == dst[k]
        assert ta[k].donated and not tb[k].donated
        with pytest.raises(RuntimeError, match="donated"):
            ta[k].gather()
        assert torch.equal(tb[k].gather(), x if k == "w" else x[:, 0])
    assert torch.equal(a["w"].gather(), x)
    assert a["w"].layout.spec == P("model", None)


def test_cross_mesh_move_preserves_values():
    meshes = cpu_meshes()
    x = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
    tree = {"w": ShardedTensor.place(x, Layout(meshes["D"], P("model", None))),
            "b": ShardedTensor.place(x[:, 0], Layout(meshes["D"], P("model")))}
    out = RX.reshard(tree, {"w": Layout(meshes["E"], P(None, "model")),
                            "b": Layout(meshes["E"], P(None))})
    assert torch.equal(out["w"].gather(), x) and torch.equal(out["b"].gather(), x[:, 0])
    assert out["w"].layout.device_set == {2, 3}
    assert [d for d, _, _ in out["w"].shards] == [2, 3]


def test_partial_reshard_moves_only_changed_leaves():
    """Byte-accurate dispatch: only the leaf whose layout changes is copied;
    the other aliases by identity and the task accounts the split; a
    pure-alias reshard dispatches nothing; the sync entry point agrees."""
    meshes = cpu_meshes()
    x = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
    sh_data, sh_model = Layout(meshes["A"], P("data", None)), Layout(meshes["A"], P("model", None))

    def tree():
        return {"moves": ShardedTensor.place(x, sh_data),
                "stays": ShardedTensor.place(x, sh_model)}
    dst = {"moves": sh_model, "stays": sh_model}
    t = tree()
    stays_before = t["stays"]
    total = RX.realloc_bytes(t)
    task = RX.prefetch_reshard(t, dst)
    assert task.done()  # host copies land inside the dispatch
    out = task.wait()
    assert task.n_moved == 1 and task.n_aliased == 1
    assert task.moved_bytes == x.numel() * 4 and task.total_bytes == total == 2 * x.numel() * 4
    assert task.elapsed_s is not None and task.elapsed_s >= 0
    assert out["stays"] is stays_before
    assert torch.equal(out["moves"].gather(), x) and out["moves"].layout.spec == P("model", None)
    t2 = {"a": ShardedTensor.place(x, sh_model)}
    task2 = RX.prefetch_reshard(t2, {"a": sh_model})
    assert task2.n_moved == 0 and task2.moved_bytes == 0 and task2.tree["a"] is t2["a"]
    out3 = RX.reshard(tree(), dst)
    assert torch.equal(out3["moves"].gather(), x)


def test_reshard_preserves_values_across_shardings():
    """``test_multidevice.py``'s case: a (2, 4) mesh of 8 devices,
    fsdp x tp -> tp on rows, and a vector to replicated."""
    mesh = Mesh(np.arange(8).reshape(2, 4), ("data", "model"), device="cpu")
    x = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
    tree = {"w": ShardedTensor.place(x, Layout(mesh, P("data", "model"))),
            "b": ShardedTensor.place(x[:, 0], Layout(mesh, P("data")))}
    out = RX.reshard(tree, {"w": Layout(mesh, P("model", None)), "b": Layout(mesh, P(None))})
    assert torch.equal(out["w"].gather(), x) and torch.equal(out["b"].gather(), x[:, 0])
    assert out["w"].layout.spec == P("model", None)
    assert all(tuple(b.shape) == (16, 32) for _, _, b in out["w"].shards)
    assert all(tuple(b.shape) == (64,) for _, _, b in out["b"].shards)


def test_blocks_and_replicas():
    """A replicated dim gives each device its own copy (as JAX's addressable
    shards); ``nbytes`` counts the global tensor once, ``local_bytes`` every
    copy; a donating move of a block its device already holds takes it
    over without a copy."""
    meshes = cpu_meshes()
    x = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8)
    t = ShardedTensor.place(x, Layout(meshes["A"], P("data")))
    blocks = t.blocks
    assert len({id(b) for b in blocks.values()}) == 4
    assert [r for _, r, _ in t.shards] == [((0, 8), (0, 8)), ((0, 8), (0, 8)),
                                           ((8, 16), (0, 8)), ((8, 16), (0, 8))]
    assert t.nbytes == x.numel() * 4 and t.local_bytes() == 2 * t.nbytes
    out = RX.reshard({"t": t}, {"t": Layout(meshes["A"], P("data", "model"))})["t"]
    assert torch.equal(out.gather(), x)
    # (data, model) -> data: every destination block is a piece of the
    # block its own device held; rows of a replicated source stay put
    back = RX.reshard({"t": out}, {"t": Layout(meshes["A"], P(("data", "model")))})["t"]
    assert torch.equal(back.gather(), x)
    keep = ShardedTensor.place(x, Layout(meshes["A"], P("data")))
    held = dict(keep.blocks)
    moved = RX.reshard({"k": keep}, {"k": Layout(meshes["Aperm"], P("data"))})["k"]
    # Aperm lists (1, 0, 3, 2): device 1 keeps rows 0:8 in both layouts
    assert moved.blocks[1] is held[1] and moved.blocks[2] is held[2]
    assert torch.equal(moved.gather(), x)


def test_equivalence_follows_jax():
    meshes = cpu_meshes()
    a, c = meshes["A"], meshes["C"]
    assert Layout(a, P("data")).is_equivalent_to(Layout(a, P("data", None)), 2)
    assert Layout(c, P("data", "model")).is_equivalent_to(Layout(c, P(None, "model")), 2)
    assert not Layout(a, P("data")).is_equivalent_to(Layout(a, P("model")), 2)
    assert not Layout(a, P()).is_equivalent_to(Layout(meshes["Aperm"], P()), 2)
    assert Layout(a, P(("data", "model"))).is_equivalent_to(Layout(meshes["B"], P("x")), 1)
    assert not Layout(a, P(("model", "data"))).is_equivalent_to(Layout(meshes["B"], P("x")), 1)
    with pytest.raises(ValueError, match="twice"):
        Layout(a, P("data", "data"))
    with pytest.raises(ValueError, match="not in mesh"):
        Layout(a, P("x"))


def test_mesh_places_on_the_card_unless_asked():
    """The default placement is ``cuda:(i % device_count)``; without a card
    a mesh refuses to fall back to the host, and ``device="cpu"`` is the
    caller's choice."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Mesh([0, 1], ("x",))
    m = Mesh([0, 1], ("x",), device="cpu")
    assert m.torch_device(1) == torch.device("cpu")
    from repro_torch.launch.mesh import make_test_mesh, submesh
    tm = make_test_mesh(4, device="cpu")
    assert tm.shape == {"data": 2, "model": 2} and tm.device_ids == (0, 1, 2, 3)
    assert make_test_mesh(8, device="cpu").shape == {"data": 4, "model": 2}
    assert make_test_mesh(3, axes=("x",), device="cpu").shape == {"x": 3}
    sm = submesh([2, 3], (1, 2), ("data", "model"), device="cpu")
    assert sm.device_ids == (2, 3) and sm.shape == {"data": 1, "model": 2}


def test_host_scalars_and_none_layouts_alias():
    """A Python scalar leaf (the AdamW step) and a leaf whose destination is
    None keep their place and count no moved bytes; the scalar counts in
    neither ``n_moved`` nor ``n_aliased``."""
    meshes = cpu_meshes()
    x = torch.ones(8, 4)
    tree = {"step": 3, "w": x, "v": ShardedTensor.place(x, Layout(meshes["A"], P("data")))}
    task = RX.prefetch_reshard(tree, {"step": Layout(meshes["A"], P()), "w": None,
                                      "v": Layout(meshes["A"], P("model"))})
    out = task.wait()
    assert out["step"] == 3 and out["w"] is x and task.n_moved == 1 and task.n_aliased == 1
    assert task.total_bytes == 2 * x.numel() * 4 and task.moved_bytes == x.numel() * 4
    assert RX.realloc_bytes(tree) == task.total_bytes
    placed = RX.reshard({"w": x}, {"w": Layout(meshes["A"], P("data"))})["w"]
    assert isinstance(placed, ShardedTensor) and torch.equal(placed.gather(), x)
    assert len(tree_leaves(out)) == 3


# ------------------------------------------------ chip_smoke's phase 10

@pytest.fixture(scope="module")
def chip_smoke():
    root = os.path.join(os.path.dirname(__file__), "..")
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def test_llama_move_counts_equal_jax(jax_results, chip_smoke):
    """Phase 10b's moves of llama-7b's tree at full width (and 10c's
    prefetch move): the split chip_smoke holds the card to is the JAX
    executor's on the same spec trees, and the port's executor gives it on
    ``meta`` blocks (nothing allocated)."""
    want = {k: tuple(v) for k, v in jax_results["llama_moves"].items()}
    assert want == chip_smoke.LLAMA_MOVE_COUNTS
    from test_torch_sharding import jax_shapes, port_meta_tree
    from repro_torch.configs import ARCHS
    _, shapes = jax_shapes("llama-7b", False)
    tree = chip_smoke.tree_map(lambda t: torch.empty(t.shape, dtype=torch.bfloat16,
                                                     device="meta"),
                               port_meta_tree(ARCHS["llama-7b"], shapes))

    def meta(i):
        return torch.device("meta")
    for name, s, d, clone in chip_smoke.REALLOC_MOVES + ((*chip_smoke.PREFETCH_MOVE, False),):
        src = chip_smoke.place_tree(tree, chip_smoke.strategy_layouts(tree, *s, meta))
        task = RX.prefetch_reshard(src, chip_smoke.strategy_layouts(tree, *d, meta),
                                   donate=not clone)
        task.wait()
        assert (task.n_moved, task.n_aliased, task.moved_bytes, task.total_bytes) == want[name]


def test_chip_smoke_phase10b_on_cpu(chip_smoke):
    """Phase 10b's moves at the reduced size on logical CPU devices: every
    leaf bit-equal after each move, the norms aliased where the device list
    stays, the clone's source valid."""
    from repro_torch.models import model as TM
    cfg = chip_smoke.get_config("llama-7b").reduced()
    params = TM.init_params(cfg, seed=0, device="cpu")
    runs = chip_smoke.phase_realloc(params, "cpu")
    assert [r["name"] for r in runs] == [m[0] for m in chip_smoke.REALLOC_MOVES]
    n_norms = 2 * cfg.num_layers + 1
    for r in runs:
        assert r["bit_equal"] and r["done_before_wait"]
        same_devices = set(r["src"][2]) == set(r["dst"][2])
        assert r["n_aliased"] == (n_norms if same_devices else 0)
        assert r["norms_aliased"] == same_devices
        assert r["n_moved"] + r["n_aliased"] == len(tree_leaves(params))
    assert runs[0]["source_valid"]


def test_chip_smoke_phase10c_on_cpu(chip_smoke):
    """Phase 10c at the reduced size: the prefetch toy on reduced llama and
    the pipeline toy with reduced qwen2-0.5b's critic, physical at depth 1
    and 2 and logical, through ``report_layout_engine``'s own checks."""
    from repro_torch.models import model as TM
    actor = TM.init_params(chip_smoke.get_config("llama-7b").reduced(), seed=0, device="cpu")
    chip_smoke.report_layout_engine(actor, "cpu",
                                    critic_cfg=chip_smoke.get_config("qwen2-0.5b").reduced(),
                                    counts=None)
