"""The port's collectives (``parallel/collectives.py``), sharding context
(``parallel/ctx.py``) and int8 error-feedback all-reduce
(``optim/grad.compressed_psum``) on logical CPU meshes.

Each collective is held to numpy on meshes (4,) and (2, 2), values and
gradients (the backward of a sum is the sum of the upstream gradients over
the group; of a gather, the slice back; of ``ppermute``, the reverse
move).  ``compressed_psum`` is held to the JAX package's under
``shard_map`` over 3 error-feedback steps (one subprocess, 4 forced host
devices) to 1e-6, means and residuals; ``ShardingCtx.resolve`` to JAX's on
a table of cases.
"""

import numpy as np
import pytest
import torch

from repro.optim import grad as jgrad
from repro.parallel import ctx as jctx
from repro_torch.optim import grad as tgrad
from repro_torch.parallel import collectives as C
from repro_torch.parallel import ctx as tctx
from repro_torch.parallel.layout import Mesh
from test_torch_tp_step import run_jax

MESHES = {"4": ([0, 1, 2, 3], ("x",)), "2x2": ([[0, 1], [2, 3]], ("data", "model"))}


def mesh_of(name):
    ids, axes = MESHES[name]
    return Mesh(ids, axes, device="cpu")


def values(mesh, shape=(4, 6), seed=0):
    rng = np.random.default_rng(seed)
    return {r: torch.from_numpy(rng.normal(size=shape)).requires_grad_(True)
            for r in mesh.device_ids}


def cases():
    """(mesh name, axis) pairs: every axis of each mesh, and both at once."""
    return [("4", "x"), ("2x2", "data"), ("2x2", "model"), ("2x2", ("data", "model"))]


def np_groups(name, axis):
    ids, axes = MESHES[name]
    arr = np.asarray(ids)
    axis = (axis,) if isinstance(axis, str) else axis
    pos = [axes.index(a) for a in axis]
    rest = [i for i in range(arr.ndim) if i not in pos]
    return np.transpose(arr, rest + pos).reshape(-1, int(np.prod([arr.shape[p] for p in pos])))


def backward(out, upstream):
    """Backpropagate ``upstream`` through the outputs that carry a gradient
    (a ``ppermute`` member that receives nothing gets constant zeros)."""
    live = [r for r in out if out[r].requires_grad]
    torch.autograd.backward([out[r] for r in live], [upstream[r] for r in live])


@pytest.mark.parametrize("name,axis", cases())
@pytest.mark.parametrize("op", ["sum", "max"])
def test_all_reduce(name, axis, op):
    mesh = mesh_of(name)
    xs = values(mesh)
    out = C.all_reduce(xs, mesh, axis, op=op)
    up = values(mesh, seed=1)
    for g in np_groups(name, axis):
        stack = np.stack([xs[r].detach().numpy() for r in g])
        want = stack.sum(0) if op == "sum" else stack.max(0)
        for r in g:
            np.testing.assert_allclose(out[r].detach().numpy(), want, rtol=1e-12)
        # replicas are copies of one result
        assert all(torch.equal(out[g[0]], out[r]) for r in g)
    backward(out, {r: u.detach() for r, u in up.items()})
    for g in np_groups(name, axis):
        gsum = sum(up[r].detach().numpy() for r in g)
        if op == "sum":
            for r in g:
                np.testing.assert_allclose(xs[r].grad.numpy(), gsum, rtol=1e-12)
        else:  # the winner of each element takes the gradient
            stack = np.stack([xs[r].detach().numpy() for r in g])
            for i, r in enumerate(g):
                np.testing.assert_allclose(xs[r].grad.numpy(),
                                           np.where(stack.argmax(0) == i, gsum, 0.0))


@pytest.mark.parametrize("name,axis", cases())
@pytest.mark.parametrize("dim", [0, 1])
def test_all_gather_and_reduce_scatter(name, axis, dim):
    mesh = mesh_of(name)
    xs = values(mesh, shape=(4, 8))
    out = C.all_gather(xs, mesh, axis, dim)
    up = values(mesh, shape=tuple(out[0].shape), seed=2)
    for g in np_groups(name, axis):
        want = np.concatenate([xs[r].detach().numpy() for r in g], axis=dim)
        for r in g:
            np.testing.assert_array_equal(out[r].detach().numpy(), want)
    backward(out, {r: u.detach() for r, u in up.items()})
    rs = C.reduce_scatter({r: u.detach() for r, u in up.items()}, mesh, axis, dim)
    for g in np_groups(name, axis):
        total = sum(up[r].detach().numpy() for r in g)
        for i, r in enumerate(g):
            want = np.split(total, len(g), axis=dim)[i]
            np.testing.assert_allclose(rs[r].numpy(), want, rtol=1e-12)
            # the gather's backward is the reduce-scatter
            np.testing.assert_allclose(xs[r].grad.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("name,axis", cases())
def test_all_to_all(name, axis):
    mesh = mesh_of(name)
    k = C.axis_size(mesh, axis)
    xs = values(mesh, shape=(k * 2, 3))
    out = C.all_to_all(xs, mesh, axis, split_dim=0, concat_dim=1)
    up = values(mesh, shape=tuple(out[0].shape), seed=3)
    for g in np_groups(name, axis):
        for i, r in enumerate(g):
            want = np.concatenate([np.split(xs[s].detach().numpy(), k)[i] for s in g], axis=1)
            np.testing.assert_array_equal(out[r].detach().numpy(), want)
    backward(out, {r: u.detach() for r, u in up.items()})
    for g in np_groups(name, axis):
        for j, s in enumerate(g):  # rank s's chunk i went to member i, column block j
            want = np.concatenate([np.split(up[r].detach().numpy(), k, axis=1)[j]
                                   for r in g], axis=0)
            np.testing.assert_array_equal(xs[s].grad.numpy(), want)


@pytest.mark.parametrize("name,axis", cases()[:3])
def test_ppermute_and_broadcast(name, axis):
    mesh = mesh_of(name)
    k = C.axis_size(mesh, axis)
    perm = [(i, (i + 1) % k) for i in range(k - 1)]  # the last member receives nothing
    xs = values(mesh)
    out = C.ppermute(xs, mesh, axis, perm)
    up = values(mesh, seed=4)
    for g in np_groups(name, axis):
        np.testing.assert_array_equal(out[g[0]].detach().numpy(), 0.0)
        for i, j in perm:
            np.testing.assert_array_equal(out[g[j]].detach().numpy(),
                                          xs[g[i]].detach().numpy())
    backward(out, {r: u.detach() for r, u in up.items()})
    for g in np_groups(name, axis):
        for i, j in perm:
            np.testing.assert_array_equal(xs[g[i]].grad.numpy(), up[g[j]].detach().numpy())
        assert xs[g[-1]].grad is None  # the last member sends nothing
    b = C.broadcast({r: x.detach() for r, x in xs.items()}, mesh, axis, k - 1)
    for g in np_groups(name, axis):
        for r in g:
            assert torch.equal(b[r], xs[g[-1]].detach())


def test_moves_are_counted_copies():
    mesh = mesh_of("2x2")
    xs = {r: torch.ones(10, dtype=torch.float32) for r in mesh.device_ids}
    C.reset_stats()
    out = C.all_reduce(xs, mesh, "model")
    # per group: one copy to the root, one back
    assert C.STATS == {"bytes": 2 * 2 * 40, "copies": 4}
    assert out[1].data_ptr() != out[0].data_ptr()
    single = Mesh([[0], [1]], ("data", "model"), device="cpu")
    C.reset_stats()
    same = C.all_reduce({0: xs[0], 1: xs[1]}, single, "model")
    assert same[0] is xs[0] and C.STATS["copies"] == 0


RESOLVE_CASES = [
    ((), ("data",), "model", (jctx.BATCH, None, None)),
    ((), ("pod", "data"), "model", (jctx.BATCH, None, jctx.TP)),
    ((), (), "model", (jctx.BATCH, jctx.TP)),
    ((), ("data", None), None, (jctx.TP, jctx.BATCH, "stage")),
    ((), ("data",), "model", ()),
]


@pytest.mark.parametrize("case", range(len(RESOLVE_CASES)))
def test_resolve_equals_jax(case):
    _, batch_axes, tp, dims = RESOLVE_CASES[case]
    tdims = tuple({jctx.BATCH: tctx.BATCH, jctx.TP: tctx.TP}.get(d, d) for d in dims)
    want = jctx.ShardingCtx(None, batch_axes, tp).resolve(dims)
    got = tctx.ShardingCtx(None, batch_axes, tp).resolve(tdims)
    assert tuple(got) == tuple(want)


def test_context_is_scoped_and_constrain_is_the_identity():
    mesh = mesh_of("2x2")
    assert tctx.current() is None
    x = torch.ones(4, 2)
    with tctx.use(mesh, ("data",), "model") as c:
        assert tctx.current() is c
        assert tctx.constrain(x, tctx.BATCH, None) is x
        assert [c.tp_index(r) for r in c.ranks] == [0, 1, 0, 1]
        assert [c.batch_index(r) for r in c.ranks] == [0, 0, 1, 1]
        assert (c.tp_size, c.batch_size) == (2, 2)
    assert tctx.current() is None


def test_quantize_int8_equals_jax():
    import jax.numpy as jnp
    g = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    jq, js = jgrad.quantize_int8(jnp.asarray(g))
    tq, ts = tgrad.quantize_int8(torch.from_numpy(g))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-7)
    np.testing.assert_allclose(tgrad.dequantize_int8(tq, ts).numpy(),
                               np.asarray(jgrad.dequantize_int8(jq, js)), rtol=1e-7)


JAX_PSUM = '''
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.optim.grad import compressed_psum
from repro.parallel.compat import auto_axis_types, make_mesh
mesh = make_mesh((4,), ("dp",), axis_types=auto_axis_types(1))
g = np.random.default_rng(0).normal(size=(4, 250)).astype(np.float32)

def f(gs, err):
    m, e = compressed_psum(gs[0], "dp", err[0])
    return m[None], e[None]

sm = shard_map(f, mesh=mesh, in_specs=(P("dp"), P("dp")), out_specs=(P("dp"), P("dp")),
               check_rep=False)
err = jnp.zeros((4, 250))
out = {"g": g}
for i in range(3):
    mean, err = sm(jnp.asarray(g), err)
    out[f"mean{i}"], out[f"err{i}"] = np.asarray(mean), np.asarray(err)
np.savez("{out}", **out)
'''


def test_compressed_psum_equals_jax(tmp_path):
    """3 error-feedback steps on a (4, 250) gradient (250 pads to 252 in
    chunks of 63): every rank's mean and residual equal the JAX package's
    to 1e-6, and every rank's mean is the same bits."""
    want = run_jax(JAX_PSUM, str(tmp_path / "psum.npz"))
    mesh = Mesh([0, 1, 2, 3], ("dp",), device="cpu")
    g = {r: torch.from_numpy(want["g"][r]) for r in range(4)}
    err = None
    for i in range(3):
        mean, err = tgrad.compressed_psum(g, mesh, "dp", err)
        for r in range(4):
            np.testing.assert_allclose(mean[r].numpy(), want[f"mean{i}"][r], atol=1e-6)
            np.testing.assert_allclose(err[r].numpy(), want[f"err{i}"][r], atol=1e-6)
            assert torch.equal(mean[r], mean[0])
    exact = want["g"].mean(0)
    assert np.abs(want["mean0"][0] - exact).max() < 0.15  # the JAX test's bound
