"""Expert parallelism (``models/moe.moe_apply_sharded``): reduced
granite-moe-1b-a400m with its 4 experts split over the model axis of a
(2, 2) mesh of logical CPU devices, against the JAX package's EP forward
(``tests/test_multidevice.py::test_ep_sharded_dropless_moe_matches_single_device``:
the same params and batch under ``jit`` with the expert axis on "model",
one subprocess of 4 forced host devices) at that test's tolerance (atol
2e-3, rtol 1e-2), and against the port's single-device forward at 1e-5.
"""

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.parallel import ctx as CTX
from repro_torch.parallel import sharding as SH
from repro_torch.parallel import steps
from test_torch_tp_step import FLATTEN, cpu_mesh, place, run_jax, unflatten

JAX_EP = FLATTEN + '''
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCHS
from repro.models import forward, init_params, synth_batch
from repro.parallel import sharding as SH
from repro.parallel.compat import auto_axis_types, make_mesh

cfg = ARCHS["granite-moe-1b-a400m"].reduced()
p = init_params(jax.random.PRNGKey(0), cfg)
batch = synth_batch(jax.random.PRNGKey(1), cfg, 16, 4, "prefill")
fwd = lambda p, b: forward(p, cfg, b, remat=False)
mesh = make_mesh((2, 2), ("data", "model"), axis_types=auto_axis_types(2))
specs = SH.param_specs(p, SH.ShardingRules())
assert specs["groups"][0]["b0"]["ffn"]["w_gate"][1] == "model"
psh = jax.tree.map(lambda s: NamedSharding(mesh, s), specs)
bsh = jax.tree.map(lambda x: NamedSharding(mesh, P("data", *([None] * (x.ndim - 1)))), batch)
h, aux = jax.jit(fwd, in_shardings=(psh, bsh))(jax.device_put(p, psh),
                                               jax.device_put(batch, bsh))
out = {"h": np.asarray(h), "aux": np.asarray(aux), "tokens": np.asarray(batch["tokens"])}
flatten(jax.tree.map(np.asarray, p), "params", out)
np.savez("{out}", **out)
'''


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory):
    return run_jax(JAX_EP, str(tmp_path_factory.mktemp("jax") / "ep.npz"))


def ep_forward(cfg, params, tokens, mesh, *, return_aux=False):
    """The sharded forward's hidden states gathered over the batch axis."""
    rules = SH.ShardingRules()
    sp = place(params, mesh)
    with CTX.use(mesh, rules.batch_axes, rules.tp_axis) as c:
        parts = steps.split_batch({"tokens": tokens}, mesh, rules)
        out = TM.forward_sharded(sp, cfg, parts, ctx=c, impl="reference",
                                 return_aux=return_aux)
    hs, aux = out if return_aux else (out, None)
    first = [next(r for r in mesh.device_ids if c.batch_index(r) == i)
             for i in range(c.batch_size)]
    return torch.cat([hs[r] for r in first]), aux


def test_ep_forward_matches_jax(jax_ep):
    cfg = get_config("granite-moe-1b-a400m").reduced()
    assert cfg.n_experts == 4
    params = params_from_jax(unflatten(jax_ep, "params"), cfg, device="cpu")
    tokens = torch.from_numpy(np.array(jax_ep["tokens"])).long()
    h, _ = ep_forward(cfg, params, tokens, cpu_mesh((2, 2)))
    np.testing.assert_allclose(h.numpy(), jax_ep["h"], atol=2e-3, rtol=1e-2)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (1, 2)])
def test_ep_forward_matches_single_device(shape):
    """Each (token, k) row comes from one rank and zeros from the others,
    so the fp32 combine summed over the ranks is the single-device one:
    the hidden states agree to fp32 summation order of the attention's
    sharded products, the aux loss too."""
    kw = dict(n_heads=4, n_kv_heads=4) if shape[1] == 4 else {}
    cfg = get_config("granite-moe-1b-a400m").reduced(**kw)
    params = TM.init_params(cfg, seed=1, device="cpu")
    tokens = TM.synth_batch(2, cfg, 12, 4, "prefill", device="cpu")["tokens"]
    want, aux = TM.forward(params, cfg, {"tokens": tokens}, impl="reference", return_aux=True)
    got, saux = ep_forward(cfg, params, tokens, cpu_mesh(shape), return_aux=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    for a in saux.values():
        np.testing.assert_allclose(float(a), float(aux), rtol=1e-5)


def test_expert_rows_split_the_dispatch_exactly():
    """The per-rank rows of ``_expert_rows`` over disjoint expert ranges sum
    to the whole dispatch's rows bit for bit (each row from one range,
    zeros from the others)."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    p = TM.init_params(cfg, seed=0, device="cpu")["layers"][0]["ffn"]
    xf = torch.randn(24, cfg.d_model, generator=torch.Generator().manual_seed(0))
    top_w, top_i = TMOE._router(p, cfg, xf)
    whole = TMOE._expert_rows(p, cfg, xf, top_w, top_i, 0, 4, "reference")
    halves = [TMOE._expert_rows({k: (v[lo:lo + 2] if k != "router" else v)
                                 for k, v in p.items()}, cfg, xf, top_w, top_i, lo, 2,
                                "reference") for lo in (0, 2)]
    assert torch.equal(halves[0] + halves[1], whole)
    assert bool(((halves[0] == 0) | (halves[1] == 0)).all())


# ------------------------------------------- the capacity dispatch, sharded
# Reduced Arctic's MoE layer under the capacity dispatch on a (2, 2) mesh:
# experts split over "model", the 24-token cohort over "data" (12 tokens a
# replica), at ``test_torch_arctic.overflow_case``'s shape, where expert 0
# overflows.  The JAX package's GSPMD step takes the capacity over the
# global cohort, so the kept set and every slot must equal its
# single-device ``capacity_route`` element for element.

def sharded_capacity(layer, tcfg, x, mesh):
    """(keep (T, K), slot (T, K), y (B, S, D)) of the sharded capacity
    dispatch of x (B, S, D), the batch rows split over "data": each
    replica's routes in token order, joined replica 0 first."""
    rules = SH.ShardingRules()
    placed = place({"ffn": layer}, mesh)
    with CTX.use(mesh, rules.batch_axes, rules.tp_axis) as c:
        local = c.local(placed)
        xs = {r: v["x"] for r, v in steps.split_batch({"x": x}, mesh, rules).items()}
        ps = {r: local[r]["ffn"] for r in xs}
        routes = {r: TMOE._router(ps[r], tcfg, xs[r].reshape(-1, x.shape[-1])) for r in xs}
        got = TMOE.capacity_route_sharded(tcfg, routes, ctx=c)
        ys, _ = TMOE.moe_apply_sharded(ps, tcfg, xs, ctx=c, impl="reference")
        first = [next(r for r in mesh.device_ids if c.batch_index(r) == i)
                 for i in range(c.batch_size)]
    keep, slot = [], []
    for r in first:
        order, _, sl, kp, _, cap = got[r]
        k = tcfg.top_k
        keep.append(torch.empty_like(kp).scatter_(0, order, kp).view(-1, k))
        slot.append(torch.empty_like(sl).scatter_(0, order, sl).view(-1, k))
    return torch.cat(keep), torch.cat(slot), torch.cat([ys[r] for r in first]), cap


def jax_capacity(jcfg, jl, x):
    """The JAX package's single-device routes of the whole cohort, in token
    order, and its capacity."""
    import jax.numpy as jnp
    from repro.models import moe as JMOE
    xf = jnp.asarray(x.reshape(-1, x.shape[-1]))
    _, jw, ji = JMOE._router(jl, jcfg, xf)
    order, _, slot, keep, _, c = (np.asarray(a) for a in JMOE.capacity_route(
        jcfg, jw, ji, xf.shape[0]))
    k = jcfg.top_k
    keep_tk, slot_tk = np.empty_like(keep), np.empty_like(slot)
    keep_tk[order], slot_tk[order] = keep, slot
    return keep_tk.reshape(-1, k), slot_tk.reshape(-1, k), int(c)


@pytest.mark.parametrize("shape", [(2, 2), (2, 1)])
def test_sharded_capacity_routes_equal_jax_when_overflowing(shape):
    """Kept set and slots equal to the JAX package's single-device
    ``capacity_route`` over the global cohort; the layer's output within
    1e-5 of the port's single-device layer."""
    from test_torch_arctic import overflow_case
    jcfg, jl, tcfg, tl, x = overflow_case()
    x2 = torch.from_numpy(x).reshape(2, -1, x.shape[-1])
    keep, slot, y, c = sharded_capacity(tl, tcfg, x2, cpu_mesh(shape))
    want_keep, want_slot, want_c = jax_capacity(jcfg, jl, x)
    assert c == want_c == TMOE.capacity(x.shape[1], tcfg) == 15
    assert (~want_keep).sum() >= 4  # it overflows
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    single = TMOE.moe_apply(tl, tcfg, torch.from_numpy(x), impl="reference")
    np.testing.assert_allclose(y.reshape(single.shape).numpy(), single.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_per_rank_capacity_is_caught(monkeypatch):
    """The planted fault: each replica slots its own assignments from 0
    (no offsets from the replicas before it).  Replica 1 then keeps
    assignments the global cohort drops, so the kept set, the slots and
    the output all part from the JAX package's."""
    from test_torch_arctic import overflow_case
    jcfg, jl, tcfg, tl, x = overflow_case()
    monkeypatch.setattr(TMOE, "_count_offsets",
                        lambda counts, ctx: {r: torch.zeros_like(n) for r, n in counts.items()})
    x2 = torch.from_numpy(x).reshape(2, -1, x.shape[-1])
    keep, slot, y, _ = sharded_capacity(tl, tcfg, x2, cpu_mesh((2, 2)))
    want_keep, want_slot, _ = jax_capacity(jcfg, jl, x)
    assert not np.array_equal(keep.numpy(), want_keep)
    assert not np.array_equal(slot.numpy(), want_slot)
    single = TMOE.moe_apply(tl, tcfg, torch.from_numpy(x), impl="reference")
    assert float((y.reshape(single.shape) - single).abs().max()) > 1e-3


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)])
def test_capacity_train_step_matches_single_device(shape):
    """Reduced Arctic's capacity dispatch with the dense residual, under
    expert, data and FSDP parallelism, against the single-device step."""
    from test_torch_tp_step import assert_close_runs, sharded_step, single_step
    from repro_torch.optim import adamw
    cfg = get_config("arctic-480b").reduced(moe_dispatch="capacity")
    params = TM.init_params(cfg, seed=0, device="cpu")
    batch = TM.synth_batch(1, cfg, 12, 4, device="cpu")
    batch["mask"][1, 7:] = 0.0
    opt = adamw.AdamWConfig(lr=1e-6)
    assert_close_runs(single_step(cfg, params, batch, opt),
                      sharded_step(cfg, params, batch, opt, cpu_mesh(shape)))
