"""Packed (``cu_seqlens``) cohorts through the port's sharded train step
(``parallel/steps.make_train_step(mesh=)``) on logical CPU meshes.

The step deals the cohort to the batch replicas as runs of whole sequences
(``data/packing.split_packed``) and runs each rank's (1, T_r) cohort
through the varlen attention and, for granite, the grouped expert FFN.  It
is held against the JAX package's ``make_train_step`` on the same packed
cohort (run unsharded in this process: GSPMD computes the same function)
at the JAX multidevice test's tolerance (loss 1e-3; leaves atol 5e-3, rtol
1e-2), and against the port's single-device packed step in fp32 at
``test_torch_tp_step.py``'s 1e-5, on (data 2, model 2), (1, 4) with
qwen2-0.5b's 14 query heads split, (2, 1) FSDP, ZeRO-1 over the pod axis
and granite's experts over (1, 4) and (2, 2) under both dispatches.  Also:
packed against padded on the same sequences, a replica's rows blind to
another replica's sequences, the capacity dispatch's drop set over an
uneven split equal to one device's, the split against ``pack``, and the
refusals.  The weights are the JAX package's init with the embedding
scaled by 0.05 and the biases and norm scales drawn (``make_models``), so
that the compared loss is not one-hot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.parallel.steps import make_train_step as jax_train_step
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.data import packing
from repro_torch.models import model as TM
from repro_torch.models import moe as MOE
from repro_torch.optim import adamw
from repro_torch.parallel import ctx as CTX
from repro_torch.parallel import sharding as SH
from repro_torch.parallel import steps
from repro_torch.parallel.layout import ShardedTensor, tree_leaves, tree_map
from test_torch_model import _dicts
from test_torch_split_heads import pod_mesh, zero1_step
from test_torch_tp_step import assert_close_runs, cpu_mesh, place, sharded_step, single_step

QWEN = ("qwen2-0.5b", dict(n_heads=14))  # 14 query heads over 2 KV heads
GRANITE = ("granite-moe-1b-a400m", {})
LENS = [5, 12, 3, 9, 7, 2, 11]           # 49 tokens, bucketed to 64: a tail of 15 phantoms
OPT = adamw.AdamWConfig(lr=1e-6)


def make_models(arch, kw, seed=0):
    """(JAX cfg, JAX params, port cfg, port params) with shared weights."""
    jcfg, tcfg = JARCHS[arch].reduced(**kw), get_config(arch).reduced(**kw)
    tree = jax.tree.map(np.array, JM.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    tree["embed"]["table"] *= 0.05
    for d in _dicts(tree):
        if "b" in d:
            d["b"] = rng.normal(0, 0.1, d["b"].shape).astype(np.float32)
        if "scale" in d:
            d["scale"] = (1 + rng.normal(0, 0.1, d["scale"].shape)).astype(np.float32)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_jax(tree, tcfg,
                                                                       device="cpu")


def packed_lm_batch(vocab, lens=LENS, seed=1, bucket=16):
    """An LM cohort of ``lens`` random sequences packed and bucketed:
    labels the next token of the sequence, the mask 0 on each sequence's
    last token and on the phantoms.  Returns (packed, padded): the packed
    {"tokens" (T,), "positions", "cu_seqlens", "labels" (1, T), "mask" (1,
    T)} and the same sequences as a padded (B, S) batch."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, (len(lens), max(lens)))
    labels = np.roll(toks, -1, axis=1)
    mask = (np.arange(max(lens))[None] < np.asarray(lens)[:, None] - 1).astype(np.float32)
    pb = packing.pad_to(packing.pack_batch(torch.from_numpy(toks), lens),
                        packing.bucket_total(sum(lens), bucket))
    pad = pb.total_tokens - sum(lens)

    def packed(x):
        return torch.nn.functional.pad(packing.pack(torch.from_numpy(x), lens), (0, pad))[None]
    return ({"tokens": pb.tokens.long(), "positions": pb.positions,
             "cu_seqlens": pb.cu_seqlens, "labels": packed(labels), "mask": packed(mask)},
            {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
             "mask": torch.from_numpy(mask)})


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's ``make_train_step`` on the packed cohort, jitted
    and unsharded: {name: (port cfg, port params before, its batch, loss,
    grad_norm, port params after)}."""
    out = {}
    for name, (arch, kw) in {"qwen": QWEN, "granite": GRANITE}.items():
        jcfg, jp, tcfg, tp = make_models(arch, kw, seed=3)
        batch, _ = packed_lm_batch(tcfg.vocab_size)
        jb = {k: jnp.asarray(v.numpy().astype(np.int32 if k != "mask" else np.float32))
              for k, v in batch.items()}
        opt = jadamw.AdamWConfig(lr=1e-3)
        p2, _, m = jax.jit(jax_train_step(jcfg, opt))(jp, jadamw.init(opt, jp), jb)
        after = params_from_jax(jax.tree.map(np.array, p2), tcfg, device="cpu")
        out[name] = (tcfg, tp, batch, float(m["loss"]), float(m["grad_norm"]), after)
    return out


@pytest.mark.parametrize("name,shape", [("qwen", (2, 2)), ("qwen", (1, 4)),
                                        ("granite", (1, 4))])
def test_packed_sharded_step_matches_jax(jax_runs, name, shape):
    """The port's packed step on (2, 2), on (1, 4) where qwen's 14 query
    heads split, and granite's experts over (1, 4), against the JAX
    package's step on the same cohort and weights."""
    cfg, params, batch, loss, grad_norm, want = jax_runs[name]
    p2, o2, m2 = sharded_step(cfg, params, batch, adamw.AdamWConfig(lr=1e-3), cpu_mesh(shape))
    assert abs(float(m2["loss"]) - loss) < 1e-3
    np.testing.assert_allclose(float(m2["grad_norm"]), grad_norm, rtol=1e-3)
    got, want = tree_leaves(p2), tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.gather().detach().numpy(), b.numpy(), atol=5e-3, rtol=1e-2)


LAYOUTS = {
    "qwen-data2-model2": (QWEN, (2, 2), SH.ShardingRules()),
    "qwen-model4-split-heads": (QWEN, (1, 4), SH.ShardingRules()),
    "qwen-data2-fsdp": (QWEN, (2, 1), SH.ShardingRules()),
    "granite-ep4-dropless": (GRANITE, (1, 4), SH.ShardingRules()),
    "granite-ep4-capacity": (("granite-moe-1b-a400m", dict(moe_dispatch="capacity")), (1, 4),
                             SH.ShardingRules()),
    "granite-data2-ep2-capacity": (("granite-moe-1b-a400m", dict(moe_dispatch="capacity")),
                                   (2, 2), SH.ShardingRules()),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_packed_sharded_step_matches_single_device_fp32(name):
    (arch, kw), shape, rules = LAYOUTS[name]
    _, _, cfg, params = make_models(arch, kw)
    batch, _ = packed_lm_batch(cfg.vocab_size)
    assert_close_runs(single_step(cfg, params, batch, OPT),
                      sharded_step(cfg, params, batch, OPT, cpu_mesh(shape), rules))


def test_packed_zero1_step_matches_single_device_fp32():
    """ZeRO-1: the AdamW state over the pod axis of (pod 2, data 1, model
    2), the cohort dealt to the (pod, data) replicas."""
    _, _, cfg, params = make_models(*QWEN)
    batch, _ = packed_lm_batch(cfg.vocab_size)
    assert_close_runs(single_step(cfg, params, batch, OPT),
                      zero1_step(cfg, params, batch, OPT, pod_mesh(),
                                 SH.ShardingRules(pod_axis="pod")))


def test_packed_matches_padded_sharded_step():
    """The same sequences packed and padded, each through the (2, 2) step:
    the same loss, gradient norm and update (the replicas hold other rows:
    whole sequences balanced by tokens against B / 2 rows each)."""
    _, _, cfg, params = make_models(*QWEN)
    packed, padded = packed_lm_batch(cfg.vocab_size, lens=LENS + [4])
    mesh = cpu_mesh((2, 2))
    p1, o1, m1 = sharded_step(cfg, params, padded, OPT, mesh)

    def gathered(tree):
        return tree_map(lambda st: st.gather() if isinstance(st, ShardedTensor) else st, tree)
    assert_close_runs((gathered(p1), gathered(o1), m1),
                      sharded_step(cfg, params, packed, OPT, mesh))


def sharded_hidden(cfg, params, batch, shape):
    mesh = cpu_mesh(shape)
    rules = SH.ShardingRules()
    with CTX.use(mesh, rules.batch_axes, rules.tp_axis) as c:
        return TM.forward_sharded(place(params, mesh), cfg, steps.split_batch(batch, mesh, rules),
                                  ctx=c, impl="reference")


@pytest.mark.parametrize("arch,kw", [QWEN, GRANITE])
def test_a_replica_is_blind_to_another_replicas_sequences(arch, kw):
    """Dense and dropless MoE on (2, 2): the last sequence (replica 1)
    redrawn, every row of replica 0 keeps its bits and replica 1's rows
    move."""
    _, _, cfg, params = make_models(arch, kw)
    batch, _ = packed_lm_batch(cfg.vocab_size)
    other = dict(batch, tokens=batch["tokens"].clone())
    cu = batch["cu_seqlens"].tolist()
    other["tokens"][cu[-2]:cu[-1]] = torch.from_numpy(
        np.random.default_rng(9).integers(1, cfg.vocab_size, cu[-1] - cu[-2]))
    a, b = (sharded_hidden(cfg, params, x, (2, 2)) for x in (batch, other))
    assert a[0].shape[1] + a[2].shape[1] == batch["tokens"].shape[0]
    for r in (0, 1):
        assert torch.equal(a[r], b[r])
    assert not torch.equal(a[2], b[2])


def test_uneven_capacity_split_keeps_the_single_device_drop_set():
    """The capacity dispatch over a packed cohort dealt unevenly (whole
    sequences, 20 and 44 rows) to two replicas: the capacity is the whole
    cohort's, and the kept (token, expert) set and each kept slot equal one
    device's exactly; replicas' rows times the replica count would give
    another capacity, under which the drop set differs."""
    cfg = get_config("granite-moe-1b-a400m").reduced(moe_dispatch="capacity")
    p = TM.init_params(cfg, seed=0, device="cpu")["layers"][0]["ffn"]
    lens = [20, 30, 14]
    parts = packing.split_packed({"tokens": torch.zeros(64), "cu_seqlens": torch.from_numpy(
        packing.cu_seqlens_of(lens))}, 2)
    t0 = parts[0]["tokens"].shape[0]
    assert (t0, parts[1]["tokens"].shape[0]) == (20, 44)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((64, cfg.d_model))
                         .astype(np.float32))
    w0 = p["router"]["w"][:, 0]
    x = x + 4.0 * w0 / w0.square().sum()  # expert 0's logit up by 4: it overflows
    tw, ti = MOE._router(p, cfg, x)
    order, _, slot, keep, _, c = MOE.capacity_route(cfg, tw, ti, 64)

    def by_assignment(order, values):
        return torch.empty_like(values).scatter_(0, order, values)
    want_keep, want_slot = by_assignment(order, keep), by_assignment(order, slot)
    assert not bool(want_keep.all()) and MOE.capacity(2 * t0, cfg) != c
    mesh = cpu_mesh((2, 1))
    ctx = CTX.ShardingCtx(mesh, ("data",), "model")
    routes = {0: MOE._router(p, cfg, x[:t0]), 1: MOE._router(p, cfg, x[t0:])}
    got = MOE.capacity_route_sharded(cfg, routes, ctx=ctx)
    assert {g[-1] for g in got.values()} == {c}
    keep = torch.cat([by_assignment(got[r][0], got[r][3]) for r in (0, 1)])
    slot = torch.cat([by_assignment(got[r][0], got[r][2]) for r in (0, 1)])
    assert torch.equal(keep, want_keep)
    assert torch.equal(slot[keep], want_slot[want_keep])


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_split_packed_is_pack_of_each_replicas_sequences(n):
    """Each replica's leaves are ``pack`` of a contiguous run of the
    sequences, in order, its ``cu_seqlens`` ``cu_seqlens_of`` their lengths
    and its positions ``positions_of`` them; the phantom tail follows on
    the last replica; the runs balance the tokens to within a sequence;
    "max_seqlen" is the longest segment, the tail counted."""
    batch, padded = packed_lm_batch(512)
    parts = packing.split_packed(batch, n)
    assert len(parts) == n
    runs, start = [], 0
    for part in parts:
        k = part["cu_seqlens"].shape[0] - 1
        lens = LENS[start:start + k]
        runs.append(sum(lens))
        assert k >= 1 and part["cu_seqlens"].tolist() == packing.cu_seqlens_of(lens).tolist()
        rows = slice(start, start + k)
        t = sum(lens)
        assert torch.equal(part["tokens"][:t], packing.pack(padded["tokens"][rows], lens))
        assert torch.equal(part["labels"][0, :t], packing.pack(padded["labels"][rows], lens))
        assert torch.equal(part["mask"][0, :t], packing.pack(padded["mask"][rows], lens))
        assert part["positions"][:t].tolist() == packing.positions_of(lens).tolist()
        tail = part["tokens"].shape[0] - t
        assert part["max_seqlen"] == max(max(lens), tail)
        assert part["labels"].shape == part["mask"].shape == (1, t + tail)
        start += k
    assert start == len(LENS) and sum(p["tokens"].shape[0] for p in parts[:-1]) == sum(runs[:-1])
    assert parts[-1]["tokens"].shape[0] - runs[-1] == 64 - sum(LENS)
    total = sum(p["tokens"].shape[0] for p in parts)
    cut = 0
    for j, part in enumerate(parts[:-1]):
        cut += part["tokens"].shape[0]
        assert abs(cut - total * (j + 1) / n) <= max(LENS)


def test_split_packed_refusals():
    batch, _ = packed_lm_batch(512)
    with pytest.raises(ValueError, match="8 batch replicas"):
        packing.split_packed(batch, 8)
    with pytest.raises(ValueError, match="exceeds max_seqlen 11"):
        packing.split_packed(batch, 2, max_seqlen=11)
    packing.split_packed(batch, 2, max_seqlen=12)  # the phantom tail of 15 may be longer
    with pytest.raises(ValueError, match="packed leaf"):
        packing.split_packed(dict(batch, labels=batch["labels"].reshape(-1, 1)), 2)


def test_sharded_step_refuses_what_one_device_refuses():
    """Recurrent (``NotImplementedError``), encoder-decoder and prefix
    configs (``AssertionError``) refuse a packed batch on a mesh as the
    single-device forward does; a packed batch at ``n_micro=2``, a
    ``max_seqlen`` below its longest sequence (on one device too) and fewer
    sequences than replicas raise ``ValueError``."""
    for arch, kind in (("mamba2-1.3b", NotImplementedError),
                       ("recurrentgemma-9b", NotImplementedError),
                       ("seamless-m4t-medium", AssertionError),
                       ("internvl2-76b", AssertionError)):
        cfg = get_config(arch).reduced()
        params = TM.init_params(cfg, seed=0, device="cpu")
        batch, _ = packed_lm_batch(cfg.vocab_size)
        with pytest.raises(kind):
            TM.forward(params, cfg, batch, impl="reference")
        with pytest.raises(kind):
            sharded_step(cfg, params, batch, OPT, cpu_mesh((2, 1)))
    cfg = get_config("qwen2-0.5b").reduced()
    params = TM.init_params(cfg, seed=0, device="cpu")
    batch, _ = packed_lm_batch(cfg.vocab_size)
    with pytest.raises(ValueError, match="n_micro=2"):
        sharded_step(cfg, params, batch, OPT, cpu_mesh((2, 2)), n_micro=2)
    mesh = cpu_mesh((2, 2))
    sp = place(params, mesh)
    step = steps.make_train_step(cfg, OPT, impl="reference", mesh=mesh, max_seqlen=11)
    with pytest.raises(ValueError, match="exceeds max_seqlen 11"):
        step(sp, adamw.init(OPT, sp), batch)
    with pytest.raises(ValueError, match="exceeds max_seqlen 11"):
        steps.make_train_step(cfg, OPT, impl="reference", max_seqlen=11)(
            params, adamw.init(OPT, params), batch)
    one, _ = packed_lm_batch(cfg.vocab_size, lens=[12])
    with pytest.raises(ValueError, match="2 batch replicas"):
        sharded_step(cfg, params, one, OPT, mesh)
