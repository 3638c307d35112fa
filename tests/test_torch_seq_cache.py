"""Decode caches split by slot (``parallel/steps.py`` with a mesh): where the
tensor axis does not divide the KV heads, each rank holds every KV head for
a ceil-sized block of a cache's slots, attends its block with
``decode_mha(return_lse=True)`` and the ranks merge their fp32 partials by
log-sum-exp (``collectives.lse_merge``); a batch-1 cache without batch axes
also splits over the data axis by the JAX dry run's rule.

On the CPU, in fp32: the merge of k slot blocks of ``decode_mha_ref``
against the unsplit call (1e-6 of the largest |value|: uneven blocks, an
empty block, ranks with no valid slot, a wrapped ring); sharded prefill and
4 teacher-forced decode steps against the port's single-device steps
(logits within 1e-5 of their largest magnitude, the gathered caches at
1e-5) and against the JAX package's single-device prefill and decode on
the same weights (``test_torch_tp_modal``'s 1e-5 of the largest logit):
reduced qwen2-0.5b (2 KV heads) on (1, 4), where a rank's block is still
empty at the first step and a step crosses a block boundary, and
``test_torch_split_heads.GEMMA2`` on (1, 4), its 16-slot ring wrapped and
a step crossing from one rank's block to the next; batch-1 caches of 4,096
slots on (2, 2), split 4 ways (1 KV head) and 2 ways (2 KV heads, the
model axis holding them by head).  One JAX subprocess evaluates the JAX
dry run's ``_cache_specs_tree`` on ``steps.cache_specs`` of every assigned
decode_32k and long_500k cell (at one superblock; the per-card bytes of
both layouts grow alike with depth) and prices its k/v per card on the
(16, 16) and (2, 16, 16) meshes; the port's ``meta_caches`` must hold the
same bytes per card where 16 divides a cache's slots and at most one slot
a rank more where it does not.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ASSIGNED, SHAPES, cell_supported, get_config
from repro_torch.configs.base import ATTN
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.parallel import collectives as C
from repro_torch.parallel import ctx as CTX
from repro_torch.parallel import sharding as SH
from repro_torch.parallel import steps
from repro_torch.parallel.layout import P, tree_leaves
from test_torch_split_heads import GEMMA2
from test_torch_tp_step import cpu_mesh, place, run_jax

TOL = 1e-5
MERGE_TOL = 1e-6
JDECODE = jax.jit(JM.decode_step, static_argnums=(1,))


# ------------------------------------------------------------ the merge

def split_decode(q, k, v, lens, window, ranks):
    """decode_mha_ref over ``ranks`` slot blocks of the cache (ceil-sized,
    as ``ShardingCtx.slots`` cuts them), merged by ``collectives.lse_merge``:
    {rank: merged (B, Hq, D)}."""
    mesh = cpu_mesh((1, ranks))
    ctx = CTX.ShardingCtx(mesh, (), "model")
    cap = k.shape[1] if window is None else min(k.shape[1], window)
    outs, lses = {}, {}
    for r in mesh.device_ids:
        s = ctx.slots(("model",), cap, r)
        local = torch.tensor([s.length(int(n) - 1) for n in lens], dtype=torch.int32)
        outs[r], lses[r] = ops.decode_mha(q, k[:, s.start:s.stop], v[:, s.start:s.stop],
                                          cache_len=local, return_lse=True, impl="reference")
        assert outs[r].dtype == lses[r].dtype == torch.float32
    return C.lse_merge(outs, lses, mesh, "model")


@pytest.mark.parametrize("cap,ranks,lens,window", [
    (10, 4, [10, 7, 1, 4], None),   # blocks 3, 3, 3, 1; row 2 valid on rank 0 only
    (13, 4, [2, 13, 5, 9], None),   # blocks 4, 4, 4, 1; ranks 1-3 empty for row 0
    (9, 4, [9, 3, 6, 1], None),     # blocks 3, 3, 3, 0: the last rank holds no slot
    (8, 4, [20, 9, 8, 3], 8),       # a ring of 8 wrapped in rows 0 and 1, not yet full in 3
    (16, 2, [16, 15, 16, 1], 16)])
def test_lse_merge_of_slot_blocks_equals_the_unsplit_decode(cap, ranks, lens, window):
    g = np.random.default_rng(cap)
    q, k, v = (torch.from_numpy(g.standard_normal(s).astype(np.float32))
               for s in ((4, 6, 32), (4, cap, 2, 32), (4, cap, 2, 32)))
    lens = torch.tensor(lens, dtype=torch.int32)
    want = ref.decode_mha_ref(q, k, v, cache_len=lens, window=window)
    want_lse = ref.decode_mha_ref(q, k, v, cache_len=lens, window=window, return_lse=True)
    np.testing.assert_allclose(want_lse[0].numpy(), want.numpy(), atol=MERGE_TOL, rtol=0)
    for got in split_decode(q, k, v, lens, window, ranks).values():
        assert float((got - want).abs().max()) <= MERGE_TOL * float(want.abs().max())


def test_a_row_with_no_valid_key_weighs_nothing():
    """The plain version's lse contract: the log-sum-exp of the scaled
    logits over the valid keys, and for a row with no valid key out 0 and
    lse -inf (where without lse it averages every slot)."""
    g = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(g.standard_normal(s).astype(np.float32))
               for s in ((3, 4, 16), (3, 5, 1, 16), (3, 5, 1, 16)))
    lens = torch.tensor([0, 2, 5], dtype=torch.int32)
    out, lse = ops.decode_mha(q, k, v, cache_len=lens, return_lse=True, impl="reference")
    assert torch.equal(out[0], torch.zeros_like(out[0])) and bool(torch.isneginf(lse[0]).all())
    logits = torch.einsum("bhd,bkd->bhk", q, k[:, :, 0]) / 4.0
    for b, n in ((1, 2), (2, 5)):
        np.testing.assert_allclose(lse[b].numpy(), torch.logsumexp(logits[b, :, :n], -1).numpy(),
                                   rtol=1e-6)
    plain = ops.decode_mha(q, k, v, cache_len=lens, impl="reference")
    np.testing.assert_allclose(plain[0].numpy(), v[0, :, 0].mean(0).expand(4, 16).numpy(),
                               atol=MERGE_TOL, rtol=0)


# ------------------------------------------------------------ the steps

def jax_pair(arch, kw, seed=0):
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    from repro.configs import ARCHS as JARCHS
    jcfg, tcfg = JARCHS[arch].reduced(**kw), get_config(arch).reduced(**kw)
    tree = jax.tree.map(np.array, JM.init_params(jax.random.PRNGKey(seed), jcfg))
    tree["embed"]["table"] *= 0.05
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_jax(tree, tcfg, device="cpu")


def serve(cfg, params, mesh, toks, feed, *, rules=None, extra=None):
    """Prefill of ``toks`` then a teacher-forced decode step per column of
    ``feed``, single-device and sharded: [(logits, sharded logits, caches,
    sharded caches)] per call."""
    s, n = toks.shape[1], feed.shape[1]
    extra = extra or n
    prompt = {"tokens": torch.from_numpy(toks).long()}
    sp = place(params, mesh)
    lg1, c1 = steps.make_prefill_step(cfg, impl="reference", extra_len=extra)(params, prompt)
    lg2, c2 = steps.make_prefill_step(cfg, impl="reference", extra_len=extra, mesh=mesh,
                                      rules=rules)(sp, prompt)
    out = [(lg1, lg2, c1, c2)]
    d1 = steps.make_decode_step(cfg, impl="reference")
    d2 = steps.make_decode_step(cfg, impl="reference", mesh=mesh, rules=rules)
    for i in range(n):
        tok = torch.from_numpy(feed[:, i]).long()
        lg1, c1 = d1(params, tok, c1, s + i)
        lg2, c2 = d2(sp, tok, c2, s + i)
        out.append((lg1, lg2, c1, c2))
    return out


def assert_serve(runs):
    for lg1, lg2, c1, c2 in runs:
        got = lg2.gather()
        assert float((got - lg1).abs().max()) <= TOL * float(lg1.abs().max())
        for a, b in zip(c1, steps.gathered_caches(c2)):
            for name in ("k", "v"):
                assert b[name].shape == a[name].shape
                np.testing.assert_allclose(b[name].numpy(), a[name].numpy(), atol=TOL, rtol=TOL)


def jax_logits(jcfg, jp, toks, feed):
    s, n = toks.shape[1], feed.shape[1]
    last, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, s + n)
    out = [np.asarray(JM.logits_of(jp, jcfg, last[:, None])[:, 0])]
    for i in range(n):
        lg, jc = JDECODE(jp, jcfg, jnp.asarray(feed[:, i]), jc, jnp.int32(s + i))
        out.append(np.asarray(lg))
    return out


@pytest.mark.parametrize("arch,kw,prompt_len", [("qwen2-0.5b", {}, 10),
                                                ("gemma3-1b", GEMMA2, 19)])
def test_split_caches_match_one_device_and_jax(arch, kw, prompt_len):
    """qwen: 14 slots in blocks of 4, the prompt of 10 leaves rank 3 empty
    at the first step and t = 11 -> 12 crosses into it.  gemma: the 16-slot
    ring wrapped by the prompt of 19, blocks of 4, t = 19 -> 20 crosses
    from rank 0's block (slot 3) to rank 1's (slot 4); the global layer's
    23 slots in blocks of 6."""
    jcfg, jp, cfg, params = jax_pair(arch, kw)
    assert TT.seq_split(cfg, 4) and cfg.n_kv_heads % 4
    g = np.random.default_rng(1)
    toks = g.integers(1, cfg.vocab_size, (4, prompt_len)).astype(np.int32)
    feed = g.integers(1, cfg.vocab_size, (4, 4)).astype(np.int32)
    runs = serve(cfg, params, cpu_mesh((1, 4)), toks, feed)
    assert_serve(runs)
    for want, (_, lg2, _, _) in zip(jax_logits(jcfg, jp, toks, feed), runs):
        np.testing.assert_allclose(lg2.gather().numpy(), want, rtol=0,
                                   atol=TOL * np.abs(want).max())
    for spec, layer in zip(cfg.layers, runs[-1][3]):
        cap = min(spec.window or 10**9, prompt_len + 4)
        for st in layer.values():
            assert st.layout.spec == P("data", "model", None, None)
            assert st.blocks[0].shape[1:3] == (-(-cap // 4), cfg.n_kv_heads)


@pytest.mark.parametrize("kw,ways", [(dict(n_heads=2, n_kv_heads=1), 4), ({}, 2)])
def test_a_batch1_cache_of_4096_slots_splits_over_data(kw, ways):
    """No batch axis (the dry run's batch-1 rules) on (2, 2): the slots of
    a 4,096-slot cache split over the data axis by the JAX rule, and over
    the model axis too where it does not divide the KV heads (1 of 1: 4
    ways, P(None, (data, model))); with 2 KV heads the model axis holds
    them by head and the slots split 2 ways, P(None, data, model).  The
    prompt of 1,022 and 4 steps cross the first block's end at 1,024."""
    cfg = get_config("qwen2-0.5b").reduced(**kw)
    params = TM.init_params(cfg, seed=0, device="cpu")
    params["embed"]["table"].mul_(0.05)
    rules = dataclasses.replace(SH.ShardingRules(), dp_axes=())
    g = np.random.default_rng(2)
    toks = g.integers(1, cfg.vocab_size, (1, 1022)).astype(np.int32)
    feed = g.integers(1, cfg.vocab_size, (1, 4)).astype(np.int32)
    runs = serve(cfg, params, cpu_mesh((2, 2)), toks, feed, rules=rules, extra=4096 - 1022)
    assert_serve(runs)
    k = runs[-1][3][0]["k"]
    assert k.shape[1] == 4096 and k.blocks[0].shape[1] == 4096 // ways
    assert k.layout.spec == (P(None, ("data", "model"), None, None) if ways == 4
                             else P(None, "data", "model", None))


def test_a_ring_shorter_than_its_ranks_is_refused():
    cfg = get_config("gemma3-1b").reduced(**dict(GEMMA2, superblock=(
        dataclasses.replace(GEMMA2["superblock"][0], window=2), GEMMA2["superblock"][1])))
    TT.check_sharded(cfg, 2)
    with pytest.raises(ValueError, match="ring of 2 slots"):
        steps.make_decode_step(cfg, impl="reference", mesh=cpu_mesh((1, 4)))


# ------------------------------------------- the dry run's cache bytes

JAX_SPECS = '''
import dataclasses, types
import numpy as np
from repro.launch import dryrun as JD
from repro.configs import ARCHS, ASSIGNED, SHAPES
from repro.parallel import steps as JS
import jax

SIZES = {"pod": 2, "data": 16, "model": 16}
out = {}
for arch in ASSIGNED:
    full = ARCHS[arch]
    cfg = dataclasses.replace(full, n_superblocks=1,
                              num_layers=len(full.superblock) + len(full.tail))
    for shape in ("decode_32k", "long_500k"):
        sh = SHAPES[shape]
        for pod in (False, True):
            ax = ("pod", "data") if pod else ("data",)
            mesh = types.SimpleNamespace(shape={a: SIZES[a] for a in ax + ("model",)})
            shapes = JS.cache_specs(cfg, sh.global_batch, sh.seq_len + 1)
            specs = JD._cache_specs_tree(shapes, JD._batch_spec(sh.global_batch, mesh, ax),
                                         seq_shard=(shape == "long_500k"))
            total = 0
            leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
            parts_of = jax.tree_util.tree_leaves(
                specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
            assert len(leaves) == len(parts_of)
            for (path, x), spec in zip(leaves, parts_of):
                if getattr(path[-1], "key", None) not in ("k", "v"):
                    continue
                n = x.dtype.itemsize
                for dim, part in zip(x.shape, tuple(spec) + (None,) * (x.ndim - len(spec))):
                    parts = () if part is None else ((part,) if isinstance(part, str) else part)
                    n *= -(-dim // int(np.prod([SIZES[a] for a in parts])))
                total += n
            out[f"{arch}/{shape}/{int(pod)}"] = np.asarray(total, dtype=np.int64)
np.savez("{out}", **out)
'''


@pytest.fixture(scope="module")
def jax_cache_bytes(tmp_path_factory):
    return run_jax(JAX_SPECS, str(tmp_path_factory.mktemp("jax") / "specs.npz"), n=512)


def port_kv_bytes(cfg, shape, multi_pod):
    """(rank 0's k/v bytes of ``meta_caches`` on the production mesh, one
    slot of each of its split leaves in bytes)."""
    mesh = make_production_mesh(multi_pod)
    rules, b_axes, _ = D._variant_setup(D.CellSpec(cfg.name, shape.name, multi_pod), mesh)
    srules = D._step_rules(rules, D._batch_axes_for(shape.global_batch, mesh, b_axes))
    caches = D.meta_caches(cfg, mesh, srules, shape.global_batch, shape.seq_len + 1,
                           layers=D.meta_params(cfg, mesh, rules)["layers"])
    r0 = mesh.device_ids[0]
    total = slot = 0
    for spec, layer in zip(cfg.layers, caches):
        if spec.kind != ATTN:
            continue
        for st in tree_leaves(layer):
            blk = st.blocks[r0]
            total += blk.numel() * blk.element_size()
            if st.layout.spec[1] is not None:
                slot += blk.numel() // blk.shape[1] * blk.element_size()
    return total, slot


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_dry_run_cache_bytes_per_card_match_jax(jax_cache_bytes, shape, multi_pod):
    sh = SHAPES[shape]
    seen = 0
    for arch in ASSIGNED:
        cfg = D.depth(get_config(arch), 1)
        if not cell_supported(cfg, sh)[0]:
            continue
        want = int(jax_cache_bytes[f"{arch}/{shape}/{int(multi_pod)}"])
        got, slot = port_kv_bytes(cfg, sh, multi_pod)
        if all(TA.cache_cap(s, sh.seq_len + 1) % 16 == 0 for s in cfg.layers if s.kind == ATTN):
            assert got == want, arch
        else:
            assert want <= got <= want + slot, (arch, got, want, slot)
        seen += 1
    assert seen >= (3 if shape == "long_500k" else 10)
