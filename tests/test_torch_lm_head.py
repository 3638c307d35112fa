"""The chunked LM head (``layers.chunked_lm_head_loss``) and the training
losses that run it, ``model.lm_loss`` and ``model.lm_loss_sharded``.

From 4,096 positions on (where 512 divides them) the head and the
cross-entropy run in checkpointed chunks of 512 positions, so no (B, S, V)
logits are held; the rule and the function are the JAX package's.  Held
here on numpy inputs from a seed:

- ``chunked_lm_head_loss`` against the JAX package's at an explicit chunk
  (S 64, chunk 16), at the default rule (S 4,096), at a length 512 does not
  divide and below 4,096 (both whole), with a mask that has zeros: the loss
  and the gradients of the hidden states and the head's weight at 1e-5;
- ``lm_loss`` at S 4,096 on a 2-layer narrow config, padded and packed,
  against the JAX package's: the loss and every leaf's gradient;
- the sharded step (``lm_loss_sharded``) on (2, 2) and (1, 4) CPU logical
  devices against the single-device step at S 4,096 in fp32, including a
  packed cohort whose replicas' token counts 512 does not divide, and a
  vocabulary the tensor axis does not divide;
- ``chip_smoke.py``'s phase 20 rehearsed at 2 layers (the chunked step
  against the whole head, a planted out-of-memory fallback, the sharded
  loss's collective bytes against their prediction) and phase 17c's
  4,096-token dry-run check on ``meta``.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.base import ATTN, LayerSpec
from repro_torch.data import packing
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.optim import adamw
from test_torch_model import _dicts
from test_torch_tp_step import assert_close_runs, cpu_mesh, sharded_step, single_step
from test_torch_train import GRAD_TOL, _np

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")
OPT = adamw.AdamWConfig(lr=1e-6)
GEMMA2 = dict(superblock=(LayerSpec(ATTN, 16), LayerSpec(ATTN, None)), n_superblocks=1,
              tail=(), num_layers=2)  # narrow gemma3-1b: one local, one global layer


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: at 4,096 positions the narrow configs' ops are
    many and small, and a pool of a thread per core in each test worker
    oversubscribes the machine under the suite's parallel workers (the
    file's torch tests ran 20-100x slower there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def head_inputs(b, s, d=16, v=64, seed=0):
    """hidden (B, S, D), the head's weight (V, D), labels, a mask with
    zeros: float32 numpy arrays from ``seed``."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, d)).astype(np.float32),
            rng.normal(size=(v, d)).astype(np.float32) * 0.3,
            rng.integers(0, v, (b, s)).astype(np.int32),
            (rng.random((b, s)) > 0.25).astype(np.float32))


@pytest.mark.parametrize("s,chunk,want", [(64, 16, 16), (4096, 0, 512), (8192, 0, 512),
                                          (4100, 0, 0), (2048, 0, 0), (512, 512, 0),
                                          (100, 30, 0)])
def test_lm_head_chunk_rule(s, chunk, want):
    """512 from 4,096 positions on; whole where the chunk does not divide
    the length or covers it."""
    assert L.lm_head_chunk(s, chunk) == want


@pytest.mark.parametrize("b,s,chunk", [(2, 64, 16), (1, 4096, 0), (1, 4100, 0), (2, 64, 0)])
def test_chunked_lm_head_loss_matches_jax(b, s, chunk):
    h, w, y, m = head_inputs(b, s)

    def jloss(h, w):
        return JL.chunked_lm_head_loss(
            lambda x: jnp.einsum("bsd,vd->bsv", x, w).astype(jnp.float32), h, y, m, chunk)

    (jl, jd), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(h, w)
    th, tw = (torch.from_numpy(x).requires_grad_(True) for x in (h, w))
    tl, td = L.chunked_lm_head_loss(lambda x: torch.einsum("bsd,vd->bsv", x, tw).float(), th,
                                    torch.from_numpy(y), torch.from_numpy(m), chunk)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert td.item() == float(jd) == max(m.sum(), 1.0)
    for got, want in ((th.grad, jg[0]), (tw.grad, jg[1])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())


def lm_batches(vocab, b, s, seed=1):
    """(JAX, port) train batches of random tokens, next-token labels and a
    mask with zeros."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, (b, s))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
             "mask": (rng.random((b, s)) > 0.2).astype(np.float32)}
    return ({k: jnp.asarray(v.astype(np.int32) if k != "mask" else v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def packed_batch(vocab, lens, seed=2):
    """A packed cohort of ``lens`` random sequences: labels the next token
    of the sequence, the mask 0 on each sequence's last token."""
    rng = np.random.default_rng(seed)
    toks = [rng.integers(1, vocab, n) for n in lens]
    return {"tokens": torch.from_numpy(np.concatenate(toks)),
            "positions": torch.from_numpy(np.concatenate([np.arange(n) for n in lens])),
            "cu_seqlens": torch.from_numpy(np.concatenate([[0], np.cumsum(lens)])),
            "labels": torch.from_numpy(np.concatenate([np.roll(t, -1) for t in toks])[None]),
            "mask": torch.from_numpy(np.concatenate(
                [(np.arange(n) < n - 1).astype(np.float32) for n in lens])[None])}


LENS = [700, 1100, 300, 900, 1096]  # 4,096 tokens; two replicas get 2,100 and 1,996


def jax_models(seed=0):
    """(JAX cfg, JAX params, port cfg, port params) of narrow qwen2-0.5b
    with shared weights: ``make_models``' draw, the JAX init jitted."""
    jcfg, tcfg = JARCHS["qwen2-0.5b"].reduced(), get_config("qwen2-0.5b").reduced()
    tree = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.array, tree)
    rng = np.random.default_rng(seed)
    tree["embed"]["table"] *= 0.05
    for d in _dicts(tree):
        if "b" in d:
            d["b"] = rng.normal(0, 0.1, d["b"].shape).astype(np.float32)
        if "scale" in d:
            d["scale"] = (1 + rng.normal(0, 0.1, d["scale"].shape)).astype(np.float32)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_jax(tree, tcfg, device="cpu")


def test_lm_loss_matches_jax_at_4096():
    """``lm_loss`` at 4,096 positions, where both packages chunk the head,
    on a 2-layer narrow qwen: the loss and every leaf's gradient against
    ``jax.grad``."""
    jcfg, jp, tcfg, tp = jax_models()
    jb, tb = lm_batches(tcfg.vocab_size, 1, 4096)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: JM.lm_loss(p, jcfg, b, remat=False)[0]))(
        jp, jb)
    tp = adamw._map(lambda t: t.clone().requires_grad_(True), tp)
    tl, _ = TM.lm_loss(tp, tcfg, tb, impl="reference")
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    want = adamw.leaves(params_from_jax(jax.tree.map(np.array, jg), tcfg, device="cpu"))
    got = adamw.leaves(tp)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g.grad), _np(w), atol=GRAD_TOL)


def narrow(arch="qwen2-0.5b", **kw):
    """(cfg, params): ``arch`` reduced to one layer, the port's init with
    the embedding scaled by 0.05."""
    cfg = get_config(arch).reduced(n_superblocks=1, num_layers=1, **kw)
    params = TM.init_params(cfg, seed=0, device="cpu")
    params["embed"]["table"].mul_(0.05)
    return cfg, params


def whole_head_loss(params, cfg, batch):
    """``lm_loss`` with the head taken whole: forward, logits_of,
    cross_entropy."""
    hidden = TM.forward(params, cfg, batch, impl="reference", max_seqlen=max(LENS))
    return L.cross_entropy(TM.logits_of(params, cfg, hidden), batch["labels"], batch["mask"])[0]


def test_packed_lm_loss_chunks_along_the_cohort(monkeypatch):
    """A packed (1, 4,096) cohort's head runs in 8 checkpointed chunks
    along T, and its loss and gradients equal the whole head's."""
    cfg, params = narrow()
    batch = packed_batch(cfg.vocab_size, LENS)
    calls = []
    checkpointed = L.checkpointed
    monkeypatch.setattr(L, "checkpointed", lambda fn, *a: calls.append(1) or checkpointed(fn, *a))
    runs = []
    for loss_fn in (lambda p: TM.lm_loss(p, cfg, batch, impl="reference",
                                         max_seqlen=max(LENS))[0],
                    lambda p: whole_head_loss(p, cfg, batch)):
        p = adamw._map(lambda t: t.clone().requires_grad_(True), params)
        loss = loss_fn(p)
        loss.backward()
        runs.append((loss.item(), [t.grad for t in adamw.leaves(p)]))
    assert len(calls) == 8
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-6)
    for g, w in zip(runs[0][1], runs[1][1]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6 * float(w.abs().max()))


SHARDED = {
    "padded-data2-model2": ({}, (2, 2), None),
    "packed-data2-model2": ({}, (2, 2), LENS),
    "vocab-undivided-model4": (dict(vocab_size=510), (1, 4), None),
}


@pytest.mark.parametrize("name", list(SHARDED))
def test_sharded_step_matches_single_device_at_4096(name):
    """The sharded step at 4,096 positions, each rank chunking its own rows
    by the global length's rule, against the single-device step in fp32:
    padded on (2, 2), a packed cohort dealt to two replicas as 2,100 and
    1,996 tokens (512 divides neither: each replica's last chunk is
    short), and a vocabulary of 510 the tensor axis does not divide (every
    rank holds the whole head).  (1, 4) with the vocabulary split runs in
    the phase 20 rehearsal below."""
    kw, shape, lens = SHARDED[name]
    cfg, params = narrow(**kw)
    if lens is None:
        batch = lm_batches(cfg.vocab_size, shape[0], 4096)[1]
    else:
        batch = packed_batch(cfg.vocab_size, lens)
        parts = packing.split_packed(batch, shape[0])
        assert [p["tokens"].shape[0] for p in parts] == [2100, 1996]
    assert_close_runs(single_step(cfg, params, batch, OPT),
                      sharded_step(cfg, params, batch, OPT, cpu_mesh(shape)))


# ------------------------------------------------- phase 20 rehearsed

@pytest.fixture(scope="module")
def cs():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


@pytest.fixture
def counted(cs, monkeypatch):
    """The phase's launch counters read the ``ops.mha`` calls that launch
    flash_mha on the card."""
    calls = dict.fromkeys(cs.launches(), 0)
    mha = ops.mha

    def wrapped(*a, **k):
        calls["flash_mha"] += 1
        return mha(*a, **k)
    monkeypatch.setattr(ops, "mha", wrapped)
    monkeypatch.setattr(cs, "reset_launches", lambda: calls.update(dict.fromkeys(calls, 0)))
    monkeypatch.setattr(cs, "launches", lambda: dict(calls))
    return calls


def test_phase20_head_train_on_cpu(cs, counted, monkeypatch):
    """20a on 2 narrow layers at 2 x 4,096, the whole head made to run out
    of memory at 2 rows: the chunked step at 2 rows, then both at 1, the
    chunked against the whole within 1e-5."""
    cfg = get_config("gemma3-1b").reduced(**GEMMA2)
    params = cs.make_dense_params(cfg, seed=0, device=CPU)
    whole = cs.whole_head_step

    def tight(cfg, opt_cfg, **kw):
        step = whole(cfg, opt_cfg, **kw)

        def run(params, state, batch):
            if batch["tokens"].shape[0] > 1:
                raise torch.OutOfMemoryError("planted")
            return step(params, state, batch)
        return run
    monkeypatch.setattr(cs, "whole_head_step", tight)
    total = dict.fromkeys(counted, 0)
    r = cs.report_head_train(cfg, params, cs.head_batch(cfg, CPU, 2), cs.FP32_GRAD_TOL,
                             cs.FP32_GRAD_TOL, total, "[head] 20a", impl="reference")
    assert r["tried"] == [(2, False), (1, True)] and r["rows"] == 1
    assert max(r["loss_err"], r["grad_norm_err"], r["global_err"], r["worst_leaf_err"]) <= 1e-5
    assert total["flash_mha"] == 3 * 2 * 2  # three steps of 2 layers x 2 with remat


def test_phase20_sharded_loss_bytes_on_cpu(cs, counted):
    """20c on 2 narrow layers at 2 x 4,096 on (1, 4): the step against one
    device, and the loss's collective bytes and all-reduce calls (forward,
    recompute, backward of each chunk) equal to the prediction."""
    cfg = get_config("gemma3-1b").reduced(**GEMMA2)
    params = cs.make_dense_params(cfg, seed=1, device=CPU)
    total = dict.fromkeys(counted, 0)
    cs.report_head_sharded(cfg, params, cs.head_batch(cfg, CPU, cs.HEAD_SHARDED_ROWS),
                           cs.FP32_GRAD_TOL, cs.FP32_GRAD_TOL, total, "[head] 20c",
                           impl="reference")
    assert total["flash_mha"] == (4 + 1) * 2 * 2
    nbytes, calls = cs.head_loss_predicted(2, 4096, 4)
    assert nbytes == 14 * 3 * 2 * 4096 * 4 and calls == {("all-reduce", 4096, 4, 1): 64}


def test_phase17c_dry_run_at_4096_on_cpu(cs):
    """The dry run's record of the chunked-head step on ``meta`` equals the
    step's on (1, 4), the chunks' all-reduces and their recompute
    included."""
    cfg = get_config("gemma3-1b").reduced(**GEMMA2)
    params = cs.make_params(cfg, seed=4, device=CPU)
    r = cs.phase_dry_check(cfg, params, cs.head_batch(cfg, CPU, 2, seed=5), impl="reference",
                           layout=cs.HEAD_LAYOUT)
    assert r["dry_record"] == r["record"]
    assert r["record"][("all-reduce", 2 * 512 * 4, 4, 1)] == 8 * 8
    assert r["memory"]["argument_bytes"] == r["argument_bytes"]


def test_phase20_full_size(cs):
    """The full phase's shapes: gemma3-1b's 26 layers at 4 x 4,096 chunked
    by 512, its head split over (1, 4), one local and one global layer for
    the 2-layer runs; the peaks reckoned from the shapes (PERF.md's
    prediction: 26.17 GB chunked, 86.30 GB whole)."""
    full = get_config(cs.HEAD)
    assert full.num_layers == 26 and full.vocab_size == 262_144 and full.tie_embeddings
    assert L.lm_head_chunk(cs.HEAD_SEQ) == 512 and full.vocab_size % cs.HEAD_LAYOUT[1] == 0
    two = cs.head_shallow(full)
    assert [s.window for s in two.layers] == [512, None]
    assert dataclasses.replace(two, dtype="float32") == cs.head_shallow(full, dtype="float32")
    shapes = TM.init_params(full, device="meta")
    assert [cs.head_peak_predicted(full, shapes, cs.HEAD_ROWS, cs.HEAD_SEQ, c)
            for c in (512, 0)] == [26_172_598_272, 86_302_140_416]
