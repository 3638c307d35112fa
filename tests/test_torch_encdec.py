"""The encoder-decoder config seamless-m4t-medium ([audio]: an encoder over
``frames``, cross-attention in every decoder layer) and the prefix config
internvl2-76b ([vlm]: ``prefix_embeds`` spliced over the first positions)
in the port against the JAX package: the configs and their counts, the
bridged tree, and at the reduced size in fp32 the forward logits, prefill
plus 8 teacher-forced decode steps, greedy ``generate``, ``lm_loss`` and its
gradient against ``jax.grad``, the single-device steps, seamless's
``BucketedGenerator``; that the frames and the prefix matter and the
prefix's mask is zero; and every refusal, held to the JAX package's
exception type where it has one.

Weights come from the JAX package's ``init_params`` bridged through numpy,
the embedding scaled by 0.05, norm scales randomised (neither config has
biases).  Stated tolerances: logits within 1e-5 of the largest |logit|
(``test_torch_dense_configs.LOGIT_RTOL``), logprobs within 1e-5 (1 +
|logprob|), the loss within 1e-5 relative, gradients within ``GRAD_TOL``
(1e-5) absolute; greedy tokens bit-equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.models import paged_cache as JPC
from repro.models import spec as JSPEC
from repro.parallel import steps as JSTEPS
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.models import paged_cache as PC
from repro_torch.models import spec as TSPEC
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import steps as TSTEPS
from test_torch_dense_configs import assert_logits_close, assert_logprobs_close
from test_torch_model import _dicts
from test_torch_tp_step import assert_close_runs, sharded_step, single_step
from test_torch_train import GRAD_TOL, _np

SEAMLESS, INTERNVL = "seamless-m4t-medium", "internvl2-76b"
NAMES = (SEAMLESS, INTERNVL)
JDECODE = jax.jit(JM.decode_step, static_argnums=(1,))


@functools.lru_cache(maxsize=None)
def make_pair(name, seed=0):
    """(jax cfg, jax params, port cfg, port params) with shared weights."""
    jcfg, tcfg = JARCHS[name].reduced(), get_config(name).reduced()
    tree = jax.tree.map(np.array, JM.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    tree["embed"]["table"] *= 0.05
    for d in _dicts(tree):
        if "scale" in d:
            d["scale"] = (1 + rng.normal(0, 0.1, d["scale"].shape)).astype(np.float32)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_jax(tree, tcfg, device="cpu")


def inputs(cfg, b, s, seed, kind="prefill"):
    """A numpy batch: tokens, the frames or prefix embeddings (normal), and
    for ``kind="train"`` labels and a mask zero over a prefix."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)}
    name = "frames" if cfg.family == "encdec" else "prefix_embeds"
    out[name] = rng.normal(0, 1, (b, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    if kind == "train":
        out["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        mask = np.ones((b, s), np.float32)
        if cfg.family != "encdec":
            mask[:, :cfg.prefix_len] = 0.0
        out["mask"] = mask
    return out


def both(batch):
    """The numpy batch as the JAX package's and the port's."""
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
             for k, v in batch.items()})


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    return make_pair(request.param)


# ------------------------------------------------------------- the configs

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_configs_and_counts_equal_jax(name, reduced):
    jc, tc = JARCHS[name], get_config(name)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
    assert set(jd) == set(td) and jd == td
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()


def test_full_width_shapes():
    """What phase 13 runs: seamless 12 + 12 layers of 1,024 (16 heads of
    64), 512 frames, an untied 256,206 vocabulary, 0.98B parameters;
    internvl2 80 layers of 8,192 (64 / 8 heads of 128), a 256-embedding
    prefix, 70.6B parameters by the count (8 of its layers 1.71 GB each in
    bf16, its embedding and head 2.1 GB each)."""
    s = get_config(SEAMLESS)
    assert (s.family, s.num_layers, s.enc_layers, s.prefix_len) == ("encdec", 12, 12, 512)
    assert (s.d_model, s.n_heads, s.n_kv_heads, s.head_dim) == (1024, 16, 16, 64)
    assert not s.tie_embeddings and round(s.param_count() / 1e9, 2) == 0.98
    v = get_config(INTERNVL)
    assert (v.family, v.num_layers, v.prefix_len, v.n_heads // v.n_kv_heads) == \
        ("dense", 80, 256, 8)
    assert round(v.param_count() / 1e9, 1) == 70.6
    assert round(2 * v.layer_params(v.layers[0]) / 1e9, 2) == 1.71
    assert round(2 * v.vocab_size * v.d_model / 1e9, 1) == 2.1


def test_encoder_depth_is_num_layers():
    """The JAX package builds the encoder from the decoder's pattern; the
    port does too (``enc_layers`` only feeds the count, and agrees)."""
    tcfg = get_config(SEAMLESS).reduced()
    params = TM.init_params(tcfg, seed=0, device="cpu")
    assert len(params["encoder"]["layers"]) == tcfg.num_layers == tcfg.enc_layers == 2
    assert all("xattn" in p and "lnx" in p for p in params["layers"])
    assert not any("xattn" in p for p in params["encoder"]["layers"])
    qk = dataclasses.replace(tcfg, qk_norm=True)
    p = TM.init_params(qk, seed=0, device="cpu")["layers"][0]
    assert "q_norm" in p["mixer"] and "q_norm" not in p["xattn"]


@pytest.mark.parametrize("name", NAMES)
def test_bridge_carries_every_leaf(name):
    """Every JAX leaf arrives, an encoder's and the ``xattn`` ones too: as
    many port tensors as JAX leaves times their stack depth, the same
    values, and the port's own ``init_params`` gives the same tree
    structure and shapes."""
    jcfg, jp, tcfg, tp = make_pair(name)
    n_stacked = sum(x.shape[0] if "groups" in "/".join(str(k) for k in path) else 1
                    for path, x in jax.tree_util.tree_leaves_with_path(jp))
    got = tadamw.leaves(tp)
    assert len(got) == n_stacked
    assert sum(t.numel() for t in got) == sum(x.size for x in jax.tree.leaves(jp))
    assert ("encoder" in tp) == (name == SEAMLESS)
    if name == SEAMLESS:
        np.testing.assert_array_equal(tp["encoder"]["layers"][1]["mixer"]["wq"]["w"].numpy(),
                                      np.asarray(jp["encoder"]["groups"][0]["b0"]["mixer"]
                                                 ["wq"]["w"][1]))
        np.testing.assert_array_equal(tp["layers"][0]["xattn"]["wo"]["w"].numpy(),
                                      np.asarray(jp["groups"][0]["b0"]["xattn"]["wo"]["w"][0]))
    own = TM.init_params(tcfg, seed=0, device="cpu")
    shapes = tadamw._map(lambda t: tuple(t.shape), own)
    assert shapes == tadamw._map(lambda t: tuple(t.shape), tp)


# --------------------------------------------------------------- the model

def test_forward_logits_match_jax(pair):
    jcfg, jp, tcfg, tp = pair
    jb, tb = both(inputs(jcfg, 2, 24, 1))
    jh, _ = JM.forward(jp, jcfg, jb, remat=False)
    th = TM.forward(tp, tcfg, tb, impl="reference")
    assert_logits_close(TM.logits_of(tp, tcfg, th).numpy(), JM.logits_of(jp, jcfg, jh))


def test_teacher_forced_decode_matches_jax(pair):
    """Prefill of 20 tokens (past the reduced prefix of 8), then 8 decode
    steps of fixed tokens: the prefill's last logits and every step's
    agree."""
    jcfg, jp, tcfg, tp = pair
    b, s, steps = 2, 20, 8
    jb, tb = both(inputs(jcfg, b, s, 2))
    feed = np.random.default_rng(3).integers(1, jcfg.vocab_size, (b, steps)).astype(np.int32)
    jlast, jc = JM.prefill(jp, jcfg, jb, s + steps)
    tlast, tc = TM.prefill(tp, tcfg, tb, s + steps, impl="reference")
    assert_logits_close(TM.logits_of(tp, tcfg, tlast[:, None]).numpy(),
                        JM.logits_of(jp, jcfg, jlast[:, None]), "prefill")
    if jcfg.family == "encdec":
        assert_logits_close(tc[1]["xkv"]["k"].numpy(), jc[0]["b0"]["xkv"]["k"][1], "xkv")
    for i in range(steps):
        jl, jc = JDECODE(jp, jcfg, jnp.asarray(feed[:, i]), jc, jnp.int32(s + i))
        tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(feed[:, i]), tc, s + i,
                                impl="reference")
        assert_logits_close(tl.numpy(), jl, f"step {i}")


def test_greedy_generate_is_bit_identical(pair):
    jcfg, jp, tcfg, tp = pair
    jb, tb = both(inputs(jcfg, 3, 16, 4))
    jout = JM.generate(jp, jcfg, jb, num_new_tokens=8)
    tout = TM.generate(tp, tcfg, tb, num_new_tokens=8, impl="reference")
    np.testing.assert_array_equal(tout["tokens"].numpy(), np.asarray(jout["tokens"]))
    assert_logprobs_close(tout["logprobs"].numpy(), jout["logprobs"])


def test_lm_loss_and_grads_match_jax(pair):
    """``lm_loss`` and its gradient in every leaf (the encoder's, the
    cross-attention's, the embedding's) against ``jax.grad``; then the
    single-device ``make_train_step`` takes the same batch."""
    jcfg, jp, tcfg, tp = pair
    jb, tb = both(inputs(jcfg, 2, 16, 5, kind="train"))
    jl, jg = jax.value_and_grad(lambda p: JM.lm_loss(p, jcfg, jb, remat=False)[0])(jp)
    tp = tadamw._map(lambda t: t.clone().requires_grad_(True), tp)
    tl, _ = TM.lm_loss(tp, tcfg, tb, impl="reference", remat=True)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    want = tadamw.leaves(params_from_jax(jax.tree.map(np.array, jg), tcfg, device="cpu"))
    got = tadamw.leaves(tp)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g.grad), _np(w), atol=GRAD_TOL)
    opt = tadamw.AdamWConfig(eps=1e-6)
    p2 = tadamw._map(lambda t: t.detach().clone().requires_grad_(True), tp)
    _, _, stats = TSTEPS.make_train_step(tcfg, opt, impl="reference")(
        p2, tadamw.init(opt, p2), tb)
    np.testing.assert_allclose(float(stats["loss"]), float(jl), rtol=1e-5)


def test_single_device_serving_steps_match_jax(pair):
    """``make_prefill_step`` and ``make_decode_step`` without a mesh take
    the frames / prefix embeddings through; logits against the JAX
    package's steps."""
    jcfg, jp, tcfg, tp = pair
    jb, tb = both(inputs(jcfg, 2, 12, 6))
    jlg, jc = JSTEPS.make_prefill_step(jcfg, extra_len=2)(jp, jb)
    tlg, tc = TSTEPS.make_prefill_step(tcfg, impl="reference", extra_len=2)(tp, tb)
    assert_logits_close(tlg.numpy(), jlg, "prefill step")
    tok = np.argmax(np.asarray(jlg), axis=-1).astype(np.int32)
    jl2, _ = JSTEPS.make_decode_step(jcfg)(jp, jnp.asarray(tok), jc, jnp.int32(12))
    tl2, _ = TSTEPS.make_decode_step(tcfg, impl="reference")(tp, torch.from_numpy(tok), tc, 12)
    assert_logits_close(tl2.numpy(), jl2, "decode step")
    shapes = TSTEPS.cache_specs(tcfg, 2, 14)
    jshapes = JSTEPS.cache_specs(jcfg, 2, 14)
    if tcfg.family == "encdec":
        assert tuple(shapes[0]["xkv"]["k"].shape) == tuple(jshapes[0]["b0"]["xkv"]["k"].shape[1:])
        assert tuple(shapes[0]["self"]["k"].shape) == tuple(jshapes[0]["b0"]["self"]["k"].shape[1:])
    else:
        assert tuple(shapes[0]["k"].shape) == tuple(jshapes[0]["b0"]["k"].shape[1:])


def test_bucketed_generator_matches_jax():
    """seamless's ``BucketedGenerator``: 11-token prompts left-padded to the
    16 bucket, 5 new tokens rounded to 16 and trimmed, the frames passed
    through unpadded; greedy tokens equal to the JAX class's."""
    jcfg, jp, tcfg, tp = make_pair(SEAMLESS)
    jb, tb = both(inputs(jcfg, 2, 11, 7))
    jout = JM.BucketedGenerator(jcfg, pad_id=0)(jp, jb, num_new_tokens=5)
    tout = TM.BucketedGenerator(tcfg, impl="reference", pad_id=0)(tp, tb, num_new_tokens=5)
    assert tout["tokens"].shape == (2, 5)
    np.testing.assert_array_equal(tout["tokens"].numpy(), np.asarray(jout["tokens"]))
    assert_logprobs_close(tout["logprobs"].numpy(), jout["logprobs"])


# -------------------------------------------------------- the inputs matter

def test_frames_change_the_logits():
    """seamless: changing the audio frames changes the decoder's logits
    (``tests/test_models.py``'s check), in forward and in decode."""
    _, _, tcfg, tp = make_pair(SEAMLESS)
    _, tb = both(inputs(tcfg, 2, 8, 8))
    moved = dict(tb, frames=tb["frames"] + 1.0)
    h1 = TM.forward(tp, tcfg, tb, impl="reference")
    h2 = TM.forward(tp, tcfg, moved, impl="reference")
    assert (h1 - h2).abs().max().item() > 1e-4
    l1, _ = TM.prefill(tp, tcfg, tb, 9, impl="reference")
    l2, _ = TM.prefill(tp, tcfg, moved, 9, impl="reference")
    assert (l1 - l2).abs().max().item() > 1e-4


def test_prefix_embeds_replace_the_first_tokens():
    """internvl2: changing ``prefix_embeds`` changes the logits; changing
    the token ids under the prefix changes nothing (the splice replaces
    them), nor does the loss with the mask zero there."""
    _, _, tcfg, tp = make_pair(INTERNVL)
    _, tb = both(inputs(tcfg, 2, 16, 9, kind="train"))
    p = tcfg.prefix_len
    h1 = TM.forward(tp, tcfg, tb, impl="reference")
    h2 = TM.forward(tp, tcfg, dict(tb, prefix_embeds=tb["prefix_embeds"] * 1.5),
                    impl="reference")
    assert (h1 - h2).abs().max().item() > 1e-4
    toks = tb["tokens"].clone()
    toks[:, :p] = (toks[:, :p] + 7) % tcfg.vocab_size
    labels = tb["labels"].clone()
    labels[:, :p] = (labels[:, :p] + 11) % tcfg.vocab_size
    assert torch.equal(h1, TM.forward(tp, tcfg, dict(tb, tokens=toks), impl="reference"))
    l1, _ = TM.lm_loss(tp, tcfg, tb, impl="reference")
    l2, _ = TM.lm_loss(tp, tcfg, dict(tb, tokens=toks, labels=labels), impl="reference")
    assert l1.item() == l2.item()


@pytest.mark.parametrize("name", NAMES)
def test_synth_batch_matches_the_jax_shapes(name):
    """``synth_batch`` draws the frames or prefix embeddings in the config's
    dtype at the JAX package's shapes, and zeroes a prefix model's mask
    over its prefix, as the JAX one does."""
    jcfg, tcfg = JARCHS[name].reduced(), get_config(name).reduced()
    jb = JM.synth_batch(jax.random.PRNGKey(0), jcfg, 16, 2, "train")
    tb = TM.synth_batch(0, tcfg, 16, 2, device="cpu")
    assert set(tb) == set(jb)
    for k in jb:
        assert tuple(tb[k].shape) == jb[k].shape
    assert torch.equal(tb["mask"], torch.from_numpy(np.array(jb["mask"])))
    if name == INTERNVL:
        assert tb["mask"][:, :tcfg.prefix_len].sum() == 0
        assert tb["prefix_embeds"].dtype == torch.float32


# --------------------------------------------------------------- refusals

def raises_like_jax(jfn, tfn):
    """Both calls raise, the port the JAX package's exception type."""
    with pytest.raises(Exception) as jerr:
        jfn()
    with pytest.raises(jerr.type):
        tfn()
    return jerr.type


@pytest.mark.parametrize("name", NAMES)
def test_packed_batches_refused_like_jax(name):
    jcfg, jp, tcfg, tp = make_pair(name)
    cu = np.array([0, 5, 12], np.int32)
    toks = np.arange(1, 13, dtype=np.int32)
    pos = np.concatenate([np.arange(5), np.arange(7)]).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "cu_seqlens": jnp.asarray(cu),
          "positions": jnp.asarray(pos)}
    tb = {"tokens": torch.from_numpy(toks).long(), "cu_seqlens": torch.from_numpy(cu),
          "positions": torch.from_numpy(pos)}
    kind = raises_like_jax(lambda: JM.forward(jp, jcfg, jb, remat=False),
                           lambda: TM.forward(tp, tcfg, tb, impl="reference"))
    assert kind is AssertionError


@pytest.mark.parametrize("name", NAMES)
def test_spec_and_servers_refused_like_jax(name):
    """Speculative decoding refuses both; ``ContinuousBatchServer`` refuses a
    prefix config and, through its paged cache, an encoder-decoder;
    ``paged_cache_init`` refuses an encoder-decoder; ``BucketedGenerator``
    refuses a prefix config.  Each the JAX package's ``ValueError``."""
    jcfg, jp, tcfg, tp = make_pair(name)
    assert not JSPEC.spec_supported(jcfg) and not TSPEC.spec_supported(tcfg)
    qj, qt = JARCHS["qwen2-0.5b"].reduced(), get_config("qwen2-0.5b").reduced()
    assert raises_like_jax(lambda: JSPEC.check_spec_pair(jcfg, qj),
                           lambda: TSPEC.check_spec_pair(tcfg, qt)) is ValueError
    assert raises_like_jax(
        lambda: jserve.ContinuousBatchServer(jcfg, jp, n_slots=2, max_prompt=16, max_new=4),
        lambda: tserve.ContinuousBatchServer(tcfg, tp, n_slots=2, max_prompt=16, max_new=4,
                                             impl="reference")) is ValueError
    if name == SEAMLESS:
        assert raises_like_jax(
            lambda: JPC.paged_cache_init(jcfg, 2, 9, 8, 32, jcfg.dtype),
            lambda: PC.paged_cache_init(tcfg, 2, 9, 8, 32, torch.float32, "cpu")) is ValueError
    else:
        assert raises_like_jax(lambda: JM.BucketedGenerator(jcfg),
                               lambda: TM.BucketedGenerator(tcfg, impl="reference")) \
            is ValueError


@pytest.mark.parametrize("name", NAMES)
def test_batch_server_names_the_missing_input(name):
    """``BatchServer`` passes tokens only, in both packages: the JAX one
    fails with a ``KeyError``, the port with a ``ValueError`` that names
    the frames or the prefix embeddings."""
    jcfg, jp, tcfg, tp = make_pair(name)
    prompts = [np.arange(1, 12, dtype=np.int32)]
    with pytest.raises(KeyError):
        jserve.BatchServer(jcfg, jp, max_new=3).serve(prompts, None)
    want = "frames" if name == SEAMLESS else "prefix_embeds"
    with pytest.raises(ValueError, match=want):
        tserve.BatchServer(tcfg, tp, max_new=3, impl="reference").serve(prompts)


def test_fewer_tokens_than_the_prefix_raise():
    """The JAX splice would return a sequence of prefix_len; the port raises."""
    _, _, tcfg, tp = make_pair(INTERNVL)
    _, tb = both(inputs(tcfg, 1, tcfg.prefix_len - 1, 10))
    with pytest.raises(ValueError, match="prefix"):
        TM.forward(tp, tcfg, tb, impl="reference")


@pytest.mark.parametrize("name", NAMES)
def test_sharded_steps_refuse(name):
    """Every step with a mesh builds for both configs (the JAX package's
    GSPMD steps run them; the port's run in ``test_torch_tp_modal.py``),
    8 model ranks over the reduced configs' 4 query heads too (each rank
    computes every head), and 3 model ranks over a q_dim of 64, which the
    JAX package's ``sanitize_specs`` leaves whole: the port refuses none,
    and its (1, 3) train step, every attention and cross-attention whole on
    each rank, equals one device's (fp32, 1e-5)."""
    tcfg = get_config(name).reduced()
    three = TMESH.submesh(range(3), (1, 3), ("data", "model"), device="cpu")
    for mesh in (TMESH.make_test_mesh(4, device="cpu"),
                 TMESH.submesh(range(8), (1, 8), ("data", "model"), device="cpu"), three):
        assert callable(TSTEPS.make_train_step(tcfg, tadamw.AdamWConfig(), mesh=mesh))
        assert callable(TSTEPS.make_prefill_step(tcfg, mesh=mesh))
        assert callable(TSTEPS.make_decode_step(tcfg, mesh=mesh))
    _, tp = make_pair(name)[2:]
    _, batch = both(inputs(tcfg, 2, tcfg.prefix_len + 4, 3, "train"))
    opt = tadamw.AdamWConfig(lr=1e-6)
    assert_close_runs(single_step(tcfg, tp, batch, opt),
                      sharded_step(tcfg, tp, batch, opt, three))
