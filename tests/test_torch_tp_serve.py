"""The port's sharded prefill and decode steps (``parallel/steps.py``
``make_prefill_step`` / ``make_decode_step`` with a mesh) on logical CPU
meshes against the single-device steps, in fp32.

Each rank holds its batch rows and its own KV heads of every cache
(``P(batch, None, model, None)``); the gathered cache must equal the
single-device one, and the logits, gathered over (batch, vocabulary),
the single-device logits, to 1e-5 of their largest magnitude; the greedy
tokens are equal.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ATTN, LayerSpec
from repro_torch.models import model as TM
from repro_torch.parallel import steps
from repro_torch.parallel.layout import P, tree_leaves
from test_torch_tp_step import cpu_mesh, place

TOL = 1e-5


def serve_case(cfg, shape, *, batch=4, prompt_len=8, new=5, seed=0):
    params = TM.init_params(cfg, seed=seed, device="cpu")
    params["embed"]["table"].mul_(0.05)
    mesh = cpu_mesh(shape)
    sp = place(params, mesh)
    prompt = TM.synth_batch(seed + 1, cfg, prompt_len, batch, "prefill", device="cpu")
    lg1, c1 = steps.make_prefill_step(cfg, impl="reference", extra_len=new)(params, prompt)
    lg2, c2 = steps.make_prefill_step(cfg, impl="reference", extra_len=new, mesh=mesh)(
        sp, prompt)
    out = [(lg1, lg2, c1, c2)]
    d1 = steps.make_decode_step(cfg, impl="reference")
    d2 = steps.make_decode_step(cfg, impl="reference", mesh=mesh)
    tok1, tok2 = lg1.argmax(-1), lg2.gather().argmax(-1)
    for t in range(prompt_len, prompt_len + new - 1):
        lg1, c1 = d1(params, tok1, c1, t)
        lg2, c2 = d2(sp, tok2, c2, t)
        out.append((lg1, lg2, c1, c2))
        tok1, tok2 = lg1.argmax(-1), lg2.gather().argmax(-1)
    return mesh, out


def assert_step(lg1, lg2, c1, c2):
    scale = float(lg1.abs().max())
    assert float((lg2.gather() - lg1).abs().max()) <= TOL * scale
    assert torch.equal(lg2.gather().argmax(-1), lg1.argmax(-1))
    assert len(c2) == len(c1)
    for a, b in zip(c1, c2):
        for k in ("k", "v"):
            assert b[k].shape == a[k].shape
            np.testing.assert_allclose(b[k].gather().numpy(), a[k].numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch,shape", [("qwen2-0.5b", (1, 2)), ("qwen2-0.5b", (2, 2)),
                                        ("qwen2-0.5b", (4, 1)), ("llama-7b", (1, 4)),
                                        ("granite-moe-1b-a400m", (2, 2))])
def test_sharded_prefill_and_decode_match_single_device(arch, shape):
    kw = dict(n_heads=8, n_kv_heads=4) if shape[1] == 4 else {}
    cfg = get_config(arch).reduced(**kw)
    mesh, runs = serve_case(cfg, shape)
    for lg1, lg2, c1, c2 in runs:
        assert_step(lg1, lg2, c1, c2)
    lg2, c2 = runs[0][1], runs[0][3]
    tp = mesh.shape["model"]
    assert lg2.layout.spec == P("data", "model" if tp > 1 else None)
    assert all(x.layout.spec == P("data", None, "model", None) for x in tree_leaves(c2))
    blk = c2[0]["k"].blocks[0]
    assert blk.shape[0] == 4 // mesh.shape["data"] and blk.shape[2] == cfg.n_kv_heads // tp


def test_window_layers_and_an_unsplit_vocabulary():
    """Sliding-window ring caches (the window shorter than prompt + new)
    and a vocabulary the model axis does not divide (logits replicated over
    model: ``P("data", None)``)."""
    cfg = get_config("qwen2-0.5b").reduced(vocab_size=509,
                                           superblock=(LayerSpec(ATTN, window=6),))
    mesh, runs = serve_case(cfg, (2, 2), prompt_len=10, new=4)
    for lg1, lg2, c1, c2 in runs:
        assert_step(lg1, lg2, c1, c2)
    assert runs[0][1].layout.spec == P("data", None)
    assert runs[0][3][0]["k"].shape[1] == 6


def test_decode_updates_the_blocks_in_place_and_refuses_grad():
    cfg = get_config("qwen2-0.5b").reduced()
    params = TM.init_params(cfg, seed=0, device="cpu")
    mesh = cpu_mesh((1, 2))
    sp = place(params, mesh)
    prompt = TM.synth_batch(1, cfg, 6, 2, "prefill", device="cpu")
    lg, caches = steps.make_prefill_step(cfg, impl="reference", mesh=mesh)(sp, prompt)
    before = {r: c.clone() for r, c in caches[0]["k"].blocks.items()}
    ptr = caches[0]["k"].blocks[1].data_ptr()
    steps.make_decode_step(cfg, impl="reference", mesh=mesh)(
        sp, lg.gather().argmax(-1), caches, 6)
    assert caches[0]["k"].blocks[1].data_ptr() == ptr
    assert not torch.equal(caches[0]["k"].blocks[1], before[1])
    assert not lg.blocks[0].requires_grad
    steps.make_prefill_step(cfg, impl="reference", mesh=cpu_mesh((1, 8)))  # a split head
    mesh3 = cpu_mesh((1, 3))  # q_dim 64 and d_ff 128: attention and FFN whole on every rank
    lg3, c3 = steps.make_prefill_step(cfg, impl="reference", mesh=mesh3)(place(params, mesh3),
                                                                         prompt)
    assert float((lg3.gather() - lg.gather()).abs().max()) <= TOL * float(lg.gather().abs().max())
    assert c3[0]["k"].layout.spec == P("data", None, None, None)
    assert c3[0]["k"].blocks[2].shape == c3[0]["k"].shape
    with pytest.raises(ValueError, match="rows"):
        steps.make_prefill_step(cfg, impl="reference", mesh=cpu_mesh((4, 1)))(
            place(params, cpu_mesh((4, 1))), TM.synth_batch(1, cfg, 6, 2, "prefill",
                                                             device="cpu"))
