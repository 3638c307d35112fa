"""GPipe over a stage axis (``parallel/pipeline.py``): the JAX test's toy
(``tests/test_multidevice.py::test_pipeline_parallel_matches_sequential``:
8 tanh layers of 16 x 16 in 4 stages, 6 microbatches of 2 rows) through
the port's ``pipeline_apply`` on 4 logical CPU devices against the JAX
package's ``pipeline_apply`` under ``shard_map`` (one subprocess, 4 forced
host devices) on the same numpy-made weights and input, to 1e-6; and the
reduced qwen2-0.5b stack in 2 stages bit-equal to running it unpipelined
on each microbatch.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.parallel import collectives as C
from repro_torch.parallel import pipeline as PIPE
from repro_torch.parallel.layout import Layout, Mesh, P, ShardedTensor
from test_torch_tp_step import run_jax

L, D, B, MBS = 8, 16, 12, 6


def toy():
    rng = np.random.default_rng(0)
    return ((rng.normal(size=(L, D, D)) * 0.3).astype(np.float32),
            rng.normal(size=(B, D)).astype(np.float32))


JAX_PIPE = '''
import jax, jax.numpy as jnp, numpy as np
from repro.parallel.pipeline import pipeline_apply, microbatch
from repro.parallel.compat import auto_axis_types, make_mesh
mesh = make_mesh((4,), ("stage",), axis_types=auto_axis_types(1))
rng = np.random.default_rng(0)
ws = (rng.normal(size=(8, 16, 16)) * 0.3).astype(np.float32)
x = rng.normal(size=(12, 16)).astype(np.float32)
def layer_fn(w_stack, x):
    def body(x, w):
        return jnp.tanh(x @ w), None
    return jax.lax.scan(body, x, w_stack)[0]
out = pipeline_apply(layer_fn, jnp.asarray(ws).reshape(4, 2, 16, 16),
                     microbatch(jnp.asarray(x), 6), mesh=mesh).reshape(12, 16)
np.savez("{out}", out=np.asarray(out))
'''


def toy_layer(w_stack, x):
    for w in w_stack:
        x = torch.tanh(x @ w)
    return x


def test_pipeline_toy_matches_jax(tmp_path):
    want = run_jax(JAX_PIPE, str(tmp_path / "pipe.npz"))["out"]
    ws, x = toy()
    mesh = Mesh(np.arange(4), ("stage",), device="cpu")
    C.reset_stats()
    out = PIPE.pipeline_apply(toy_layer, torch.from_numpy(ws).reshape(4, 2, D, D),
                              PIPE.microbatch(torch.from_numpy(x), MBS), mesh=mesh)
    assert out.layout.spec == P() and len(out.blocks) == 4
    got = out.gather().reshape(B, D).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    seq = torch.from_numpy(x)
    for w in torch.from_numpy(ws):
        seq = torch.tanh(seq @ w)
    np.testing.assert_allclose(got, seq.numpy(), atol=1e-6)
    # 6 microbatches in, 3 hops each, and the result to 3 other stages
    act = 2 * D * 4
    assert C.STATS["bytes"] == MBS * act * 4 + 3 * B * D * 4


def test_stacked_params_may_be_laid_out_already():
    ws, x = toy()
    mesh = Mesh(np.arange(4), ("stage",), device="cpu")
    st = ShardedTensor.place(torch.from_numpy(ws).reshape(4, 2, D, D), Layout(mesh, P("stage")))
    a = PIPE.pipeline_apply(toy_layer, st, PIPE.microbatch(torch.from_numpy(x), MBS), mesh=mesh)
    b = PIPE.pipeline_apply(toy_layer, torch.from_numpy(ws).reshape(4, 2, D, D),
                            PIPE.microbatch(torch.from_numpy(x), MBS), mesh=mesh)
    assert torch.equal(a.gather(), b.gather())
    with pytest.raises(ValueError, match="microbatches"):
        PIPE.pipeline_apply(toy_layer, st, PIPE.microbatch(torch.from_numpy(x), 3), mesh=mesh)
    with pytest.raises(ValueError, match="laid out over"):
        PIPE.pipeline_apply(toy_layer, torch.from_numpy(ws), PIPE.microbatch(
            torch.from_numpy(x), MBS), mesh=mesh)


@pytest.mark.parametrize("stages,mbs", [(2, 4), (2, 2)])
def test_qwen_stack_in_stages_is_bit_equal_to_sequential(stages, mbs):
    cfg = get_config("qwen2-0.5b").reduced(n_superblocks=4, num_layers=4)
    params = TM.init_params(cfg, seed=0, device="cpu")
    toks = TM.synth_batch(1, cfg, 8, 4, "prefill", device="cpu")["tokens"]
    x = PIPE.microbatch(TM._embed(params, cfg, toks), mbs)
    mesh = Mesh(np.arange(stages), ("stage",), device="cpu")
    out = PIPE.pipeline_apply(
        lambda p, h: TT.stack_apply(PIPE.unstack_layers(p), cfg, h, impl="reference"),
        PIPE.stack_stages(params["layers"], stages), x, mesh=mesh)
    want = torch.stack([TT.stack_apply(params["layers"], cfg, xm, impl="reference")
                        for xm in x])
    assert all(torch.equal(b, want) for b in out.blocks.values())
