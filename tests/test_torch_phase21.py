"""``chip_smoke.py``'s phase 21 (blocks the tensor axis leaves whole, at
degree 3) rehearsed on logical CPU devices at the reduced size with
``impl="reference"``, in fp32, through the phase's own report: (a) reduced
llama-7b with a vocabulary of 513 (split over 3; attention and FFN whole)
trained on (2, 3) and (1, 3) against one device, its collectives' bytes
equal to ``whole_train_bytes``; (b, c) served on (1, 3) with reduced
recurrentgemma, mamba2 and granite, the bytes equal to
``sharded_serve_bytes``; (d) the (1, 8) -> (2, 3) move.  The ops calls that
stand in for kernel launches equal the phase's predictions.  A planted
fault, a whole block's output summed over the tensor axis, must be caught;
every strategy the plan search can emit on three 8-card nodes builds a
sharded train step; the full-size predictions are checked against the
arithmetic.
"""

import os
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.plan import Cluster, DeviceMesh, strategies_for
from repro_torch.kernels import ops
from repro_torch.models import model as TM
from repro_torch.optim import adamw
from repro_torch.parallel import collectives as C
from repro_torch.parallel import ctx as CTX
from repro_torch.parallel import steps
from test_torch_tp_step import cpu_mesh

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")
LLAMA = dict(vocab_size=513)
SERVE = dict(batch=4, prompt_len=8, steps=3, impl="reference")
REC = (("recurrentgemma-9b", dict(n_superblocks=1, num_layers=3, tail=(), d_ff=96)),
       ("mamba2-1.3b", dict(vocab_size=513)),
       ("granite-moe-1b-a400m", dict(vocab_size=513)))
OPS = (("mha", "flash_mha"), ("decode_mha", "flash_decode"), ("grouped_ffn", "grouped_ffn"),
       ("ssd", "ssd_scan"), ("rglru_scan", "rglru_scan"))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads, as ``test_torch_lm_head.py`` takes: the narrow
    configs' ops are many and small, and a thread per core in each test
    worker oversubscribes the machine under the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


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
    """The phase's launch counters read the ops calls that launch each
    kernel on the card (none launches on the reference tier)."""
    calls = dict.fromkeys(cs.launches(), 0)

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    for op, kernel in OPS:
        monkeypatch.setattr(ops, op, count(kernel, getattr(ops, op)))
    monkeypatch.setattr(cs, "reset_launches", lambda: calls.update(dict.fromkeys(calls, 0)))
    monkeypatch.setattr(cs, "launches", lambda: dict(calls))
    return calls


def llama(cs):
    cfg = get_config("llama-7b").reduced(**LLAMA)
    return cfg, cs.make_params(cfg, seed=0, device=CPU)


def train(cs, total):
    cfg, params = llama(cs)
    batch = cs.lm_batch(cfg, CPU, batch=4, prompt=4, new=12, seed=0)
    runs = cs.phase_whole_train(cfg, params, batch, cs.WHOLE_LAYOUTS, impl="reference")
    cs.report_whole_train(cfg, runs, (1e-5, 1e-5), total, "[whole] 21a")
    return cfg, runs


def test_phase21a_whole_train_on_cpu(cs, counted):
    total = dict.fromkeys(counted, 0)
    cfg, runs = train(cs, total)
    assert set(runs) == {(2, 3), (1, 3)}
    for r in runs.values():
        assert max(r["loss_err"], r["grad_norm_err"], r["global_err"], r["worst_leaf_err"]) <= 1e-5
        assert r["bytes"] == r["predicted_bytes"][0] > 0
    assert runs[(2, 3)]["predicted_bytes"][1]["fsdp"] > 0
    assert runs[(1, 3)]["predicted_bytes"][1]["fsdp"] == 0
    assert total["flash_mha"] == (1 + 6 + 3) * 2 * cfg.num_layers  # remat: 2 a layer


def test_phase21a_catches_a_whole_block_summed_over_the_tensor_axis(cs, counted, monkeypatch):
    class Summed(CTX.ShardingCtx):
        def tp_reduce(self, xs, op="sum"):
            return C.all_reduce(xs, self.mesh, "model", op=op)
    monkeypatch.setattr(CTX.ShardingCtx, "whole",
                        lambda self, **kw: Summed(self.mesh, self.batch_axes, None))
    with pytest.raises(SystemExit, match="disagrees with one device"):
        train(cs, dict.fromkeys(counted, 0))


def test_phase21bcd_whole_serve_and_move_on_cpu(cs, counted):
    total = dict.fromkeys(counted, 0)
    cfg, params = llama(cs)
    r = cs.report_whole_serve(cfg, params, total, "[whole] 21b", logit_tol=cs.FP32_LOGIT_TOL,
                              **SERVE)
    assert r["argmax_agreement"] == 1.0 and r["cache_err"] <= cs.FP32_LOGIT_TOL
    assert len(set(r["kv_bytes"])) == 1  # every rank holds the whole cache
    m = cs.phase_whole_move(params, CPU)
    assert m["n_moved"] == m["n_leaves"] and m["moved_bytes"] == m["predicted_bytes"]
    assert m["equal"] and m["n_aliased"] == 0
    for arch, kw in REC:
        c = get_config(arch).reduced(**kw)
        cs.report_whole_serve(c, cs.make_params(c, seed=3, device=CPU), total, "[whole] 21c",
                              logit_tol=cs.FP32_LOGIT_TOL, **SERVE)
    assert all(total[k] > 0 for k in ("flash_mha", "flash_decode", "grouped_ffn", "ssd_scan",
                                      "rglru_scan"))


def test_every_strategy_of_three_nodes_builds_a_train_step():
    """Every ``ParallelStrategy`` the search can pick on three whole
    8-card nodes (tensor degrees 1, 2, 3, 4, 6 and 8) builds the sharded
    train step of reduced llama-7b on its (dp, tp) mesh (its pp stages are
    the GPipe pipeline's, which runs a stage axis alone)."""
    cluster = Cluster(n_nodes=3, devs_per_node=8)
    cfg = get_config("llama-7b").reduced()
    found = set()
    for s in strategies_for(DeviceMesh(0, 3, 0, 8), cluster, cfg.num_layers):
        step = steps.make_train_step(cfg, adamw.AdamWConfig(), impl="reference",
                                     mesh=cpu_mesh((s.dp, s.tp)))
        assert callable(step)
        found.add(s.tp)
    assert found == {1, 2, 3, 4, 6, 8}


def test_phase21_full_size(cs):
    """The phase's full-width shapes: which blocks degree 3 leaves whole,
    the serve bytes (llama-7b moves only its vocabulary-parallel lookup's
    sum: 2 x 2 x 4 x 512 x 4,096 x 2 bytes at prefill), and the fp32 train
    step's reckoned peak under the card's 80 GB."""
    full = cs.first_layers(get_config(cs.WHOLE), cs.WHOLE_LAYERS)
    w = cs.whole_blocks(full, 3)
    assert w["attn"] and w["ffn"] and full.vocab_size % 3 == 0
    assert cs.sharded_serve_bytes(full, 3, 4, 512) == 2 * 2 * 4 * 512 * 4096 * 2
    assert cs.sharded_serve_bytes(full, 3, 4, 1, decode=True) == 2 * 2 * 4 * 4096 * 2
    rg = cs.whole_blocks(get_config("recurrentgemma-9b"), 3)
    assert rg["attn"] and rg["lru"] and not rg["ffn"]
    assert cs.whole_blocks(get_config("mamba2-1.3b"), 3)["ssm"]
    g = cs.whole_blocks(get_config("granite-moe-1b-a400m"), 3)
    assert g["attn"] and g["ffn"]
    meta = TM.init_params(cs.first_layers(get_config(cs.WHOLE), cs.WHOLE_LAYERS,
                                          dtype="float32"), seed=0, device="meta")
    n = sum(t.numel() for t in cs.tree_leaves(meta))
    assert 1.48e9 < n < 1.50e9
    assert cs.whole_peak_predicted(meta, (2, 3), host_ref=True) < 80e9
    nbytes, parts = cs.whole_train_bytes(full, TM.init_params(full, seed=0, device="meta"),
                                         (2, 3), 4, 512)
    # 2 replicas of 2 rows: the lookup's sum, 2 x (3 - 1) copies, and its backward from
    # the root alone, 3 - 1; the stack's gradient shares summed once, 2 x (3 - 1)
    act = 2 * 512 * 4096 * 2
    assert parts["embed"] == 2 * (2 * 2 + 2) * act
    assert parts["stream"] == 2 * 2 * 2 * act
    assert parts["grads"] > 0 and parts["fsdp"] > 0
