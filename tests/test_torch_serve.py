"""The port's serving entry points (``BatchServer``, ``BucketedGenerator``)
against ``generate`` and the JAX package, the port's import boundary, and
a CPU rehearsal of ``chip_smoke.py``'s model phases."""

import ast
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.models import model as JM
from repro_torch.kernels import build, ops
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from test_torch_model import make_pair

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pair():
    return make_pair(seed=1)


def _prompts(n, lo, hi, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, int(m)).astype(np.int32)
            for m in rng.integers(lo, hi, n)]


def test_batch_server_greedy_equals_generate_and_jax(pair):
    jcfg, jparams, tcfg, tparams = pair
    prompts = _prompts(4, 4, 30, tcfg.vocab_size)  # buckets 16 and 32
    server = tserve.BatchServer(tcfg, tparams, max_new=6, impl="reference")
    outs = server.serve(prompts)
    for pr, out in zip(prompts, outs):
        bucket = tserve.bucket_of(len(pr))
        toks = torch.zeros((1, bucket), dtype=torch.int64)
        toks[0, bucket - len(pr):] = torch.from_numpy(pr)
        want = TM.generate(tparams, tcfg, {"tokens": toks}, num_new_tokens=6,
                           impl="reference")["tokens"][0]
        np.testing.assert_array_equal(out.numpy(), want.numpy())
    jouts = jserve.BatchServer(jcfg, jparams, max_new=6).serve(prompts, None)
    for out, jout in zip(outs, jouts):
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_bucketed_generator_pads_and_trims_as_jax(pair):
    jcfg, jparams, tcfg, tparams = pair
    toks = np.random.default_rng(2).integers(1, tcfg.vocab_size, (2, 11)).astype(np.int32)
    tgen = TM.BucketedGenerator(tcfg, impl="reference", buckets=(8, 16, 32))
    jgen = JM.BucketedGenerator(jcfg, buckets=(8, 16, 32))
    tout = tgen(tparams, {"tokens": torch.from_numpy(toks)}, num_new_tokens=5)
    jout = jgen(jparams, {"tokens": jnp.asarray(toks)}, num_new_tokens=5)
    assert tout["tokens"].shape == (2, 5) and tout["logprobs"].shape == (2, 5)
    np.testing.assert_array_equal(tout["tokens"].numpy(), np.asarray(jout["tokens"]))
    np.testing.assert_allclose(tout["logprobs"].numpy(), np.asarray(jout["logprobs"]),
                               atol=1e-4)
    assert tout["caches"][0]["k"].shape[1] == 16 + 8  # prompt and gen buckets


def test_bucketed_generator_top_k_1_is_greedy(pair):
    """The contract of the JAX package's sampling-attribute test, on
    weights whose next-token distribution is not one-hot: top_k=1 sampling
    equals greedy, unrestricted sampling does not."""
    _, _, tcfg, tparams = pair
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(1, tcfg.vocab_size, (2, 8)))
    gen = TM.BucketedGenerator(tcfg, temperature=1.0, impl="reference")
    sampled = gen(tparams, {"tokens": toks}, num_new_tokens=8,
                  rng=torch.Generator().manual_seed(2))["tokens"]
    gen.top_k = 1
    top1 = gen(tparams, {"tokens": toks}, num_new_tokens=8,
               rng=torch.Generator().manual_seed(2))["tokens"]
    greedy = gen(tparams, {"tokens": toks}, num_new_tokens=8)["tokens"]
    np.testing.assert_array_equal(top1.numpy(), greedy.numpy())
    assert not np.array_equal(sampled.numpy(), top1.numpy())


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_cuda_entry_points_raise_on_cpu(pair):
    _, _, tcfg, tparams = pair
    toks = torch.ones((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        TM.generate(tparams, tcfg, {"tokens": toks}, num_new_tokens=2)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        tserve.BatchServer(tcfg, tparams, max_new=2).serve([np.arange(1, 5)])


def test_missing_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


def test_kernel_library_names_follow_sources():
    path = build.library_path("flash_attention")
    assert path.parent == ROOT / "build" / "kernels"
    assert path.name.startswith("flash_attention-") and path.suffix == ".so"
    assert set(build.KERNELS) == {p.stem for p in build.CSRC.glob("*.cu")}


# ------------------------------------------------ chip_smoke rehearsal

@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_chip_smoke_phases_on_cpu(chip_smoke, monkeypatch):
    """Phases 3 and 4 at the reduced size on the reference tier; the ops
    calls stand in for kernel launches to check the predicted counts."""
    cfg = chip_smoke.get_config("qwen2-0.5b").reduced()
    params = chip_smoke.make_params(cfg, seed=0, device="cpu")
    sl = chip_smoke.phase_slice(cfg, params, impl="reference", batch=2,
                                prompt_len=20, steps=3)
    assert sl["prefill_err"] == 0.0 and sl["decode_err"] == 0.0
    assert sl["argmax_agreement"] == 1.0

    calls = _count_ops(monkeypatch)
    prompts = chip_smoke.serve_prompts(cfg, requests=4, min_prompt=3, max_prompt=40)
    runs = chip_smoke.phase_serve(cfg, params, prompts, impl="reference", new=5)
    want = chip_smoke.predicted_launches(cfg, prompts, 5)
    n_buckets = len({tserve.bucket_of(len(p)) for p in prompts})
    assert n_buckets >= 2
    assert want == {"flash_mha": 2 * n_buckets, "flash_decode": 2 * 4 * n_buckets,
                    "paged_flash_decode": 0, "grouped_ffn": 0}
    assert calls == {k: 2 * v for k, v in want.items()}  # greedy + sampled
    assert all(not any(r["launches"].values())
               for r in runs.values())  # no kernel ran on the reference tier
    assert not all(bool((a == b).all()) for a, b in
                   zip(runs["greedy"]["outputs"], runs["sampled"]["outputs"]))


def _count_ops(monkeypatch):
    """Count the ops calls that stand in for kernel launches on the
    reference tier."""
    calls = {"flash_mha": 0, "flash_decode": 0, "paged_flash_decode": 0, "grouped_ffn": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    for op, name in (("mha", "flash_mha"), ("decode_mha", "flash_decode"),
                     ("paged_decode_mha", "paged_flash_decode"),
                     ("grouped_ffn", "grouped_ffn")):
        monkeypatch.setattr(ops, op, count(name, getattr(ops, op)))
    return calls


def test_chip_smoke_paged_phases_on_cpu(chip_smoke, monkeypatch):
    """The paged part of phase 3 and phase 5 at the reduced size, on phase
    5's traffic, on the reference tier: paged logits equal the dense
    decode's, every request returns its own max_new tokens, the small pool
    preempts, and the ops calls equal the predicted launches."""
    cfg = chip_smoke.get_config("qwen2-0.5b").reduced()
    params = chip_smoke.make_params(cfg, seed=0, device="cpu")
    pg = chip_smoke.phase_paged_slice(cfg, params, impl="reference", batch=2,
                                      prompt_len=20, steps=3, block_size=8)
    assert pg["paged_err"] < 1e-5 and pg["argmax_agreement"] == 1.0

    calls = _count_ops(monkeypatch)
    prompts, new = chip_smoke.continuous_traffic(cfg)
    assert len(prompts) == 16 and min(new) >= 8 and max(new) <= 64
    runs = chip_smoke.phase_continuous(cfg, params, prompts, new, impl="reference")
    assert runs["preempt"]["preemptions"] >= 1
    assert runs["greedy"]["preemptions"] == runs["sampled"]["preemptions"] == 0
    predicted = {k: sum(r["predicted"][k] for r in runs.values()) for k in calls}
    assert calls == predicted and predicted["paged_flash_decode"] > 0
    assert predicted["flash_decode"] == 0
    for r in runs.values():
        assert [len(t) for t in r["outputs"]] == new
        assert not any(r["launches"].values())
        assert r["kv_peak_bytes"] < r["full_buffer_bytes"]
    for a, b in zip(runs["greedy"]["outputs"], runs["preempt"]["outputs"]):
        np.testing.assert_array_equal(a, b)  # recompute after preemption is exact
    bk = chip_smoke.bucketed_on(cfg, params, prompts, new, impl="reference")
    for a, b in zip(runs["greedy"]["outputs"], bk["outputs"]):
        np.testing.assert_array_equal(a, b)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    import subprocess
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], env=env,
                         capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
