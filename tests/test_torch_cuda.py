"""The CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``cuda`` and skips itself without a CUDA device
(the kernels have no CPU mode).  This file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: |kernel - plain| <= TOL * (1 + |plain|).  In fp32 both sides
differ only in summation order; in bf16 the plain version rounds scores and
probabilities to bf16 before its second product and the kernels do not
(2e-2 is the JAX package's bf16 tolerance for its own kernels).
"""

import pytest
import torch

from repro_torch.kernels import decode_attention, flash_attention, ref

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# flash grid of tests/test_kernels.py, plus G = 7 (qwen2-0.5b) and G = 3
MHA_GRID = [
    (2, 256, 4, 2, 64, True, None),
    (1, 256, 4, 1, 128, True, 64),
    (2, 128, 2, 2, 32, False, None),
    (1, 384, 6, 3, 64, True, 100),
    (1, 200, 4, 4, 64, True, None),   # non-aligned seq
    (2, 96, 14, 2, 64, True, None),   # qwen2-0.5b heads: G = 7
    (1, 136, 21, 7, 16, True, 40),    # G = 3, window
    (1, 512, 14, 2, 16, True, 128),   # q-chunked reference path
]

# decode grid of tests/test_kernels.py, plus G = 7 rows
DECODE_GRID = [
    (2, 512, 4, 2, 64, None, [100, 512]),
    (2, 128, 8, 1, 128, 128, [50, 4000]),
    (1, 300, 6, 3, 32, None, [299]),
    (3, 64, 2, 2, 64, 64, [64, 10, 1]),
    (4, 1088, 14, 2, 64, None, [1, 63, 64, 1088]),  # qwen2-0.5b heads
    (2, 96, 14, 2, 16, 96, [250, 7]),                # G = 7, ring
    (2, 40, 4, 2, 16, None, [0, 3]),                 # a row with no valid key
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(DTYPES[dtype])


def _close(got, want, dtype):
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = ((got - want).abs() / (1 + want.abs())).max().item()
    assert err <= TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window", MHA_GRID)
def test_flash_mha_kernel_matches_plain(b, s, hq, hkv, d, causal, window, dtype):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    q = _randn(gen, (b, s, hq, d), dtype, dev)
    k, v = (_randn(gen, (b, s, hkv, d), dtype, dev) for _ in range(2))
    want = ref.mha_ref(q, k, v, causal=causal, window=window)
    _close(flash_attention.flash_mha(q, k, v, causal=causal, window=window),
           want, dtype)
    pos = torch.arange(s, device=dev)[None]  # the no-skip position path
    _close(flash_attention.flash_mha(q, k, v, causal=causal, window=window,
                                     q_positions=pos, kv_positions=pos), want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 7])
def test_flash_mha_kernel_explicit_positions(window):
    """Shuffled key positions, keys tagged 2^30, and a query row with no
    valid key (the uniform average of ref.py)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    b, sq, skv, hq, hkv, d = 2, 5, 150, 14, 2, 64
    q = _randn(gen, (b, sq, hq, d), "float32", dev)
    k, v = (_randn(gen, (b, skv, hkv, d), "float32", dev) for _ in range(2))
    kv_pos = torch.stack([torch.randperm(skv, generator=gen, device=dev) + 3
                          for _ in range(b)])
    kv_pos[:, :4] = 2 ** 30
    q_pos = torch.stack([torch.arange(sq, device=dev) + 100,
                         torch.arange(sq, device=dev) + 2])
    q_pos[1, 0] = 1
    kw = dict(causal=True, window=window, q_positions=q_pos, kv_positions=kv_pos)
    _close(flash_attention.flash_mha(q, k, v, **kw), ref.mha_ref(q, k, v, **kw),
           "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,cap,hq,hkv,d,window,lens", DECODE_GRID)
def test_flash_decode_kernel_matches_plain(b, cap, hq, hkv, d, window, lens, dtype):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(3)
    q = _randn(gen, (b, hq, d), dtype, dev)
    kc, vc = (_randn(gen, (b, cap, hkv, d), dtype, dev) for _ in range(2))
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    want = ref.decode_mha_ref(q, kc, vc, cache_len=cl, window=window)
    _close(decode_attention.flash_decode(q, kc, vc, cache_len=cl, window=window),
           want, dtype)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take():
    dev = _card()
    q = torch.zeros(1, 8, 4, 64, device=dev)
    with pytest.raises(TypeError):
        flash_attention.flash_mha(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_mha(q, q.transpose(1, 2).contiguous().transpose(1, 2), q)
    with pytest.raises(ValueError, match="unsupported"):
        flash_attention.flash_mha(q[..., :48].contiguous(), q[..., :48].contiguous(),
                                  q[..., :48].contiguous())
    with pytest.raises(TypeError, match="int32"):
        decode_attention.flash_decode(q[:, 0], q, q, cache_len=torch.ones(
            1, dtype=torch.int64, device=dev))
    shifted = torch.zeros(q.numel() + 1, device=dev)[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        decode_attention.flash_decode(q[:, 0], shifted, shifted,
                                      cache_len=torch.ones(1, dtype=torch.int32,
                                                           device=dev))
