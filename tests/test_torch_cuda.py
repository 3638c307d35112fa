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

from repro_torch.kernels import (decode_attention, flash_attention, paged_decode_attention,
                                 ref)

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


# paged decode: block sizes 8, 16, 32 divide the kernel's 64-key tile; 24
# does not, so a tile spans blocks
PAGED_GRID = [(bs, d) for bs in (8, 16, 32) for d in (64, 128)] + [(24, 64)]


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs,d", PAGED_GRID)
def test_paged_flash_decode_kernel_matches_plain(bs, d, dtype):
    """Shuffled pool, ragged lengths with a row of 0 (the uniform average
    over all M * bs slots) and a full row; then the table past each live
    prefix pointed at block 0 poisoned with +-1e4."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(4)
    b, hq, hkv, m = 5, 14, 2, 9
    n = 1 + b * m
    q = _randn(gen, (b, hq, d), dtype, dev)
    kp, vp = (_randn(gen, (n, bs, hkv, d), dtype, dev) for _ in range(2))
    table = (torch.randperm(n - 1, generator=gen, device=dev) + 1).reshape(b, m).int()
    lens = torch.tensor([0, 1, bs + 3, 70, m * bs], dtype=torch.int32, device=dev)
    got = paged_decode_attention.paged_flash_decode(q, kp, vp, table, cache_len=lens)
    _close(got, ref.paged_decode_mha_ref(q, kp, vp, table, cache_len=lens), dtype)
    live = torch.arange(m, device=dev)[None] < (lens[:, None] + bs - 1) // bs
    t0 = torch.where(live, table, 0).int()
    kp[0], vp[0] = 1e4, -1e4
    poisoned = paged_decode_attention.paged_flash_decode(q, kp, vp, t0, cache_len=lens)
    _close(poisoned, ref.paged_decode_mha_ref(q, kp, vp, t0, cache_len=lens), dtype)
    _close(poisoned[1:], got[1:], dtype)  # rows with a valid key: no leak


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_mha", "flash_decode", "paged_flash_decode"])
def test_kernels_launch_on_a_second_card_after_the_first(kernel):
    """The shared-memory opt-in is per card: a kernel launched on card 0
    first must still launch on card 1.  D = 128 needs more than the 48 KB
    a card allows without the opt-in."""
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        gen = torch.Generator(device=dev).manual_seed(5)
        if kernel == "flash_mha":
            q, k, v = (_randn(gen, (1, 128, 4, 128), "float32", dev) for _ in range(3))
            got = flash_attention.flash_mha(q, k, v, causal=True)
            want = ref.mha_ref(q, k, v, causal=True)
        elif kernel == "flash_decode":
            q = _randn(gen, (2, 4, 128), "float32", dev)
            kc, vc = (_randn(gen, (2, 96, 2, 128), "float32", dev) for _ in range(2))
            cl = torch.tensor([7, 96], dtype=torch.int32, device=dev)
            got = decode_attention.flash_decode(q, kc, vc, cache_len=cl)
            want = ref.decode_mha_ref(q, kc, vc, cache_len=cl)
        else:
            q = _randn(gen, (2, 4, 128), "float32", dev)
            kp, vp = (_randn(gen, (7, 16, 2, 128), "float32", dev) for _ in range(2))
            table = torch.tensor([[1, 2, 3], [6, 5, 4]], dtype=torch.int32, device=dev)
            cl = torch.tensor([20, 48], dtype=torch.int32, device=dev)
            got = paged_decode_attention.paged_flash_decode(q, kp, vp, table, cache_len=cl)
            want = ref.paged_decode_mha_ref(q, kp, vp, table, cache_len=cl)
        with torch.cuda.device(dev):
            _close(got, want, "float32")


@pytest.mark.cuda
def test_paged_wrapper_rejects_what_the_kernel_does_not_take():
    dev = _card()
    q = torch.zeros(2, 4, 64, device=dev)
    pool = torch.zeros(5, 16, 2, 64, device=dev)
    table = torch.ones(2, 2, dtype=torch.int32, device=dev)
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    paged = paged_decode_attention.paged_flash_decode
    with pytest.raises(TypeError, match="int32"):
        paged(q, pool, pool, table.long(), cache_len=lens)
    shifted = torch.zeros(pool.numel() + 1, device=dev)[1:].view(pool.shape)
    with pytest.raises(ValueError, match="aligned"):
        paged(q, shifted, shifted, table, cache_len=lens)
    with pytest.raises(ValueError, match="unsupported"):  # G = 17 > 16
        paged(torch.zeros(2, 34, 64, device=dev), pool, pool, table, cache_len=lens)
