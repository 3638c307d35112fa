"""The CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``cuda`` and skips itself without a CUDA device
(the kernels have no CPU mode).  This file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: |kernel - plain| <= TOL * (1 + |plain|).  In fp32 both sides
differ only in summation order; in bf16 the plain version rounds scores and
probabilities to bf16 before its second product, where the decode kernels
keep scores in fp32 and carry probabilities to ~2^-17 (the bf16 split-KV
body of flash_decode and the paged kernel as two bf16 terms, the fp32 bodies
in fp32) and the prefill
kernels keep scores in fp32 and round their unnormalised probabilities
(2e-2 is the JAX package's bf16 tolerance for its own kernels).  The
grouped expert FFN takes fp32 products of the same values on both sides in
either dtype (in bf16 the kernel carries its intermediate H as two bf16
terms, ~2^-17 of |H|), so it is held to GROUPED_TOL: 1e-4 in bf16 lies
between the card's reading and what an intermediate rounded to bf16 once
would cost (~1e-3).  Its cohort independence is held bit for bit.  The SSD scan
is held, in either dtype, against a float64 sequential recurrence on the
same values, to twice the
larger of 1e-4 (the JAX package's own SSD tolerance) and the plain
version's own error against it: the chunked form's decays are differences
of cumulative sums, each ~|cumsum| * 2^-24 off in fp32, so the plain
version at chunk 128 is itself ~1.2-1.6e-4 off, and the fp32 kernel sums
its products one after another in fp32 FMAs where cuBLAS sums the plain
version's in blocks (on the H100 the kernel read 1.2x the plain version's
error at H 64, S 256).  In bf16 the tensor-core body takes exact products
of the bf16 values in fp32, carries M, the state and X w as two bf16 terms
(~2^-17 of each) and rounds y once, so y may move by bf16's unit roundoff
more (BF16_ROUND); its state is also held to FP32_SCAN_TOL of the plain
version at the model's distributions, and its bits across P splits.  The
RG-LRU recurrence keeps an fp32 carry on both sides, held like the SSD scan
to the plain version in fp32 on the same values (TOL, plus BF16_ROUND in
bf16).
"""

import math

import pytest
import torch

from repro_torch.kernels import (decode_attention, flash_attention, grouped_expert, ops,
                                 paged_decode_attention, ref, rglru_scan, ssd_scan,
                                 varlen_attention)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GROUPED_TOL = {"float32": 1e-5, "bfloat16": 1e-4}
SSD_F64_TOL = 1e-4
BF16_ROUND = 2.0 ** -8  # bf16's unit roundoff: one rounding moves y by <= 2^-8 |y|
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
    (4, 512, 32, 8, 128, True, None),  # llama-7b's prefill: G = 4, D 128
    (2, 256, 16, 2, 128, True, None),  # internvl2-76b's grouping: G = 8, D 128
    (4, 512, 56, 8, 128, True, None),  # arctic-480b's prefill: G = 7, D 128
]

# cross-attention (Sq, D, Hq, Hkv) over Skv 512 keys, non-causal: seamless's
# decode (Sq 1: one live row of the 64-row tile), a full tile, a ragged
# prompt; seamless's heads at D 64 (G 1), a G 8 grouping at D 128
CROSS_GRID = [(sq, d, hq, hkv) for sq in (1, 64, 200)
              for d, hq, hkv in ((64, 16, 16), (128, 16, 2))]

# decode grid of tests/test_kernels.py, plus G = 7 rows
DECODE_GRID = [
    (2, 512, 4, 2, 64, None, [100, 512]),
    (2, 128, 8, 1, 128, 128, [50, 4000]),
    (1, 300, 6, 3, 32, None, [299]),
    (3, 64, 2, 2, 64, 64, [64, 10, 1]),
    (4, 1088, 14, 2, 64, None, [1, 63, 64, 1088]),  # qwen2-0.5b heads
    (2, 96, 14, 2, 16, 96, [250, 7]),                # G = 7, ring
    (2, 40, 4, 2, 16, None, [0, 3]),                 # a row with no valid key
    (8, 1088, 32, 8, 128, None, [1, 17, 64, 65, 400, 777, 1000, 1088]),  # llama-7b
    (8, 1088, 56, 8, 128, None, [1, 17, 64, 65, 400, 777, 1000, 1088]),  # arctic-480b: G 7
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


def _close(got, want, dtype, tol=TOL):
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = ((got - want).abs() / (1 + want.abs())).max().item()
    assert err <= tol[dtype], err


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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,d,hq,hkv", CROSS_GRID)
def test_flash_mha_cross_attention_matches_plain(sq, d, hq, hkv, dtype):
    """Non-causal at Sq != Skv (the encoder-decoder's cross-attention over
    512 encoder frames): every query sees every key."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(2)
    b, skv = 3, 512
    q = _randn(gen, (b, sq, hq, d), dtype, dev)
    k, v = (_randn(gen, (b, skv, hkv, d), dtype, dev) for _ in range(2))
    _close(flash_attention.flash_mha(q, k, v, causal=False),
           ref.mha_ref(q, k, v, causal=False), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 7])
def test_flash_mha_kernel_explicit_positions(window, dtype):
    """Shuffled key positions, keys tagged 2^30, and a query row with no
    valid key (the uniform average of ref.py)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    b, sq, skv, hq, hkv, d = 2, 5, 150, 14, 2, 64
    q = _randn(gen, (b, sq, hq, d), dtype, dev)
    k, v = (_randn(gen, (b, skv, hkv, d), dtype, dev) for _ in range(2))
    kv_pos = torch.stack([torch.randperm(skv, generator=gen, device=dev) + 3
                          for _ in range(b)])
    kv_pos[:, :4] = 2 ** 30
    q_pos = torch.stack([torch.arange(sq, device=dev) + 100,
                         torch.arange(sq, device=dev) + 2])
    q_pos[1, 0] = 1
    kw = dict(causal=True, window=window, q_positions=q_pos, kv_positions=kv_pos)
    _close(flash_attention.flash_mha(q, k, v, **kw), ref.mha_ref(q, k, v, **kw), dtype)


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


def _decode_case(gen, lens, cap, window, hq, hkv, d, dtype, dev):
    """flash_decode against its plain version on random rows of the given
    lengths; in bf16 also against fp32 attention on the same values, within
    the output's own bf16 rounding."""
    b = len(lens)
    q = _randn(gen, (b, hq, d), dtype, dev)
    kc, vc = (_randn(gen, (b, cap, hkv, d), dtype, dev) for _ in range(2))
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = decode_attention.flash_decode(q, kc, vc, cache_len=cl, window=window)
    _close(got, ref.decode_mha_ref(q, kc, vc, cache_len=cl, window=window), dtype)
    if dtype == "bfloat16":  # the two bf16 P terms hold fp32 P's result closely
        q32, k32, v32 = (x.float() for x in (q, kc, vc))
        want = ref.decode_mha_ref(q32, k32, v32, cache_len=cl, window=window)
        _close(got, want, "bfloat16", {"bfloat16": 2 ** -8})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,d", [(1, 14, 2, 64), (64, 14, 2, 64), (1, 16, 1, 256),
                                        (64, 16, 1, 256)])
def test_flash_decode_at_split_boundaries(b, hq, hkv, d, dtype):
    """Lengths on and one past a 64-key tile edge, a row of 0 and a full
    row, over a linear cache of 1,088 slots and a 576-slot ring with rows
    past its capacity.  B 1 takes the most splits per (row, KV head) (17 on
    the linear cache, 9 on the ring, on 132 SMs), B 64 the fewest (3 with
    two KV heads, 5 with one): a split may start past its row's end, and a
    row's last split may hold fewer tiles."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(19)
    lengths = [0, 1, 63, 64, 65, 128, 129, 575, 576, 577, 1087, 1088]
    for cap, window in ((1088, None), (576, 576)):
        # ring rows past the capacity: every fifth length plus the ring's
        lens = [x + (cap if window and i % 5 == 4 else 0) for i, x in enumerate(lengths)]
        batches = [[x] for x in lens] if b == 1 else [[lens[i % len(lens)] for i in range(b)]]
        for rows in batches:
            _decode_case(gen, rows, cap, window, hq, hkv, d, dtype, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("d,hq,hkv", [(64, 14, 2), (256, 16, 1)])
def test_fp32_decode_keeps_the_fma_body(d, hq, hkv):
    """fp32 inputs still run the fp32-FMA decode body: flash_decode at the
    main path's widths held to the fp32 tolerance, which no bf16 or TF32
    product would meet."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(20)
    lens = [0, 1, 64, 65, 300, 511]
    q = _randn(gen, (len(lens), hq, d), "float32", dev)
    kc, vc = (_randn(gen, (len(lens), 512, hkv, d), "float32", dev) for _ in range(2))
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    for window in (None, 256):
        _close(decode_attention.flash_decode(q, kc, vc, cache_len=cl, window=window),
               ref.decode_mha_ref(q, kc, vc, cache_len=cl, window=window), "float32")


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
    shifted = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=dev)[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention.flash_mha(shifted, q.bfloat16(), q.bfloat16())


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


# the dense configs' paged layers at their continuous servers' tables, (Hq,
# Hkv, D, M, cache lengths before M * bs): qwen3-1.7b (Hq 16 on 8, D 128,
# G 2), gemma3-1b (4 on 1, D 256, G 4; prompts of up to 1,000 tokens take
# 68 blocks of 16), qwen2.5-14b (40 on 8, D 128, G 5: a group that is not a
# power of two), arctic-480b (56 on 8, D 128, G 7)
DENSE_PAGED = [(16, 8, 128, 36, [0, 1, 17, 64, 100, 333, 500]),
               (4, 1, 256, 68, [0, 1, 17, 100, 513, 777, 1000]),
               (40, 8, 128, 36, [0, 1, 17, 64, 100, 333, 500]),
               (56, 8, 128, 36, [0, 1, 17, 64, 100, 333, 500])]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,d,m,lens", DENSE_PAGED)
def test_paged_flash_decode_is_flash_decode_on_the_gathered_cache(hq, hkv, d, m, lens, dtype):
    """With M * bs equal to the linear cache's length both kernels run the
    same body on the same key values (bf16: the split-KV grid at the same
    splits; fp32: the FMA walk), so the paged kernel on a shuffled table
    gives flash_decode's bits on the cache gathered through it."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(6)
    b, bs = 8, 16
    n = 1 + b * m
    q = _randn(gen, (b, hq, d), dtype, dev)
    kp, vp = (_randn(gen, (n, bs, hkv, d), dtype, dev) for _ in range(2))
    table = (torch.randperm(n - 1, generator=gen, device=dev) + 1).reshape(b, m).int()
    lens = torch.tensor([*lens, m * bs], dtype=torch.int32, device=dev)
    got = paged_decode_attention.paged_flash_decode(q, kp, vp, table, cache_len=lens)
    _close(got, ref.paged_decode_mha_ref(q, kp, vp, table, cache_len=lens), dtype)
    kg, vg = (p[table.long()].reshape(b, m * bs, hkv, d) for p in (kp, vp))
    dense = decode_attention.flash_decode(q, kg, vg, cache_len=lens)
    torch.cuda.synchronize()
    assert torch.equal(got, dense)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1000, 1024, 2048])
def test_flash_mha_window_bites_at_d256(s, dtype):
    """gemma3-1b's prefill: D 256, 4 query heads on 1, window 512 with S
    past it (S 1000: most rows' windows start off a 64-key tile boundary,
    so the kernel's skipped tiles and the partial first tile both run)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(7)
    q = _randn(gen, (2, s, 4, 256), dtype, dev)
    k, v = (_randn(gen, (2, s, 1, 256), dtype, dev) for _ in range(2))
    _close(flash_attention.flash_mha(q, k, v, causal=True, window=512),
           ref.mha_ref(q, k, v, causal=True, window=512), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_mha", "flash_decode", "paged_flash_decode",
                                    "flash_mha_varlen"])
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
        elif kernel == "flash_mha_varlen":
            q, k, v = (_randn(gen, (150, 4, 128), "float32", dev) for _ in range(3))
            cu = torch.tensor([0, 37, 101, 140], dtype=torch.int32, device=dev)
            got = varlen_attention.flash_mha_varlen(q, k, v, cu)
            want = ref.mha_varlen_ref(q, k, v, cu)
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


# grouped expert FFN: (D, F, E) of the kernel grid; each at a decode-sized
# cohort and one past 32 * E rows
GROUPED_GRID = [(d, f, e) for d in (16, 64, 1024) for f in (32, 512) for e in (4, 32)]


def _grouped_inputs(gen, n, d, f, e, dtype, dev, sizes=None):
    """Rows and weights at the init's scales; group sizes from a random
    routing (``sizes`` None) or as given."""
    xs = _randn(gen, (n, d), dtype, dev)
    ws = (_randn(gen, (e, d, f), dtype, dev) * d ** -0.5,
          _randn(gen, (e, d, f), dtype, dev) * d ** -0.5,
          _randn(gen, (e, f, d), dtype, dev) * f ** -0.5)
    if sizes is None:
        eid = torch.sort(torch.randint(0, e, (n,), generator=gen, device=dev)).values
        gs = torch.zeros(e, dtype=torch.int32, device=dev).scatter_add_(
            0, eid, torch.ones_like(eid, dtype=torch.int32))
    else:
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    return xs, gs, ws


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,f,e", GROUPED_GRID)
def test_grouped_ffn_kernel_matches_plain(d, f, e, dtype):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(6)
    for n in (40, 32 * e + 5):
        xs, gs, ws = _grouped_inputs(gen, n, d, f, e, dtype, dev)
        _close(grouped_expert.grouped_ffn(xs, gs, *ws), ref.grouped_ffn_ref(xs, gs, *ws),
               dtype, GROUPED_TOL)


# (N, group sizes): an empty expert, all rows to one expert, groups that
# straddle 64-row tiles, N not a multiple of the tile, and rows past the
# total (which come out as zeros)
GROUPED_EDGES = [
    (40, [10, 0, 25, 5]),
    (33, [0, 0, 33, 0]),
    (7, [7, 0, 0, 0]),
    (129, [64, 65, 0, 0]),
    (300, [1, 130, 0, 169]),
    (16, [4, 4, 4, 4]),
    (100, [15, 0, 50, 30]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [16, 2048])
def test_grouped_ffn_at_128_experts(n, dtype):
    """arctic-480b's expert count at reduced widths: a decode cohort (16
    rows, most experts empty: every block walks 128 group sizes to find its
    unit) and a prefill one (2,048 rows, groups straddling 64-row tiles)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(8)
    xs, gs, ws = _grouped_inputs(gen, n, 256, 192, 128, dtype, dev)
    assert int(gs.sum()) == n and (n > 128 or int((gs == 0).sum()) >= 112)
    _close(grouped_expert.grouped_ffn(xs, gs, *ws), ref.grouped_ffn_ref(xs, gs, *ws), dtype,
           GROUPED_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [16, 2048])
def test_grouped_ffn_gradient_at_128_experts(n, dtype):
    """grouped_ffn's backward (``grouped_ffn_bwd_ref``, which both tiers
    run) against autograd through the plain per-expert loop
    ``grouped_ffn_ref`` in fp32 on the same values and cotangent, at
    arctic-480b's expert count.  The backward computes in fp32 and writes
    each gradient once in the inputs' dtype: one rounding, 2^-8 in bf16,
    beside the fp32 sums' order."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(9)
    xs, gs, ws = _grouped_inputs(gen, n, 256, 192, 128, dtype, dev)
    cot = _randn(gen, (n, 256), "float32", dev)
    grads = []
    for f, cast in ((grouped_expert.grouped_ffn, None), (ref.grouped_ffn_ref, torch.float32)):
        leaves = [t.to(cast or t.dtype).clone().requires_grad_(True) for t in (xs, *ws)]
        f(leaves[0], gs, *leaves[1:]).backward(cot)
        grads.append([t.grad for t in leaves])
    tol = TOL["float32"] + (BF16_ROUND if dtype == "bfloat16" else 0.0)
    for got, want in zip(*grads):
        assert got.dtype == DTYPES[dtype]
        _close(got, want, dtype, {dtype: tol})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,sizes", GROUPED_EDGES)
def test_grouped_ffn_kernel_edge_cases(n, sizes, dtype):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(7)
    xs, gs, ws = _grouped_inputs(gen, n, 64, 32, 4, dtype, dev, sizes)
    got = grouped_expert.grouped_ffn(xs, gs, *ws)
    _close(got, ref.grouped_ffn_ref(xs, gs, *ws), dtype, GROUPED_TOL)
    assert not got[sum(sizes):].any()  # rows past the total


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_ffn_kernel_is_cohort_independent(dtype):
    """Rows of a 1,029-row cohort alone in a 40-row cohort: each row's
    output has the same bits."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(8)
    e = 32
    xs, gs, ws = _grouped_inputs(gen, 32 * e + 5, 1024, 512, e, dtype, dev)
    full = grouped_expert.grouped_ffn(xs, gs, *ws)
    rows = torch.sort(torch.randperm(xs.shape[0], generator=gen, device=dev)[:40]).values
    eid = ref.expert_ids_of(gs, xs.shape[0])[rows].long()
    sub = torch.zeros(e, dtype=torch.int32, device=dev).scatter_add_(
        0, eid, torch.ones_like(eid, dtype=torch.int32))
    alone = grouped_expert.grouped_ffn(xs[rows].contiguous(), sub, *ws)
    torch.cuda.synchronize()
    assert torch.equal(alone, full[rows])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_ffn_cohort_bits_across_n(dtype):
    """granite-moe-1b-a400m's widths: 8 rows of an 8,192-row cohort, each
    in every cohort of N 8, 64 and 512 drawn around it, give the same bits
    in all four."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(21)
    e, n = 32, 8192
    xs, gs, ws = _grouped_inputs(gen, n, 1024, 512, e, dtype, dev)
    eid = ref.expert_ids_of(gs, n).long()
    full = grouped_expert.grouped_ffn(xs, gs, *ws)
    keep = torch.randperm(n, generator=gen, device=dev)[:8]
    for size in (8, 64, 512):
        others = torch.randperm(n, generator=gen, device=dev)[:size]
        others = others[~torch.isin(others, keep)][:size - 8]
        rows = torch.sort(torch.cat([keep, others])).values  # still expert-sorted
        sub = torch.zeros(e, dtype=torch.int32, device=dev).scatter_add_(
            0, eid[rows], torch.ones_like(rows, dtype=torch.int32))
        alone = grouped_expert.grouped_ffn(xs[rows].contiguous(), sub, *ws)
        torch.cuda.synchronize()
        assert rows.numel() == size
        assert torch.equal(alone, full[rows]), size


@pytest.mark.cuda
def test_fp32_grouped_ffn_keeps_the_fma_body():
    """fp32 inputs still run the fp32-FMA body: granite's widths at a decode
    and a prefill cohort held to the fp32 tolerance."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(22)
    for n in (64, 1029):
        xs, gs, ws = _grouped_inputs(gen, n, 1024, 512, 32, "float32", dev)
        _close(grouped_expert.grouped_ffn(xs, gs, *ws), ref.grouped_ffn_ref(xs, gs, *ws),
               "float32", GROUPED_TOL)


@pytest.mark.cuda
def test_grouped_ffn_wrapper_rejects_what_the_kernel_does_not_take():
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(9)
    xs, gs, ws = _grouped_inputs(gen, 16, 64, 32, 4, "float32", dev, [4, 4, 4, 4])
    grouped = grouped_expert.grouped_ffn
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        ops.grouped_ffn(xs.cpu(), gs.cpu(), *(w.cpu() for w in ws))
    with pytest.raises(TypeError, match="dtypes"):
        grouped(xs.to(torch.bfloat16), gs, *ws)
    with pytest.raises(TypeError, match="int32"):
        grouped(xs, gs.long(), *ws)
    with pytest.raises(ValueError, match="unsupported"):
        grouped(xs, gs, ws[0], ws[1], ws[0])  # w_out (E, D, F)
    with pytest.raises(ValueError, match="unsupported"):  # D not a multiple of 8
        grouped(xs[:, :60].contiguous(), gs, *(w[:, :60].contiguous() for w in ws[:2]),
                ws[2][:, :, :60].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        grouped(xs, gs, ws[0].transpose(1, 2).contiguous().transpose(1, 2), *ws[1:])
    with pytest.raises(ValueError, match="act"):
        grouped(xs, gs, *ws, act="gelu")


# ---------------------------------------------------------------- SSD scan

# (B, S, H, chunk) at mamba2-1.3b's P = 64, N = 128 (the widths the kernel
# is built for): ragged B and H, S not a multiple of 32 (the kernel's 64-row
# pieces end mid-chunk; S = 8 fills an eighth of one), 1 to 4 chunks, and
# the model's H = 64
SSD_P, SSD_N = 64, 128
SSD_GRID = [
    (1, 8, 1, 8),
    (1, 24, 3, 24),
    (3, 72, 5, 24),
    (2, 200, 7, 50),
    (1, 136, 2, 34),
    (2, 256, 64, 128),
]


def _ssd_inputs(gen, b, s, h, dtype, dev, p=SSD_P, n=SSD_N):
    x = _randn(gen, (b, s, h, p), dtype, dev)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=dev))
    a_log = torch.randn((h,), generator=gen, device=dev) * 0.5
    bm, cm = (_randn(gen, (b, s, n), dtype, dev) for _ in range(2))
    d = torch.randn((h,), generator=gen, device=dev)
    return x, dt, a_log, bm, cm, d


def _ssd_f64(x, dt, a_log, bm, cm, d):
    """The SSD recurrence one step at a time in float64: (y, final state)."""
    x, dt, a_log, bm, cm, d = (t.double() for t in (x, dt, a_log, bm, cm, d))
    b, s, h, p = x.shape
    state = torch.zeros((b, h, p, bm.shape[-1]), dtype=torch.float64, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * -torch.exp(a_log))[..., None, None]
        state = state * decay + torch.einsum("bhp,bn->bhpn", x[:, t] * dt[:, t, :, None],
                                             bm[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", state, cm[:, t]) + d[:, None] * x[:, t])
    return torch.stack(ys, dim=1), state


def _scaled_err(got, want):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    got, want = got.double(), want.double()
    return ((got - want).abs() / (1 + want.abs())).max().item()


def _check_ssd(args, chunk, dtype):
    """The kernel and the plain version (in fp32, on the same values) against
    the float64 recurrence: the kernel within twice the larger of
    SSD_F64_TOL and the plain version's own error, plus in bf16 the one
    rounding of y (BF16_ROUND of |y|)."""
    y, st = ssd_scan.ssd_scan(*args, chunk=chunk, return_state=True)
    assert y.dtype == DTYPES[dtype] and st.dtype == torch.float32
    want_y, want_st = ref.ssd_ref(*(t.float() for t in args), chunk=chunk, return_state=True)
    true_y, true_st = _ssd_f64(*args)
    for got, plain, truth, rounding in ((y, want_y, true_y, dtype == "bfloat16"),
                                        (st, want_st, true_st, False)):
        bound = 2 * max(SSD_F64_TOL, _scaled_err(plain, truth))
        assert _scaled_err(got, truth) <= bound + (BF16_ROUND if rounding else 0.0)
    assert torch.equal(ssd_scan.ssd_scan(*args, chunk=chunk), y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,chunk", SSD_GRID)
def test_ssd_scan_kernel_matches_plain(b, s, h, chunk, dtype):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(6)
    _check_ssd(_ssd_inputs(gen, b, s, h, dtype, dev), chunk, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_kernel_decays_hard_without_nan(dtype):
    """A in [-16, -1] and dt up to ~9: segment sums reach -5000, where
    exp above the diagonal would overflow; both bodies evaluate exp only on
    and below it (the bf16 body over two 128-row pieces)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(7)
    s = 128 if dtype == "float32" else 256
    x, dt, _, bm, cm, d = _ssd_inputs(gen, 2, s, 4, dtype, dev)
    a_log = torch.log(torch.tensor([1.0, 4.0, 9.0, 16.0], device=dev))
    _check_ssd((x, dt * 3, a_log, bm, cm, d), 128, dtype)


FP32_SCAN_TOL = 1e-4  # chip_smoke.py's limit on the SSD state (and fp32 y) vs the plain version


def _ssd_model_inputs(gen, b, s, h, dtype, dev):
    """ssd_scan's inputs with mamba2-1.3b's layer distributions, as
    chip_smoke.py draws them: dt log-uniform in [1e-3, 1e-1], A in [-16,
    -1], D in [0.5, 1.5]."""
    x = _randn(gen, (b, s, h, SSD_P), dtype, dev)
    dt = torch.exp(torch.rand((b, s, h), generator=gen, device=dev) * math.log(100.0)
                   + math.log(1e-3))
    a_log = torch.rand((h,), generator=gen, device=dev) * math.log(16.0)
    bm, cm = (_randn(gen, (b, s, SSD_N), dtype, dev) for _ in range(2))
    d = torch.rand((h,), generator=gen, device=dev) + 0.5
    return x, dt, a_log, bm, cm, d


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_bits_across_p_splits_and_batch(dtype):
    """y and the state bit for bit across p_splits 1, 2 and 4 (bf16), and
    for one row alone against the same row in a batch of 8 (on 132 SMs the
    two take different p_splits), at mamba2-1.3b's 64 heads and a ragged
    last piece."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(23)
    args = _ssd_model_inputs(gen, 8, 200, 64, dtype, dev)
    y, st = ssd_scan.ssd_scan(*args, chunk=8, return_state=True)
    if dtype == "bfloat16":
        for p_splits in ssd_scan.P_SPLITS:
            ys, sts = ssd_scan.ssd_scan(*args, chunk=8, return_state=True, p_splits=p_splits)
            torch.cuda.synchronize()
            assert torch.equal(ys, y) and torch.equal(sts, st), p_splits
    for row in (0, 5):
        alone = tuple(a[row:row + 1].contiguous() if a.dim() > 1 else a for a in args)
        ya, sta = ssd_scan.ssd_scan(*alone, chunk=8, return_state=True)
        torch.cuda.synchronize()
        assert torch.equal(ya, y[row:row + 1]) and torch.equal(sta, st[row:row + 1]), row


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,chunk", SSD_GRID)
def test_bf16_ssd_scan_holds_the_fp32_state_tolerance(b, s, h, chunk):
    """bf16 inputs at the model's distributions: y within the float64 bound
    of _check_ssd, and the state within FP32_SCAN_TOL of the plain version
    in fp32 on the same values (the state never rounds to bf16: M, the
    state and X w enter the tensor-core products as two bf16 terms)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(24)
    args = _ssd_model_inputs(gen, b, s, h, "bfloat16", dev)
    _check_ssd(args, chunk, "bfloat16")
    _, st = ssd_scan.ssd_scan(*args, chunk=chunk, return_state=True)
    _, want = ref.ssd_ref(*(t.float() for t in args), chunk=chunk, return_state=True)
    assert _scaled_err(st, want) <= FP32_SCAN_TOL


@pytest.mark.cuda
def test_fp32_ssd_scan_keeps_the_fma_body():
    """fp32 inputs still run the fp32-FMA body: fp32 x, B and C (which bf16
    cannot hold) at the model's widths, y and the state within
    FP32_SCAN_TOL of the plain version; a bf16 product of them would be
    ~1e-2 off."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(25)
    args = _ssd_model_inputs(gen, 2, 384, 64, "float32", dev)
    y, st = ssd_scan.ssd_scan(*args, chunk=128, return_state=True)
    want_y, want_st = ref.ssd_ref(*args, chunk=128, return_state=True)
    assert _scaled_err(y, want_y) <= FP32_SCAN_TOL
    assert _scaled_err(st, want_st) <= FP32_SCAN_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [8, 16, 24, 128])
def test_paged_flash_decode_bits_equal_flash_decode_on_the_gathered_cache(bs, dtype):
    """qwen2-0.5b's heads over a shuffled pool of 1,152-slot tables, the
    table past each live prefix pointed at block 0 poisoned with +-1e4, a
    row of length 0 (which averages every slot, block 0's too) and a full
    row: the paged kernel gives flash_decode's bits on the gathered cache
    (bf16: the same split grid, the same splits; fp32: the same FMA walk).
    bs 24 does not divide the 64-key tile, bs 128 spans two."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(26)
    hq, hkv, d, m = 14, 2, 64, 1152 // bs
    lens = torch.tensor([0, 1, bs + 3, 65, 700, m * bs], dtype=torch.int32, device=dev)
    b, n = lens.numel(), 1 + lens.numel() * m
    q = _randn(gen, (b, hq, d), dtype, dev)
    kp, vp = (_randn(gen, (n, bs, hkv, d), dtype, dev) for _ in range(2))
    kp[0], vp[0] = 1e4, -1e4
    table = (torch.randperm(n - 1, generator=gen, device=dev) + 1).reshape(b, m)
    live = torch.arange(m, device=dev)[None] < (lens[:, None] + bs - 1) // bs
    table = torch.where(live, table, 0).int()
    got = paged_decode_attention.paged_flash_decode(q, kp, vp, table, cache_len=lens)
    gathered = [p[table.long()].reshape(b, m * bs, hkv, d) for p in (kp, vp)]
    want = decode_attention.flash_decode(q, *gathered, cache_len=lens)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_fp32_paged_decode_keeps_the_fma_body():
    """fp32 inputs still run the fp32-FMA paged body: qwen2-0.5b's decode
    shape (8 rows, blocks of 16, 36-block tables) held to the fp32
    tolerance, which no bf16 or TF32 product would meet."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(27)
    b, hq, hkv, d, bs, m = 8, 14, 2, 64, 16, 36
    n = 1 + b * m
    q = _randn(gen, (b, hq, d), "float32", dev)
    kp, vp = (_randn(gen, (n, bs, hkv, d), "float32", dev) for _ in range(2))
    table = (torch.randperm(n - 1, generator=gen, device=dev) + 1).reshape(b, m).int()
    lens = torch.tensor([0, 1, 17, 64, 100, 333, 500, m * bs], dtype=torch.int32, device=dev)
    _close(paged_decode_attention.paged_flash_decode(q, kp, vp, table, cache_len=lens),
           ref.paged_decode_mha_ref(q, kp, vp, table, cache_len=lens), "float32")


# ------------------------------------------------------------- RG-LRU scan

# W = 7 leaves most of a block's threads without a channel and takes the
# plain-load path (W not a multiple of a 16-byte vector); S = 1 is one step
# of one chunk; S = 65 is one step past the two 32-step chunks rglru_chunks
# picks there, S = 257 one step past four 64-step chunks; W 1000 is not a
# multiple of the 128-channel tile; S 4096 at B 1 walks 16 windows of a
# cluster
RGLRU_GRID = [(2, 5, 7), (1, 17, 32), (3, 33, 96), (2, 100, 200), (4, 512, 4096),
              (1, 1, 4096), (2, 65, 4096), (1, 257, 4096), (3, 77, 1000), (1, 4096, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,w", RGLRU_GRID)
def test_rglru_scan_kernel_matches_plain(b, s, w, dtype):
    """Against the plain version in fp32 on the same values: in bf16 h
    rounds once, BF16_ROUND of |h| more."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(8)
    a = torch.rand((b, s, w), generator=gen, device=dev).to(DTYPES[dtype])
    bx = _randn(gen, (b, s, w), dtype, dev)
    h, final = rglru_scan.rglru_scan(a, bx)
    want_h, want_final = ref.rglru_scan_ref(a.float(), bx.float())
    assert h.dtype == DTYPES[dtype] and final.dtype == torch.float32
    rounding = BF16_ROUND if dtype == "bfloat16" else 0.0
    assert _scaled_err(h, want_h) <= TOL["float32"] + rounding
    _close(final, want_final, "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 8, 16, 64])
@pytest.mark.parametrize("windows", [1, 3])
def test_rglru_scan_kernel_at_each_chunk(chunk, windows):
    """An explicit chunk length, with S one step past a whole chunk (the
    last chunk holds one step) in the first or the third window of a
    cluster, held like the default; chunk 1 makes blocks of one step."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(28)
    s = (windows - 1) * rglru_scan.CLUSTER * chunk + chunk + 1
    a = torch.rand((2, s, 1000), generator=gen, device=dev)
    bx = _randn(gen, (2, s, 1000), "float32", dev)
    h, final = rglru_scan.rglru_scan(a, bx, chunk=chunk)
    want_h, want_final = ref.rglru_scan_ref(a, bx)
    _close(h, want_h, "float32")
    _close(final, want_final, "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,w", [(4, 512, 4096), (1, 4096, 4096), (2, 65, 1000)])
def test_rglru_scan_two_launches_are_bit_equal(b, s, w, dtype):
    """The chunk carries compose in one fixed order, so the bits do not
    depend on how the blocks were scheduled."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(29)
    a = torch.rand((b, s, w), generator=gen, device=dev).to(DTYPES[dtype])
    bx = _randn(gen, (b, s, w), dtype, dev)
    h1, f1 = rglru_scan.rglru_scan(a, bx)
    h2, f2 = rglru_scan.rglru_scan(a, bx)
    assert torch.equal(h1, h2) and torch.equal(f1, f2)


# ------------------------------------------ attention at recurrentgemma's D

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,window", [(2, 300, 128), (1, 130, None)])
def test_flash_mha_kernel_at_head_dim_256(b, s, window, dtype):
    """recurrentgemma-9b's attention: 16 query heads on one KV head, D 256."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(9)
    q = _randn(gen, (b, s, 16, 256), dtype, dev)
    k, v = (_randn(gen, (b, s, 1, 256), dtype, dev) for _ in range(2))
    _close(flash_attention.flash_mha(q, k, v, causal=True, window=window),
           ref.mha_ref(q, k, v, causal=True, window=window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,window", [(100, 230, None), (200, 150, 100), (77, 77, 2048)])
def test_flash_mha_bf16_at_head_dim_256_ragged(sq, skv, window):
    """The bf16 tile body at D 256, G 16, with Sq != Skv and lengths off the
    64-row tile (every row keeps a valid key, so the tile skip and the
    plain version agree), on the skipping and the position paths."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(17)
    b = 2
    q = _randn(gen, (b, sq, 16, 256), "bfloat16", dev)
    k, v = (_randn(gen, (b, skv, 1, 256), "bfloat16", dev) for _ in range(2))
    want = ref.mha_ref(q, k, v, causal=True, window=window)
    _close(flash_attention.flash_mha(q, k, v, causal=True, window=window), want, "bfloat16")
    qp, kp = torch.arange(sq, device=dev)[None], torch.arange(skv, device=dev)[None]
    _close(flash_attention.flash_mha(q, k, v, causal=True, window=window, q_positions=qp,
                                     kv_positions=kp), want, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("d,hq,hkv", [(64, 14, 2), (256, 16, 1)])
def test_fp32_attention_keeps_the_fma_body(d, hq, hkv):
    """fp32 inputs still run the fp32-FMA bodies: flash_mha and
    flash_mha_varlen at the main path's widths held to the fp32 tolerance,
    which no bf16 or TF32 product would meet."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(18)
    b, s = 2, 192
    q = _randn(gen, (b, s, hq, d), "float32", dev)
    k, v = (_randn(gen, (b, s, hkv, d), "float32", dev) for _ in range(2))
    for window in (None, 100):
        want = ref.mha_ref(q, k, v, causal=True, window=window)
        _close(flash_attention.flash_mha(q, k, v, causal=True, window=window), want, "float32")
        cu = torch.tensor([0, 70, 192, 384], dtype=torch.int32, device=dev)
        qv, kv, vv = (x.reshape(b * s, *x.shape[2:]) for x in (q, k, v))
        _close(varlen_attention.flash_mha_varlen(qv, kv, vv, cu, window=window),
               ref.mha_varlen_ref(qv, kv, vv, cu, window=window), "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap,window,lens", [(96, 96, [0, 50, 300]),
                                             (200, None, [200, 17, 1])])
def test_flash_decode_kernel_at_head_dim_256(cap, window, lens, dtype):
    """G = 16 query heads per KV head at D = 256 over a ring (with a row
    of length 0) and a linear cache: two accumulator columns per thread."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(10)
    b = len(lens)
    q = _randn(gen, (b, 16, 256), dtype, dev)
    kc, vc = (_randn(gen, (b, cap, 1, 256), dtype, dev) for _ in range(2))
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    _close(decode_attention.flash_decode(q, kc, vc, cache_len=cl, window=window),
           ref.decode_mha_ref(q, kc, vc, cache_len=cl, window=window), dtype)
    table = torch.arange(1, 1 + b * 4, dtype=torch.int32, device=dev).reshape(b, 4)
    kp, vp = (_randn(gen, (1 + b * 4, 32, 1, 256), dtype, dev) for _ in range(2))
    lens_p = cl.clamp(max=4 * 32)
    _close(paged_decode_attention.paged_flash_decode(q, kp, vp, table, cache_len=lens_p),
           ref.paged_decode_mha_ref(q, kp, vp, table, cache_len=lens_p), dtype)


@pytest.mark.cuda
def test_scan_wrappers_count_launches_and_reject_what_the_kernels_do_not_take():
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(11)
    args = _ssd_inputs(gen, 1, 64, 2, "float32", dev)
    before = ssd_scan.ssd_scan.launches
    ssd_scan.ssd_scan(*args, chunk=32)
    ops.ssd(*args, chunk=32, impl="cuda")
    assert ssd_scan.ssd_scan.launches == before + 2
    ops.ssd(*args, chunk=32, impl="reference")
    assert ssd_scan.ssd_scan.launches == before + 2
    x, dt, a_log, bm, cm, d = args
    with pytest.raises(ValueError, match="init_state"):
        ssd_scan.ssd_scan(*args, chunk=32, init_state=torch.zeros(1, 2, 64, 128, device=dev))
    with pytest.raises(ValueError, match="unsupported"):  # S not a multiple of chunk
        ssd_scan.ssd_scan(*args, chunk=48)
    with pytest.raises(ValueError, match="unsupported"):  # P = 48
        ssd_scan.ssd_scan(torch.zeros(1, 64, 2, 48, device=dev), dt, a_log, bm, cm, d,
                          chunk=32)
    with pytest.raises(ValueError, match="unsupported"):  # N = 64
        ssd_scan.ssd_scan(x, dt, a_log, bm[..., :64].contiguous(), cm[..., :64].contiguous(),
                          d, chunk=32)
    with pytest.raises(TypeError):  # dt in bf16
        ssd_scan.ssd_scan(x, dt.bfloat16(), a_log, bm, cm, d, chunk=32)
    a = torch.rand(2, 9, 32, device=dev)
    before = rglru_scan.rglru_scan.launches
    rglru_scan.rglru_scan(a, a)
    ops.rglru_scan(a, a, impl="cuda")
    assert rglru_scan.rglru_scan.launches == before + 2
    with pytest.raises(ValueError, match="init_state"):
        rglru_scan.rglru_scan(a, a, torch.zeros(2, 32, device=dev))
    with pytest.raises(ValueError, match="unsupported"):
        rglru_scan.rglru_scan(a, a[:, :8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan.rglru_scan(a.transpose(0, 1), a.transpose(0, 1))
    with pytest.raises(TypeError):
        rglru_scan.rglru_scan(a, a.bfloat16())


# packed varlen attention: (sequence lengths, T with a phantom tail past
# their sum, Hq, Hkv, D, causal, window): a length-1 sequence, boundaries
# off the 64-row tile, a phantom tail sharing a tile with the last
# sequence, qwen2-0.5b's heads (G = 7), a window, non-causal, D 16 to 256
VARLEN_GRID = [
    ([1, 70, 3, 200, 64, 1, 100], 448, 14, 2, 64, True, None),
    ([1, 70, 3, 200, 64, 1, 100], 448, 14, 2, 64, True, 50),
    ([130, 1, 61], 200, 4, 2, 16, False, None),
    ([17, 300], 320, 4, 4, 32, True, 128),
    ([5, 64, 64, 1], 134, 8, 1, 128, True, None),
    ([300, 212], 512, 16, 1, 256, True, 2048),
    ([64, 64], 128, 4, 2, 64, True, None),
]


def _varlen_inputs(gen, lens, t, hq, hkv, d, dtype, dev):
    cu = torch.tensor([0] + list(torch.tensor(lens).cumsum(0)), dtype=torch.int32,
                      device=dev)
    q = _randn(gen, (t, hq, d), dtype, dev)
    k, v = (_randn(gen, (t, hkv, d), dtype, dev) for _ in range(2))
    return q, k, v, cu


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lens,t,hq,hkv,d,causal,window", VARLEN_GRID)
def test_flash_mha_varlen_kernel_matches_plain(lens, t, hq, hkv, d, causal, window, dtype):
    """Every row, phantoms included, against the plain version (unbanded,
    and banded by the longest segment where that is exact)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(12)
    q, k, v, cu = _varlen_inputs(gen, lens, t, hq, hkv, d, dtype, dev)
    got = varlen_attention.flash_mha_varlen(q, k, v, cu, causal=causal, window=window)
    _close(got, ref.mha_varlen_ref(q, k, v, cu, causal=causal, window=window), dtype)
    band = max(max(lens), t - sum(lens))
    _close(got, ref.mha_varlen_ref(q, k, v, cu, causal=causal, window=window,
                                   max_seqlen=band), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_mha_varlen_equal_segments_equal_flash_mha(dtype):
    """B equal segments of S (a multiple of the 64-row tile) walk the same
    tiles in the same order as flash_mha on the (B, S) layout: the same
    bits."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(13)
    b, s, hq, hkv, d = 3, 192, 14, 2, 64
    q, k, v, cu = _varlen_inputs(gen, [s] * b, b * s, hq, hkv, d, dtype, dev)
    for window in (None, 100):
        got = varlen_attention.flash_mha_varlen(q, k, v, cu, window=window)
        want = flash_attention.flash_mha(q.view(b, s, hq, d), k.view(b, s, hkv, d),
                                         v.view(b, s, hkv, d), causal=True, window=window)
        torch.cuda.synchronize()
        diff = (got.view(b, s, hq, d).float() - want.float()).abs().max().item()
        assert diff == 0.0, (window, diff)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_mha_varlen_has_no_cross_sequence_leakage(dtype):
    """Perturb one sequence's q, k and v: every other row, phantoms
    included, keeps its bits."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(14)
    lens = [5, 90, 1, 40]
    q, k, v, cu = _varlen_inputs(gen, lens, 192, 14, 2, 64, dtype, dev)
    base = varlen_attention.flash_mha_varlen(q, k, v, cu)
    sl = slice(5, 95)
    q2, k2, v2 = q.clone(), k.clone(), v.clone()
    q2[sl] += 3.0
    k2[sl] -= 2.0
    v2[sl] *= 5.0
    pert = varlen_attention.flash_mha_varlen(q2, k2, v2, cu)
    torch.cuda.synchronize()
    keep = torch.ones(192, dtype=torch.bool, device=dev)
    keep[sl] = False
    assert torch.equal(base[keep], pert[keep])
    assert not torch.equal(base[sl], pert[sl])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_mha_varlen_gradients(dtype):
    """The Function's dq, dk, dv against autograd of the plain version on
    the same inputs (its backward is that autograd), and the forward's
    launch count."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(15)
    lens = [1, 70, 3, 100]
    q, k, v, cu = _varlen_inputs(gen, lens, 192, 14, 2, 64, dtype, dev)
    w = _randn(gen, (192, 14, 64), dtype, dev)
    grads = []
    for fn in (varlen_attention.flash_mha_varlen, ref.mha_varlen_ref):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        before = varlen_attention.flash_mha_varlen.launches
        out = fn(*leaves, cu, max_seqlen=100)
        assert out.requires_grad
        (out.float() * w.float()).sum().backward()
        if fn is varlen_attention.flash_mha_varlen:
            assert varlen_attention.flash_mha_varlen.launches == before + 1
        grads.append([x.grad for x in leaves])
    for got, want in zip(*grads):
        _close(got, want, "float32")


@pytest.mark.cuda
def test_kernels_without_backward_raise_under_grad():
    """Each wrapper with no backward (the two decode kernels, which run only
    in generation and serving) raises NotImplementedError when an input
    requires grad under grad mode, and runs under torch.no_grad()."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(16)
    x = _randn(gen, (1, 64, 4, 64), "float32", dev)
    cl = torch.tensor([64], dtype=torch.int32, device=dev)
    table = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32, device=dev)
    pool = _randn(gen, (5, 16, 4, 64), "float32", dev)
    calls = {
        "flash_decode": (decode_attention.flash_decode, lambda g: (g(x[:, 0]), x, x),
                         dict(cache_len=cl)),
        "paged_flash_decode": (paged_decode_attention.paged_flash_decode,
                               lambda g: (g(x[:, 0]), pool, pool, table), dict(cache_len=cl)),
    }
    for name, (fn, args, kw) in calls.items():
        before = fn.launches
        with pytest.raises(NotImplementedError, match=f"{name}: the CUDA kernel has no backward"):
            fn(*args(lambda t: t.clone().requires_grad_(True)), **kw)
        assert fn.launches == before
        with torch.no_grad():
            fn(*args(lambda t: t.clone().requires_grad_(True)), **kw)
        fn(*args(lambda t: t), **kw)  # nothing requires grad
        assert fn.launches == before + 2, name


@pytest.mark.cuda
def test_varlen_wrapper_rejects_what_the_kernel_does_not_take():
    dev = _card()
    q = torch.zeros(70, 4, 64, device=dev)
    cu = torch.tensor([0, 30, 70], dtype=torch.int32, device=dev)
    fn = varlen_attention.flash_mha_varlen
    with pytest.raises(TypeError, match="int32"):
        fn(q, q, q, cu.long())
    with pytest.raises(TypeError):
        fn(q.half(), q.half(), q.half(), cu)
    with pytest.raises(ValueError, match="unsupported"):
        fn(q[..., :48].contiguous(), q[..., :48].contiguous(), q[..., :48].contiguous(), cu)
    with pytest.raises(ValueError, match="contiguous"):
        fn(q, q.transpose(0, 1).contiguous().transpose(0, 1), q, cu)
    with pytest.raises(ValueError, match="one CUDA device"):
        fn(q, q, q, cu.cpu())
    shifted = torch.zeros(q.numel() + 1, device=dev)[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        fn(q, shifted, q, cu)
    before = fn.launches
    ops.varlen_mha(q, q, q, cu, impl="cuda")
    ops.varlen_mha(q, q, q, cu, impl="reference")
    assert fn.launches == before + 1


# ---------------------------------------------------------------- gradients

def _function_case(name, gen, dev):
    """(wrapper, its plain version, differentiable inputs, other args,
    keywords) of a kernel that is an autograd.Function, in fp32 at shapes
    its kernel takes."""
    if name == "flash_mha":
        q = _randn(gen, (2, 96, 14, 64), "float32", dev)
        k, v = (_randn(gen, (2, 96, 2, 64), "float32", dev) for _ in range(2))
        return flash_attention.flash_mha, ref.mha_ref, [q, k, v], [], dict(window=40)
    if name == "grouped_ffn":
        xs, gs, ws = _grouped_inputs(gen, 40, 64, 32, 4, "float32", dev, sizes=[10, 0, 25, 3])
        return (grouped_expert.grouped_ffn, ref.grouped_ffn_ref, [xs, *ws], [gs], {})
    if name == "ssd_scan":
        x, dt, a_log, bm, cm, d = _ssd_inputs(gen, 2, 128, 2, "float32", dev)
        return (ssd_scan.ssd_scan, ref.ssd_ref, [x, dt, a_log, bm, cm, d], [],
                dict(chunk=64, return_state=True))
    a = torch.rand((2, 77, 64), generator=gen, device=dev) * 0.5 + 0.5
    bx = _randn(gen, (2, 77, 64), "float32", dev)
    return rglru_scan.rglru_scan, ref.rglru_scan_ref, [a, bx], [], {}


def _call(fn, diff, other, kw):
    """fn on (diff, other) in the order the wrapper takes them."""
    if fn in (grouped_expert.grouped_ffn, ref.grouped_ffn_ref):
        return fn(diff[0], other[0], *diff[1:], **kw)
    return fn(*diff, *other, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_mha", "grouped_ffn", "ssd_scan", "rglru_scan"])
def test_functions_launch_once_and_give_the_plain_gradient(name):
    """Under grad, each differentiable wrapper launches its kernel once (the
    backward launches nothing) and gives the gradient of its plain version
    on the same inputs and the same cotangents; rows past sum(group_sizes)
    and an empty expert get zero gradients."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(21)
    fn, plain, diff, other, kw = _function_case(name, gen, dev)
    grads, cots = [], None
    for f in (fn, plain):
        leaves = [t.clone().requires_grad_(True) for t in diff]
        before = fn.launches
        out = _call(f, leaves, other, kw)
        out = out if isinstance(out, tuple) else (out,)
        if cots is None:
            cots = [_randn(gen, o.shape, "float32", dev) for o in out]
        torch.autograd.backward(out, cots)
        assert fn.launches == before + (f is fn), name
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        _close(got, want, "float32")
    if name == "grouped_ffn":
        dx, dwg, dwi, dwo = grads[0]
        assert bool((dx[38:] == 0).all())
        assert all(bool((w[1] == 0).all()) for w in (dwg, dwi, dwo))


def _train_case(arch, packed, dev):
    """A reduced ``arch`` (fp32; mamba2 at the SSD kernel's P 64, N 128) with
    seeded weights on the card, and one minibatch of the actor's train
    batch: 4 sequences of 8 prompt and 8 generated tokens, ragged valid
    lengths."""
    from repro_torch.configs import get_config
    from repro_torch.data import packing
    from repro_torch.models import model as MDL
    over = dict(ssm_head_dim=64, ssm_state=128) if arch == "mamba2-1.3b" else {}
    cfg = get_config(arch).reduced(**over)
    params = MDL.init_params(cfg, seed=3, device=dev)
    with torch.no_grad():
        params["embed"]["table"].mul_(0.05)
    gen = torch.Generator(device=dev).manual_seed(22)
    b, p, g = 4, 8, 8
    toks = torch.randint(1, cfg.vocab_size, (b, p + g), generator=gen, device=dev)
    valid = torch.tensor([3, 8, 1, 5], device=dev)
    mask = (torch.arange(g, device=dev)[None] < valid[:, None]).float()
    logp = -torch.rand((b, g), generator=gen, device=dev) * mask
    adv = torch.randn((b, g), generator=gen, device=dev) * mask
    if not packed:
        return cfg, params, {"tokens": toks, "logp": logp, "adv": adv, "mask": mask}
    lens = (p + torch.clamp(valid + 1, max=g)).tolist()
    full = {k: torch.nn.functional.pad(v, (p, 0)) for k, v in
            (("logp", logp), ("adv", adv), ("mask", mask))}
    mb = packing.pack_minibatches(toks, full, lens, 1, max_seqlen=p + g)
    return cfg, params, {k: v[0] for k, v in mb.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch,packed", [("granite-moe-1b-a400m", True),
                                         ("mamba2-1.3b", False)])
def test_small_train_step_on_the_card_equals_the_reference(arch, packed):
    """The actor's loss and gradients on one minibatch in fp32: packed MoE
    (flash_mha_varlen and grouped_ffn under grad) and padded mamba2
    (ssd_scan under grad), the kernels against the reference tier."""
    from repro_torch.optim import adamw
    from repro_torch.rlhf import ppo as PPO
    dev = _card()
    cfg, params, mb = _train_case(arch, packed, dev)
    hp = PPO.PPOHyperparameters()
    out = {}
    for impl in ("cuda", "reference"):
        if packed:
            out[impl] = PPO.packed_actor_grads(params, cfg, hp, mb, impl=impl, max_seqlen=16)
        else:
            out[impl] = PPO.actor_grads(params, cfg, hp, mb, 8, impl=impl)
    (lc, sc, gc), (lr, sr, gr) = out["cuda"], out["reference"]
    assert abs(lc.item() - lr.item()) <= 1e-5 * (1 + abs(lr.item()))
    for k in sr:
        assert abs(sc[k].item() - sr[k].item()) <= 1e-5 * (1 + abs(sr[k].item())), k
    norm = adamw.global_norm(gr).item()
    assert norm > 0
    assert adamw.global_norm([a - b for a, b in zip(gc, gr)]).item() <= 1e-4 * norm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kk", [2, 5, 9])
def test_paged_verify_runs_flash_mha_at_explicit_positions(kk, dtype):
    """The speculative verify's attention: Sq = k + 1 queries per row at
    explicit positions over the table-gathered pool (a shuffled table, one
    row whose window ends on the last slot), through ``ops.paged_verify_mha``
    on the kernel tier against ``ref.paged_verify_mha_ref``; it launches
    flash_mha once."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(kk)
    b, hq, hkv, d, bs, m = 4, 14, 2, 64, 16, 6
    n = 1 + b * m
    q = _randn(gen, (b, kk, hq, d), dtype, dev)
    k_pool, v_pool = (_randn(gen, (n, bs, hkv, d), dtype, dev) for _ in range(2))
    tbl = (torch.randperm(n - 1, generator=gen, device=dev) + 1).reshape(b, m).to(torch.int32)
    starts = torch.tensor([0, 17, 40, m * bs - kk], device=dev)
    qpos = (starts[:, None] + torch.arange(kk, device=dev)[None]).to(torch.int32)
    before = flash_attention.flash_mha.launches
    got = ops.paged_verify_mha(q, k_pool, v_pool, tbl, q_positions=qpos, impl="cuda")
    assert flash_attention.flash_mha.launches == before + 1
    _close(got, ref.paged_verify_mha_ref(q, k_pool, v_pool, tbl, q_positions=qpos), dtype)


@pytest.mark.cuda
def test_spec_cycle_on_the_card_equals_the_reference():
    """A few speculative cycles on a 2-layer reduced qwen2-0.5b in fp32 (the
    draft: the target plus seeded noise), greedy, on both tiers: the same
    tokens and spec stats, logprobs within 1e-4; the kernel tier launched
    flash_mha in every verify and paged_flash_decode in every draft step."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as MDL
    from repro_torch.models import spec as SPEC
    dev = _card()
    cfg = get_config("qwen2-0.5b").reduced()
    params = MDL.init_params(cfg, seed=3, device=dev)
    draft = MDL.init_params(cfg, seed=3, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    with torch.no_grad():
        for p in (params, draft):
            p["embed"]["table"].mul_(0.05)
        for layer in draft["layers"]:
            w = layer["mixer"]["wq"]["w"]
            w.add_(0.02 * torch.randn(w.shape, generator=gen, device=dev))
    prompts = torch.randint(1, cfg.vocab_size, (3, 9), generator=gen, device=dev)
    out = {}
    for impl in ("cuda", "reference"):
        mha0 = flash_attention.flash_mha.launches
        dec0 = paged_decode_attention.paged_flash_decode.launches
        out[impl] = SPEC.spec_generate(params, cfg, draft, cfg, {"tokens": prompts},
                                       num_new_tokens=12, spec_k=3, impl=impl, block_size=8)
        launched = (flash_attention.flash_mha.launches - mha0,
                    paged_decode_attention.paged_flash_decode.launches - dec0)
        if impl == "cuda":
            st = out[impl]["stats"]
            assert launched == (2 * (2 + st["cycles"]), 2 * 4 * st["cycles"])
        else:
            assert launched == (0, 0)
    assert torch.equal(out["cuda"]["tokens"], out["reference"]["tokens"])
    assert out["cuda"]["stats"] == out["reference"]["stats"]
    assert (out["cuda"]["logprobs"] - out["reference"]["logprobs"]).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_reshard_on_the_card_donates_clones_and_polls():
    """``parallel/realloc_exec`` on one card, four logical devices: the
    clone keeps its source valid; the donating move releases the source
    blocks (the memory allocated drops by the source's blocks and grows by
    the destination's), leaves values bit-equal, and ``done()`` may be
    polled before ``wait()``; a move onto other logical ids copies too."""
    from repro_torch.parallel import realloc_exec as RX
    from repro_torch.parallel.layout import Layout, Mesh, P, ShardedTensor
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _randn(gen, (1024, 2048), "bfloat16", dev)
    mesh = Mesh([[0, 1], [2, 3]], ("data", "model"))
    assert all(b.device.type == "cuda" for b in ShardedTensor.place(
        x, Layout(mesh, P())).blocks.values())
    t = ShardedTensor.place(x, Layout(mesh, P("data", None)))
    clone = RX.clone_reshard({"w": t}, {"w": Layout(mesh, P(None, "model"))})["w"]
    assert not t.donated and torch.equal(t.gather(), x) and torch.equal(clone.gather(), x)
    del clone
    torch.cuda.synchronize()
    src_bytes = t.local_bytes()
    mem0 = torch.cuda.memory_allocated()
    task = RX.prefetch_reshard({"w": t}, {"w": Layout(mesh, P("model", "data"))})
    assert isinstance(task.done(), bool)  # polled before wait
    out = task.wait()["w"]
    assert task.done() and task.elapsed_s >= 0 and task.n_moved == 1
    assert t.donated and out.local_bytes() == x.numel() * 2 and src_bytes == 2 * x.numel() * 2
    assert torch.cuda.memory_allocated() - mem0 == out.local_bytes() - src_bytes
    assert torch.equal(out.gather(), x)
    other = Mesh([[4, 5], [6, 7]], ("data", "model"))
    far = RX.reshard({"w": out}, {"w": Layout(other, P("model", "data"))})["w"]
    assert far.layout.device_set == {4, 5, 6, 7} and torch.equal(far.gather(), x)


def _sharded(params, shape):
    """``params`` placed on a (data, model) mesh of logical devices of the
    card by ``ShardingRules()``, sanitized."""
    import numpy as np

    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.layout import Layout, Mesh, place_tree, tree_map
    mesh = Mesh(np.arange(shape[0] * shape[1]).reshape(shape), ("data", "model"))
    specs = SH.sanitize_specs(SH.param_specs(params, SH.ShardingRules()), params, mesh)
    return mesh, place_tree(params, tree_map(lambda s: Layout(mesh, s), specs))


@pytest.mark.cuda
def test_sharded_train_step_on_logical_devices_of_the_card():
    """Reduced qwen2-0.5b in fp32 on a (2, 2) mesh of the card: the sharded
    step (flash_mha per rank, forward and remat) against the single-device
    step on the card: loss, grad norm and first moment within 1e-5,
    replicas bit-equal."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as MDL
    from repro_torch.optim import adamw
    from repro_torch.parallel import steps
    from repro_torch.parallel.layout import tree_leaves, tree_map
    dev = _card()
    cfg = get_config("qwen2-0.5b").reduced()
    params = MDL.init_params(cfg, seed=0, device=dev)
    batch = MDL.synth_batch(1, cfg, 64, 4, device=dev)
    batch["mask"][0, 20:] = 0.0
    opt = adamw.AdamWConfig(lr=1e-6)
    single = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    _, s1, m1 = steps.make_train_step(cfg, opt)(single, adamw.init(opt, single), batch)
    mesh, sp = _sharded(params, (2, 2))
    flash_attention.flash_mha.launches = 0
    sp, s2, m2 = steps.make_train_step(cfg, opt, mesh=mesh)(sp, adamw.init(opt, sp), batch)
    assert flash_attention.flash_mha.launches == 4 * cfg.num_layers * 2
    for k in ("loss", "grad_norm"):
        assert abs(float(m2[k]) - float(m1[k])) <= 1e-5 * abs(float(m1[k])), k
    for a, b in zip(adamw.leaves(s1["m"]), tree_leaves(s2["m"])):
        assert float((b.gather() - a).abs().max()) <= 1e-5 * float(a.abs().max()) + 1e-30
    for st in tree_leaves(sp):
        first = {}
        assert all(torch.equal(first.setdefault(reg, blk), blk) for _, reg, blk in st.shards)


@pytest.mark.cuda
def test_ep_forward_and_sharded_decode_on_logical_devices_of_the_card():
    """Reduced granite in fp32: the expert-parallel forward on (1, 2)
    (grouped_ffn per rank on its 2 experts) and a sharded prefill and
    decode step on (2, 2) (flash_mha / flash_decode per rank) against the
    single-device runs on the card, within 1e-5 of the largest value."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as MDL
    from repro_torch.parallel import ctx as CTX
    from repro_torch.parallel import steps
    dev = _card()
    cfg = get_config("granite-moe-1b-a400m").reduced()
    params = MDL.init_params(cfg, seed=0, device=dev)
    with torch.no_grad():
        params["embed"]["table"].mul_(0.05)
    toks = MDL.synth_batch(2, cfg, 32, 4, "prefill", device=dev)["tokens"]
    with torch.no_grad():
        want = MDL.forward(params, cfg, {"tokens": toks})
    mesh, sp = _sharded(params, (1, 2))
    grouped_expert.grouped_ffn.launches = 0
    with torch.no_grad(), CTX.use(mesh, ("data",), "model") as c:
        hs = MDL.forward_sharded(sp, cfg, {r: {"tokens": toks} for r in mesh.device_ids}, ctx=c)
    assert grouped_expert.grouped_ffn.launches == 2 * cfg.num_layers
    for h in hs.values():
        assert float((h - want).abs().max()) <= 1e-5 * float(want.abs().max())
    mesh, sp = _sharded(params, (2, 2))
    lg1, c1 = steps.make_prefill_step(cfg, extra_len=2)(params, {"tokens": toks})
    lg2, c2 = steps.make_prefill_step(cfg, extra_len=2, mesh=mesh)(sp, {"tokens": toks})
    decode_attention.flash_decode.launches = 0
    tok = lg1.argmax(-1)
    d1, _ = steps.make_decode_step(cfg)(params, tok, c1, 32)
    d2, _ = steps.make_decode_step(cfg, mesh=mesh)(sp, tok, c2, 32)
    assert decode_attention.flash_decode.launches == (1 + 4) * cfg.num_layers
    for a, b in ((lg1, lg2), (d1, d2)):
        assert float((b.gather() - a).abs().max()) <= 1e-5 * float(a.abs().max())
