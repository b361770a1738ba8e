"""What the port does on an NVIDIA GPU and nowhere else: the flash backward
under error taps runs kernels 2-4 and never their plain versions, an
unpacked 8-bit Adam leaf launches kernel 13 and a packed one kernel 14,
the int8 decode attention's integer-dot and K^T forms launch their kernel,
the flash forward runs every form on the card within its bounds,
and the storage GEMMs, the KIVI decode and the dequant stream launch their
kernels and agree with their plain versions (the w4/w2 GEMM in both its
forms, the decode form at M <= 8 and the wgmma form above it and at w4
group 8, at ragged shapes also bit for bit on the identity's rows, as the
MX8 and posit8 GEMMs in both forms, at every group, block size and es,
with odd N and misaligned codes and scales), the rounding kernel takes
the NormalFloat codebooks and native casts bit for bit and its table form
every format over every bf16 pattern, the packed 8-bit Adam step is
bit-equal at the train step's and BERT's leaf sizes, both decode
kernels take every instantiated GQA group and head dim (and refuse the
rest), and the KIVI decode holds its bounds where its split cuts the
tokens, at empty and full tiers, past 256 K groups, and gives the same
bits from a repeated call; greedy speculative decoding over the KIVI and
int4 caches runs its verify blocks through kernel 5 and never the fused
decode.  Marked
``cuda``: without a card each test skips.  This file imports no JAX, so on
a card's machine without JAX it runs as

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from quantized_training_torch.numerics import quantize_fn
from quantized_training_torch.ops import adam8bit_step
from quantized_training_torch.ops import affine_storage as aff
from quantized_training_torch.ops import flash_attention as fa
from quantized_training_torch.ops import int8_matmul, kivi_attention, \
    mx_storage, posit_storage
from quantized_training_torch.serving import kv_cache as kvc
from quantized_training_torch.training import Adam8bit

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU form")
    return torch.device("cuda")


def test_error_tapped_flash_backward_runs_the_kernels(cuda_device,
                                                      monkeypatch):
    """One forward and backward with p_qfn and err_qfn launches the
    training forward and kernels 2, 3 and 4 once each; the plain versions
    are never called."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on CUDA tensors")
    for name in ("attention_forward_plain", "flash_bwd_di_plain",
                 "flash_bwd_dq_plain", "flash_bwd_dkv_plain"):
        monkeypatch.setattr(fa, name, refuse)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((1, 4, 128, 128), generator=gen,
                           device=cuda_device).bfloat16().requires_grad_(True)
               for _ in range(3))
    p8 = quantize_fn("posit8_1")
    counters = [(fa.flash_attention, "lse_launches"),
                (fa.flash_bwd_di, "launches"), (fa.flash_bwd_dq, "launches"),
                (fa.flash_bwd_dkv, "launches")]
    before = [getattr(fn, attr) for fn, attr in counters]
    out = fa.flash_attention(q, k, v, p_qfn=p8, err_qfn=p8)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert [getattr(fn, attr) - b
            for (fn, attr), b in zip(counters, before)] == [1, 1, 1, 1]
    assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v))


def test_unpacked_leaf_launches_kernel_13_on_cuda(cuda_device, monkeypatch):
    """An unpacked 8-bit leaf (a padded last block) launches kernel 13 and a
    packed leaf kernel 14, never a plain version; kernel 13's codes,
    scales and update equal its plain version's bit for bit."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on CUDA tensors")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    odd = torch.nn.Parameter(torch.zeros((100, 77), device=cuda_device))
    packed = torch.nn.Parameter(torch.zeros((512, 256), device=cuda_device))
    grads = [torch.randn(p.shape, generator=gen, device=cuda_device) * 1e-2
             for p in (odd, packed)]
    opt = Adam8bit([odd, packed], lr=1e-3)
    counters = (adam8bit_step.fused_adam8bit_update,
                adam8bit_step.fused_adam8bit_update_packed)
    before = [fn.launches for fn in counters]
    with monkeypatch.context() as m:
        for name in ("fused_adam8bit_update_plain",
                     "fused_adam8bit_update_packed_plain"):
            m.setattr(adam8bit_step, name, refuse)
        for _ in range(2):
            for p, g in zip((odd, packed), grads):
                p.grad = g.clone()
            opt.step()
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == [2, 2]
    st = opt.state[odd]
    assert st["mu_codes"].dtype == torch.int8
    g2d = torch.nn.functional.pad(grads[0].reshape(-1),
                                  (0, -odd.numel() % 256)).reshape(-1, 256)
    args = (g2d, st["mu_codes"], st["mu_scale"], st["nu_codes"],
            st["nu_scale"], 0.19, 0.002)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8)
    got = adam8bit_step.fused_adam8bit_update(*args, **kw)
    want = adam8bit_step.fused_adam8bit_update_plain(*args, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _launches(fn, call):
    before = fn.launches
    out = call()
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    return out


@pytest.mark.parametrize("fmt", ["mx8", "posit8", "w2a16", "w2x4"])
def test_storage_gemm_launches_and_matches_plain(cuda_device, fmt):
    """Each storage GEMM launches its kernel once and agrees with its plain
    version on the same inputs (1e-4 + 1e-2*|plain|, chip_smoke.py's
    bound), at decode and prefill row counts."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    w = torch.randn((512, 192), generator=gen, device=cuda_device) / 512 ** .5
    if fmt == "mx8":
        p = mx_storage.pack_mx_weights(w, block_size=64)
        fn, plain = mx_storage.mx_matmul, mx_storage.mx_matmul_plain
        kw = dict(block_size=64)
    elif fmt == "posit8":
        p = (posit_storage.pack_posit_weights(w.bfloat16()),)
        fn, plain = posit_storage.posit_matmul, posit_storage.posit_matmul_plain
        kw = {}
    else:
        c, sf, zp = aff.pack_affine_weights(w, 2, 64)
        nbits = 2
        if fmt == "w2x4":
            c, zp, nbits = aff.expand_w2_words_to_w4(c), zp + 6, 4
        p = (c, sf, zp)
        fn, plain = aff.affine_matmul, aff.affine_matmul_plain
        kw = dict(nbits=nbits, group_size=64)
    for M in (8, 70):
        x = torch.randn((M, 512), generator=gen,
                        device=cuda_device).bfloat16()
        got = _launches(fn, lambda: fn(x, *p, **kw))
        want = plain(x, *p, **kw)
        assert torch.allclose(got.float(), want.float(), atol=1e-4,
                              rtol=1e-2)


def _affine_pack(fmt, K, N, group, gen, device):
    """(codes, sf, zp, nbits) of a seeded (K, N) weight: w4, w2a16, or w2x4
    (the w2 codes in the w4 word layout, zero points + 6, nbits 4)."""
    w = torch.randn((K, N), generator=gen, device=device) / K ** .5
    nbits = 4 if fmt == "w4" else 2
    c, sf, zp = aff.pack_affine_weights(w, nbits, group)
    if fmt == "w2x4":
        c, zp, nbits = aff.expand_w2_words_to_w4(c), zp + 6, 4
    return c, sf, zp, nbits


@pytest.mark.parametrize("fmt", ["w4", "w2a16", "w2x4"])
@pytest.mark.parametrize("group", [32, 64, 128])
def test_storage_gemm_tensor_cores_match_plain(cuda_device, fmt, group):
    """The M > 8 storage GEMM (wgmma, the weight dequantized in registers)
    at ragged M and N: within 1e-4 + 1e-2*|plain| of the plain version
    (chip_smoke.py's bound), counted as a prefill launch, the same bits
    from a repeated call, and the identity's rows bit-equal to the
    dequantized weight (k 0..63 and the last group).  On an H100 the
    shapes take every token tile: M=9 the 64-token one, M=70 and N=200
    the 128-token one, M=300 at N=4200 the 256-token one."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    K = 512
    fn = aff.affine_matmul
    for N in (200, 4200):
        c, sf, zp, nbits = _affine_pack(fmt, K, N, group, gen, cuda_device)
        kw = dict(nbits=nbits, group_size=group)
        for M in (9, 70, 300):
            x = torch.randn((M, K), generator=gen,
                            device=cuda_device).bfloat16()
            want = aff.affine_matmul_plain(x, c, sf, zp, **kw)
            before = fn.prefill_launches
            got = _launches(fn, lambda: fn(x, c, sf, zp, **kw))
            assert fn.prefill_launches == before + 1
            assert torch.allclose(got.float(), want.float(), atol=1e-4,
                                  rtol=1e-2), (N, M)
            again = fn(x, c, sf, zp, **kw)
            assert torch.equal(got.view(torch.int16),
                               again.view(torch.int16)), (N, M)
        rows = list(range(64)) + list(range(K - group, K))
        eye = torch.zeros((len(rows), K), dtype=torch.bfloat16,
                          device=cuda_device)
        eye[torch.arange(len(rows)), torch.tensor(rows)] = 1
        w_bf16 = aff._dequant_planes(c, sf, zp, nbits, group).bfloat16()
        got = fn(eye, c, sf, zp, **kw)
        assert torch.equal(got.view(torch.int16),
                           w_bf16[rows].view(torch.int16)), N


def test_storage_gemm_odd_widths_on_cuda(cuda_device):
    """N not a multiple of 4 (4-byte copies of the words and qparams, 2-byte
    stores of y) and K not a multiple of 64 (a partial last K step)."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    for fmt, K, N, group in [("w4", 200, 203, 8), ("w2a16", 224, 77, 32)]:
        c, sf, zp, nbits = _affine_pack(fmt, K, N, group, gen, cuda_device)
        kw = dict(nbits=nbits, group_size=group)
        for M in (9, 130):
            x = torch.randn((M, K), generator=gen,
                            device=cuda_device).bfloat16()
            want = aff.affine_matmul_plain(x, c, sf, zp, **kw)
            got = aff.affine_matmul(x, c, sf, zp, **kw)
            torch.cuda.synchronize()
            assert torch.allclose(got.float(), want.float(), atol=1e-4,
                                  rtol=1e-2), (fmt, M)


def test_storage_gemm_unaligned_operands_on_cuda(cuda_device):
    """Codes, sf and zp 4 bytes past 16-byte alignment (contiguous views
    into a larger buffer) at N % 4 == 0, on both paths (M 8 and 130)."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    K, N = 512, 256
    for fmt, group in [("w4", 64), ("w2a16", 32)]:
        packed = _affine_pack(fmt, K, N, group, gen, cuda_device)
        c = []
        for t in packed[:3]:
            buf = torch.empty(t.numel() + 1, dtype=t.dtype,
                              device=cuda_device)
            c.append(buf[1:].view(t.shape).copy_(t))
        assert all(t.is_contiguous() and t.data_ptr() % 16 for t in c)
        kw = dict(nbits=packed[3], group_size=group)
        for M in (8, 130):
            x = torch.randn((M, K), generator=gen,
                            device=cuda_device).bfloat16()
            want = aff.affine_matmul_plain(x, *c, **kw)
            got = aff.affine_matmul(x, *c, **kw)
            torch.cuda.synchronize()
            assert torch.allclose(got.float(), want.float(), atol=1e-4,
                                  rtol=1e-2), (fmt, M)


# ---- kernel 5's decode form (M <= 8, mma.sync) ------------------------------
_W4_DECODE = [(fmt, group) for fmt in ("w4", "w2a16", "w2x4")
              for group in (16, 32, 64, 128)]


def _eye_rows(rows, K, device):
    eye = torch.zeros((len(rows), K), dtype=torch.bfloat16, device=device)
    eye[torch.arange(len(rows)), torch.tensor(rows)] = 1
    return eye


def _decode_launch(fn, call, M, K, N):
    """call() once, as one launch of the decode form (no wgmma launch) at
    its own (M, K, N)."""
    before = (fn.launches, fn.prefill_launches, fn.shape_launches[(M, K, N)])
    out = call()
    torch.cuda.synchronize()
    assert (fn.launches, fn.prefill_launches,
            fn.shape_launches[(M, K, N)]) == (before[0] + 1, before[1],
                                              before[2] + 1)
    return out


@pytest.mark.parametrize("fmt,group", _W4_DECODE)
def test_w4_decode_identity_rows_every_m_and_repeat(cuda_device, fmt, group):
    """Kernel 5's decode form: the identity's rows give the plain version's
    bf16 weight rows bit for bit (8 rows a call, the first and last rows of
    K, at K=1024, split over 8 blocks, and K=128, one block); every M from
    1 to 8 within 1e-4 + 1e-2*|plain| (chip_smoke.py's bound), one decode
    launch a call, and a repeated call bit-equal (K=4096: 16 splits)."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    fn = aff.affine_matmul
    for K, N in [(1024, 256), (128, 384)]:
        c, sf, zp, nbits = _affine_pack(fmt, K, N, group, gen, cuda_device)
        kw = dict(nbits=nbits, group_size=group)
        w_bf16 = aff._dequant_planes(c, sf, zp, nbits, group).bfloat16()
        for r0 in sorted({0, 64, K - 128, K - 64, K - 8}):
            rows = list(range(r0, r0 + 8))
            eye = _eye_rows(rows, K, cuda_device)
            got = _decode_launch(fn, lambda: fn(eye, c, sf, zp, **kw), 8, K,
                                 N)
            assert torch.equal(got.view(torch.int16),
                               w_bf16[rows].view(torch.int16)), (K, r0)
    K, N = 4096, 256
    c, sf, zp, nbits = _affine_pack(fmt, K, N, group, gen, cuda_device)
    kw = dict(nbits=nbits, group_size=group)
    for M in range(1, 9):
        x = torch.randn((M, K), generator=gen, device=cuda_device).bfloat16()
        got = _decode_launch(fn, lambda: fn(x, c, sf, zp, **kw), M, K, N)
        want = aff.affine_matmul_plain(x, c, sf, zp, **kw)
        assert torch.allclose(got.float(), want.float(), atol=1e-4,
                              rtol=1e-2), M
        again = fn(x, c, sf, zp, **kw)
        assert torch.equal(got.view(torch.int16), again.view(torch.int16)), M


@pytest.mark.parametrize("fmt", ["w4", "w2a16", "w2x4"])
def test_w4_decode_odd_shapes_and_offsets(cuda_device, fmt):
    """Kernel 5's decode form at odd N (not a multiple of 4: 4-byte copies;
    32064, Phi-3's lm_head), K = 17920 and 13824 (Phi-3's and the 13B's
    down), and with codes, sf and zp 4 bytes past 16-byte alignment: within
    the bound at M 1 and 8, the identity's first and last 8 rows bit for
    bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    fn = aff.affine_matmul
    for K, N, group in [(512, 77, 64), (256, 1003, 32), (256, 32064, 64),
                        (17920, 136, 64), (13824, 200, 128)]:
        packed = _affine_pack(fmt, K, N, group, gen, cuda_device)
        kw = dict(nbits=packed[3], group_size=group)
        variants = [packed[:3]]
        if N % 4 == 0:
            shifted = []
            for t in packed[:3]:
                buf = torch.empty(t.numel() + 1, dtype=t.dtype,
                                  device=cuda_device)
                shifted.append(buf[1:].view(t.shape).copy_(t))
            assert all(t.data_ptr() % 16 for t in shifted)
            variants.append(tuple(shifted))
        w_bf16 = aff._dequant_planes(*packed[:3], packed[3],
                                     group).bfloat16()
        for p in variants:
            for M in (1, 8):
                x = torch.randn((M, K), generator=gen,
                                device=cuda_device).bfloat16()
                got = _decode_launch(fn, lambda: fn(x, *p, **kw), M, K, N)
                want = aff.affine_matmul_plain(x, *p, **kw)
                assert torch.allclose(got.float(), want.float(), atol=1e-4,
                                      rtol=1e-2), (K, N, M)
            for rows in (list(range(8)), list(range(K - 8, K))):
                got = fn(_eye_rows(rows, K, cuda_device), *p, **kw)
                assert torch.equal(got.view(torch.int16),
                                   w_bf16[rows].view(torch.int16)), (K, N)


@pytest.mark.parametrize("fmt", ["w4", "w2a16"])
def test_w4_decode_extreme_qparams_bit_equal(cuda_device, fmt):
    """The decode form's weight at the edges of f32: groups with a zero
    point of 2^-110 or -2^-120, a scale of 2^101, zero points 0, and the
    groups around them: the identity's rows bit for bit, and M=8 within
    the bound."""
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    fn = aff.affine_matmul
    K, N = 1024, 256
    c, sf, zp, nbits = _affine_pack(fmt, K, N, 64, gen, cuda_device)
    zp[3, 5], zp[4, 130], sf[6, 9] = 2.0 ** -110, -2.0 ** -120, 2.0 ** 101
    zp[7] = 0
    kw = dict(nbits=nbits, group_size=64)
    w_bf16 = aff._dequant_planes(c, sf, zp, nbits, 64).bfloat16()
    for r0 in range(128, 576, 8):
        rows = list(range(r0, r0 + 8))
        got = _decode_launch(fn, lambda: fn(_eye_rows(rows, K, cuda_device),
                                            c, sf, zp, **kw), 8, K, N)
        assert torch.equal(got.view(torch.int16),
                           w_bf16[rows].view(torch.int16)), r0
    x = torch.randn((8, K), generator=gen, device=cuda_device).bfloat16()
    got = fn(x, c, sf, zp, **kw)
    want = aff.affine_matmul_plain(x, c, sf, zp, **kw)
    assert torch.allclose(got.float(), want.float(), atol=1e-4, rtol=1e-2)


def test_w4_group_8_at_decode_runs_the_wgmma_form(cuda_device):
    """w4 at group 8 holds no whole 16-deep k step, so M <= 8 runs the
    wgmma form (w4_gemm_tc, counted in prefill_launches; TMA reads the rows
    past M as zero): within the bound, the identity's rows bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    fn = aff.affine_matmul
    K, N = 512, 200
    c, sf, zp, nbits = _affine_pack("w4", K, N, 8, gen, cuda_device)
    kw = dict(nbits=nbits, group_size=8)
    for M in (1, 5, 8):
        x = torch.randn((M, K), generator=gen, device=cuda_device).bfloat16()
        before = fn.prefill_launches
        got = _launches(fn, lambda: fn(x, c, sf, zp, **kw))
        assert fn.prefill_launches == before + 1
        want = aff.affine_matmul_plain(x, c, sf, zp, **kw)
        assert torch.allclose(got.float(), want.float(), atol=1e-4,
                              rtol=1e-2), M
    w_bf16 = aff._dequant_planes(c, sf, zp, nbits, 8).bfloat16()
    rows = list(range(K - 8, K))
    got = fn(_eye_rows(rows, K, cuda_device), c, sf, zp, **kw)
    assert torch.equal(got.view(torch.int16), w_bf16[rows].view(torch.int16))


# ---- kernels 9 and 10: the decode form (M <= 8) and the wgmma form ---------
def _byte_pack(fmt, param, K, N, gen, device):
    """(wrapper, plain, operands, keywords, bf16 weight) of a seeded (K, N)
    weight in MX8 (param: the block size) or posit8 (param: es)."""
    w = torch.randn((K, N), generator=gen, device=device) / K ** .5
    if fmt == "mx8":
        p = mx_storage.pack_mx_weights(w, block_size=param)
        return (mx_storage.mx_matmul, mx_storage.mx_matmul_plain, p,
                dict(block_size=param), mx_storage.mx_dequant(*p, param))
    codes = posit_storage.pack_posit_weights(w.bfloat16(), es=param)
    return (posit_storage.posit_matmul, posit_storage.posit_matmul_plain,
            (codes,), dict(es=param),
            posit_storage.decode_posit(codes, 8, param).bfloat16())


def _offset_view(t, nbytes):
    """t copied into a contiguous view ``nbytes`` past 16-byte alignment."""
    step = nbytes // t.element_size()
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    assert buf.data_ptr() % 16 == 0
    view = buf[step:step + t.numel()].view(t.shape).copy_(t)
    assert view.data_ptr() % 16 == nbytes
    return view


_DECODE_FORMS = [("mx8", 32), ("mx8", 64), ("mx8", 128), ("mx8", 8),
                 ("mx8", 24), ("posit8", 0), ("posit8", 1), ("posit8", 2)]
# the wgmma form (M > 8, and M <= 8 at MX block sizes the decode form
# refuses): MX block sizes 4 through 128 (one scale row a 64-row stage at
# 64 and 128, one a k row below), posit8 es 0-2
_TC_FORMS = [("mx8", bs) for bs in (4, 8, 12, 16, 24, 32, 48, 64, 128)] + [
    ("posit8", 0), ("posit8", 1), ("posit8", 2)]
# M of each form: the decode form's, and the wgmma form's across its
# token tiles (64, 128, 256), ragged and not
_FORM_MS = {"decode": tuple(range(1, 9)),
            "tc": (9, 16, 67, 128, 129, 256, 1024)}


def _tc_shapes(fmt, param):
    """(K, N) of the wgmma form's identity check: K a multiple of the MX
    block size and of 8 near 1024 (several stages, a partial last one
    where 64 does not divide it) and near 128, N ragged against the
    128-column tile."""
    step = 8 if fmt == "posit8" else math.lcm(param, 8)
    return [(step * -(-1024 // step), 320), (step * -(-128 // step), 200)]


@pytest.mark.parametrize("form,fmt,param",
                         [("decode", f, p) for f, p in _DECODE_FORMS]
                         + [("tc", f, p) for f, p in _TC_FORMS])
def test_decode_form_identity_rows_bit_equal(cuda_device, form, fmt, param):
    """The identity's rows give the plain version's bf16 weight rows bit
    for bit.  Decode form: 8 rows a call, the first and last 128 rows of
    K, at a K split over several blocks (K=1024; 1032 at MX block size 24)
    and at one block (K=128; 120).  wgmma form: the whole identity in one
    call (M = K, about 1024 and 128), so every row of the weight."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    if form == "tc":
        for K, N in _tc_shapes(fmt, param):
            fn, _, p, kw, w_bf16 = _byte_pack(fmt, param, K, N, gen,
                                              cuda_device)
            eye = torch.eye(K, dtype=torch.bfloat16, device=cuda_device)
            got = _launches(fn, lambda: fn(eye, *p, **kw))
            assert torch.equal(got.view(torch.int16),
                               w_bf16.view(torch.int16)), (K, N)
        return
    shapes = [(1024, 256), (128, 384)]
    if fmt == "mx8" and 128 % param:
        shapes = [(1032, 256), (120, 384)]
    for K, N in shapes:
        fn, _, p, kw, w_bf16 = _byte_pack(fmt, param, K, N, gen, cuda_device)
        for r0 in sorted({0, 64, K - 128, K - 64, K - 8}):
            rows = list(range(r0, r0 + 8))
            eye = torch.zeros((8, K), dtype=torch.bfloat16, device=cuda_device)
            eye[torch.arange(8), torch.tensor(rows)] = 1
            got = _launches(fn, lambda: fn(eye, *p, **kw))
            assert torch.equal(got.view(torch.int16),
                               w_bf16[rows].view(torch.int16)), (K, r0)


@pytest.mark.parametrize("form", ["decode", "tc"])
@pytest.mark.parametrize("fmt,param", [("mx8", 64), ("posit8", 1)])
def test_decode_form_every_m_and_repeat(cuda_device, fmt, param, form):
    """Every M of the form (decode: 1-8; wgmma: 9, 16, 67, 128, 129, 256,
    1024) within 1e-4 + 1e-2*|plain| (chip_smoke.py's bound), one launch
    a call, and a repeated call bit-equal, at K = 4096, 512 and 128 (the
    decode form splits them over 16, 4 and 1 blocks)."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    for K, N in [(4096, 256), (512, 256), (128, 512)]:
        fn, plain, p, kw, _ = _byte_pack(fmt, param, K, N, gen, cuda_device)
        for M in _FORM_MS[form]:
            x = torch.randn((M, K), generator=gen,
                            device=cuda_device).bfloat16()
            got = _launches(fn, lambda: fn(x, *p, **kw))
            want = plain(x, *p, **kw)
            assert torch.allclose(got.float(), want.float(), atol=1e-4,
                                  rtol=1e-2), (K, M)
            again = fn(x, *p, **kw)
            assert torch.equal(got.view(torch.int16),
                               again.view(torch.int16)), (K, M)


@pytest.mark.parametrize("form", ["decode", "tc"])
@pytest.mark.parametrize("fmt,param", [("mx8", 32), ("mx8", 64),
                                       ("posit8", 2)])
def test_decode_form_odd_shapes_and_offsets(cuda_device, fmt, param, form):
    """Odd N (a ragged last tile, byte copies), K not a multiple of 64 or 16
    (posit8), codes 1, 2 and 4 bytes past 16-byte alignment and MX scales
    2 and 4 bytes past it (the wgmma form: the producer's lanes copy what
    TMA cannot bring): within the bound at M 1 and 8 (decode) or 9 and
    130 (wgmma), the identity's first 8 (16) rows bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    shapes = [(512, 77), (256, 1000)]
    if fmt == "posit8":
        shapes += [(520, 136), (200, 130)]
    Ms, n_eye = ((1, 8), 8) if form == "decode" else ((9, 130), 16)
    for K, N in shapes:
        fn, plain, p, kw, w_bf16 = _byte_pack(fmt, param, K, N, gen,
                                              cuda_device)
        variants = [p] + [(_offset_view(p[0], off),) + tuple(p[1:])
                          for off in (1, 2, 4)]
        if fmt == "mx8":
            variants += [(p[0], _offset_view(p[1], off)) for off in (2, 4)]
        for q in variants:
            for M in Ms:
                x = torch.randn((M, K), generator=gen,
                                device=cuda_device).bfloat16()
                got = _launches(fn, lambda: fn(x, *q, **kw))
                want = plain(x, *q, **kw)
                assert torch.allclose(got.float(), want.float(), atol=1e-4,
                                      rtol=1e-2), (K, N, M)
            eye = torch.eye(n_eye, K, dtype=torch.bfloat16,
                            device=cuda_device)
            got = fn(eye, *q, **kw)
            assert torch.equal(got.view(torch.int16),
                               w_bf16[:n_eye].view(torch.int16)), (K, N)


@pytest.mark.parametrize("form", ["decode", "tc"])
@pytest.mark.parametrize("block_size", [4, 12, 24])
def test_mx_decode_at_other_block_sizes(cuda_device, block_size, form):
    """MX block sizes that are not a multiple of 16: at M 1-8, 24 (a
    multiple of 8) in the decode form, a scale row for each half of a k
    step, 4 and 12 in the wgmma form; at M 9, 67 and 129 all three in the
    wgmma form, a scale row a k row.  Within 1e-4 + 1e-2*|plain|, one
    launch a call, the identity's rows bit for bit (8 or 16 a call, the
    first and last of K)."""
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    Ms, n_eye = ((range(1, 9), 8) if form == "decode"
                 else ((9, 67, 129), 16))
    for K, N in [(1032, 256), (120, 200)]:
        fn, plain, p, kw, w_bf16 = _byte_pack("mx8", block_size, K, N, gen,
                                              cuda_device)
        for M in Ms:
            x = torch.randn((M, K), generator=gen,
                            device=cuda_device).bfloat16()
            got = _launches(fn, lambda: fn(x, *p, **kw))
            want = plain(x, *p, **kw)
            assert torch.allclose(got.float(), want.float(), atol=1e-4,
                                  rtol=1e-2), (K, M)
        for r0 in (0, K - n_eye):
            eye = torch.zeros((n_eye, K), dtype=torch.bfloat16,
                              device=cuda_device)
            eye[torch.arange(n_eye), torch.arange(r0, r0 + n_eye)] = 1
            assert torch.equal(fn(eye, *p, **kw).view(torch.int16),
                               w_bf16[r0:r0 + n_eye].view(torch.int16)), \
                (K, r0)


def test_dequant_planes_bit_equal_on_cuda(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    w = torch.randn((1024, 96), generator=gen, device=cuda_device)
    for nbits in (4, 2):
        p = aff.pack_affine_weights(w, nbits, 64)
        got = _launches(aff.dequant_planes,
                        lambda: aff.dequant_planes(*p, nbits, 64))
        want = aff.dequant_planes_plain(*p, nbits, 64)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("bits,pack", [(2, True), (4, True), (2, False)])
def test_kivi_decode_launches_and_matches_plain(cuda_device, bits, pack):
    """The fused KIVI decode at the CPU tests' geometry (H=4, KV=2, D=64)
    against its plain version (2e-2 + 2e-2*|plain|, chip_smoke.py's
    bound)."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    B, H, KV, D, P, R = 2, 4, 2, 64, 64, 8
    spec = "uint{},qs=group_wise_affine,bs=32,ax={}"
    cfg = kvc.KVCacheConfig.kivi(P, R, spec.format(bits, -2),
                                 spec.format(bits, -1), pack)

    def rnd(*shape):
        return torch.randn(shape, generator=gen,
                           device=cuda_device).bfloat16()

    cache = kvc.prefill_cache(kvc.init_cache(cfg, B, KV, D,
                                             device=cuda_device),
                              cfg, rnd(B, P, KV, D), rnd(B, P, KV, D),
                              length=40)
    lens = (torch.tensor([40, 17], dtype=torch.int32, device=cuda_device),
            torch.tensor([3, R], dtype=torch.int32, device=cuda_device))
    args = (rnd(B, H, D), *cache[:6], rnd(B, KV, R, D), rnd(B, KV, R, D),
            *lens)
    bk = cfg._pack_bits(cfg.k_spec)
    fn = kivi_attention.kivi_decode_attention
    got = _launches(fn, lambda: fn(*args, bits_k=bk, bits_v=bk))
    want = kivi_attention.kivi_decode_plain(*args, bits_k=bk, bits_v=bk,
                                            scale=D ** -0.5)
    assert torch.allclose(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    again = fn(*args, bits_k=bk, bits_v=bk)
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))


def _kivi_case(gen, B, H, KV, D, P, R, bits, pack):
    spec = "uint{},qs=group_wise_affine,bs=32,ax={}"
    cfg = kvc.KVCacheConfig.kivi(P, R, spec.format(bits, -2),
                                 spec.format(bits, -1), pack)
    cache = kvc.prefill_cache(kvc.init_cache(cfg, B, KV, D,
                                             device=gen.device),
                              cfg, _rnd(gen, B, P, KV, D),
                              _rnd(gen, B, P, KV, D))
    return (cfg._pack_bits(cfg.k_spec), cache, _rnd(gen, B, KV, R, D),
            _rnd(gen, B, KV, R, D), _rnd(gen, B, H, D))


@pytest.mark.parametrize("bits,pack", [(2, True), (4, True), (2, False)])
def test_kivi_decode_edges_splits_and_repeat(cuda_device, bits, pack):
    """The KIVI decode where its split cuts the tokens (a pair's steps over
    several blocks of one cluster): in one batch an empty main tier with
    ring rows, a full main tier, an empty ring with main tokens and a full
    ring, then main_len one token either side of a warp's and of the first
    block's last row; within 2e-2 + 2e-2*|plain| of the plain version, one
    launch each, and a repeated call bit-equal."""
    gen = torch.Generator(device=cuda_device).manual_seed(20 + bits)
    B, H, KV, D, P, R = 4, 8, 2, 128, 1024, 64
    bk, cache, k_res, v_res, q = _kivi_case(gen, B, H, KV, D, P, R, bits,
                                            pack)
    plan = kivi_attention.kivi_launch_plan(
        cuda_device, B, H, KV, D, P, R, cache.k_scale.shape[2],
        cache.v_scale.shape[3], bk)
    assert plan.splits > 1
    # the first row past warp 0's and past block 0's main rows (a row's
    # token in plane 0 is its index)
    warps = kivi_attention.kivi_plan_tokens(plan, R, bk)
    warp_end = max(t % plan.rows for t in warps[0][0][0]) + 1
    block_end = max(t % plan.rows for w, _ in warps[0] for t in w) + 1
    i32 = dict(dtype=torch.int32, device=cuda_device)
    cases = [([0, P, 700, P], [1, 17, 0, R]),
             ([warp_end - 1, warp_end, warp_end + 1, block_end - 1], [3] * B),
             ([block_end, block_end + 1, 1, P - 1], [R, 0, 1, 5])]
    fn = kivi_attention.kivi_decode_attention
    for ml, rl in cases:
        args = (q, *cache[:6], k_res, v_res, torch.tensor(ml, **i32),
                torch.tensor(rl, **i32))
        got = _launches(fn, lambda: fn(*args, bits_k=bk, bits_v=bk))
        want = kivi_attention.kivi_decode_plain(*args, bits_k=bk, bits_v=bk,
                                                scale=D ** -0.5)
        assert torch.allclose(got.float(), want.float(), atol=2e-2,
                              rtol=2e-2), (ml, rl)
        again = fn(*args, bits_k=bk, bits_v=bk)
        assert torch.equal(got.view(torch.int16), again.view(torch.int16))


def test_kivi_decode_takes_more_than_256_k_groups(cuda_device):
    """P = 16384 at the flagship's block of 32 tokens: 512 K groups a kv
    head, past the 256 the CUDA-core kernel held in a table; the
    tensor-core kernel computes each split's K constants in registers."""
    gen = torch.Generator(device=cuda_device).manual_seed(31)
    B, H, KV, D, P, R = 1, 4, 2, 128, 16384, 32
    bk, cache, k_res, v_res, q = _kivi_case(gen, B, H, KV, D, P, R, 2, True)
    assert cache.k_scale.shape[2] == 512
    i32 = dict(dtype=torch.int32, device=cuda_device)
    for ml in (P, 12345):
        args = (q, *cache[:6], k_res, v_res, torch.tensor([ml], **i32),
                torch.tensor([R], **i32))
        fn = kivi_attention.kivi_decode_attention
        got = _launches(fn, lambda: fn(*args, bits_k=bk, bits_v=bk))
        want = kivi_attention.kivi_decode_plain(*args, bits_k=bk, bits_v=bk,
                                                scale=D ** -0.5)
        assert torch.allclose(got.float(), want.float(), atol=2e-2,
                              rtol=2e-2)


def test_w8a8_integer_dot_exact_on_cuda(cuda_device):
    """torch._int_mm with the rows padded: the same result as the exact CPU
    product, for a decode-sized M."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    w = torch.randn((256, 64), generator=gen, device=cuda_device)
    codes, ws = int8_matmul.pack_int8_weights(w)
    for M in (3, 40):
        x = torch.randn((M, 256), generator=gen, device=cuda_device)
        got = int8_matmul.w8a8_matmul(x, codes, ws, out_dtype=torch.float32)
        want = int8_matmul.w8a8_matmul(x.cpu(), codes.cpu(), ws.cpu(),
                                       out_dtype=torch.float32)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("int_dots,k_transposed",
                         [(True, True), (True, False), (False, True)])
def test_int_kv_tile_forms_launch_and_match_plain(cuda_device, int_dots,
                                                  k_transposed):
    """The int8 decode's integer-dot and K^T forms launch kernel 7 (counted
    in ``tile_launches``) and agree with the plain version within
    chip_smoke.py's bounds (max error 2e-3, at most 0.5% of outputs outside
    1e-4 + 1e-3|plain|), at D=128, H=KV with a short main tier."""
    from quantized_training_torch.ops import int_kv_attention as ikv
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    B, H, D, P, R = 2, 4, 128, 256, 16
    cfg = kvc.KVCacheConfig.int_sym(P, R, 8)

    def rnd(*shape):
        return torch.randn(shape, generator=gen,
                           device=cuda_device).bfloat16()

    cache = kvc.prefill_cache(kvc.init_cache(cfg, B, H, D,
                                             device=cuda_device),
                              cfg, rnd(B, P, H, D), rnd(B, P, H, D))
    kc = (cache.k_codes.transpose(2, 3).contiguous() if k_transposed
          else cache.k_codes)
    lens = (torch.tensor([P, 77], dtype=torch.int32, device=cuda_device),
            torch.tensor([3, R], dtype=torch.int32, device=cuda_device))
    args = (rnd(B, H, D), kc, cache.k_scale, cache.v_codes, cache.v_scale,
            rnd(B, H, R, D), rnd(B, H, R, D), *lens)
    form = dict(bits=8, int_dots=int_dots, k_transposed=k_transposed)
    fn = ikv.int_kv_decode_attention
    before = fn.tile_launches
    got = fn(*args, **form)
    torch.cuda.synchronize()
    assert fn.tile_launches == before + 1
    want = ikv.int_kv_decode_plain(*args, scale=D ** -0.5, **form)
    err = (got.float() - want.float()).abs()
    assert float(err.max()) <= 2e-3
    assert float((err > 1e-4 + 1e-3 * want.float().abs()).float().mean()) \
        <= 0.005


def _bits_equal(got, want):
    """Bit for bit, NaN lanes counted equal to each other."""
    itype = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    both_nan = torch.isnan(got.float()) & torch.isnan(want.float())
    return bool(((got.view(itype) == want.view(itype)) | both_nan).all())


def _packed_edge_state(nb, gen):
    """A packed leaf's g and state spread over f32's range (chip_smoke.py's
    ``packed_edge_state``): lanes whose m or v leave kernel 14's fast
    paths' ranges, rows whose scales do, zero rows, elements and state."""
    dev = gen.device

    def exps(shape, lo, hi):
        return torch.exp2(torch.randint(lo, hi, shape, generator=gen,
                                        device=dev).float())

    g = torch.randn((nb, 256), generator=gen, device=dev) * exps(
        (nb, 1), -75, 53) * exps((nb, 256), -6, 7)
    g[::5] = 0.0
    g[torch.rand((nb, 256), generator=gen, device=dev) < 0.05] = 0.0
    mc = torch.randint(-127, 128, (nb, 256), generator=gen, device=dev,
                       dtype=torch.int32)
    vc = torch.randint(0, 256, (nb, 256), generator=gen, device=dev,
                       dtype=torch.int32)
    ms = torch.rand(nb, generator=gen, device=dev) * exps((nb,), -75, 53)
    vs = torch.rand(nb, generator=gen, device=dev) * exps((nb,), -60, 41)
    mc[::7] = 0
    vc[::7] = 0
    ms[::7] = 1.0
    vs[::7] = 1.0
    # the ranges where the kernel leaves its fast paths, each reached
    m = torch.tensor(0.9) * (mc.float() * ms[:, None]) + torch.tensor(
        1.0 - 0.9) * g
    root = vc.float() * vs[:, None]
    v = torch.tensor(0.999) * (root * root) + torch.tensor(1.0 - 0.999) * (
        g * g)
    am = m.abs()
    for reached in ((am > 0) & (am < 2.0 ** -40), am > 2.0 ** 40,
                    (v > 0) & (v < 2.0 ** -80), v > 2.0 ** 80,
                    am.amax(1) > 2.0 ** 50, v.amax(1) > 2.0 ** 50,
                    (am.amax(1) > 0) & (am.amax(1) < 2.0 ** -50)):
        assert bool(reached.any())
    return g, mc, ms, vc, vs


@pytest.mark.parametrize("nb", [16384, 44032, 256000, 9216])
@pytest.mark.parametrize("data", ["random", "zero", "edge"])
def test_packed_adam_bit_equal_at_the_leaf_sizes(cuda_device, nb, data):
    """Kernel 14 at the posit8 train step's leaves (2048 x 2048, 2048 x
    5504, 32000 x 2048) and BERT-base's MLP kernel (768 x 3072), from
    random state, from a leaf whose gradients the error taps flushed
    (zeros) and from an edge leaf (lanes and rows outside its fast paths'
    ranges): update, words and scales (pad rows too) bit-equal to the plain
    version at counts 1 and 7, and at the constants under which the launch
    takes the intrinsics throughout (a first bias correction below 2^-20,
    eps 0, a subnormal eps), one launch a call."""
    from quantized_training_torch.training.optim8bit import bias_corrections
    gen = torch.Generator(device=cuda_device).manual_seed(nb)
    if data == "random":
        g2d = torch.randn((nb, 256), generator=gen, device=cuda_device) * 1e-3
        mc = torch.randint(-127, 128, (nb, 256), generator=gen,
                           device=cuda_device, dtype=torch.int32)
        vc = torch.randint(0, 256, (nb, 256), generator=gen,
                           device=cuda_device, dtype=torch.int32)
        ms = torch.rand(nb, generator=gen, device=cuda_device) * 1e-4 + 1e-7
        vs = torch.rand(nb, generator=gen, device=cuda_device) * 1e-4 + 1e-7
    elif data == "zero":
        g2d = torch.zeros((nb, 256), device=cuda_device)
        mc = vc = torch.zeros((nb, 256), device=cuda_device, dtype=torch.int32)
        ms = vs = torch.ones(nb, device=cuda_device)
    else:
        g2d, mc, ms, vc, vs = _packed_edge_state(nb, gen)
    state = (adam8bit_step.pack_moment_rows(mc),
             adam8bit_step.pack_scale_rows(ms),
             adam8bit_step.pack_moment_rows(vc),
             adam8bit_step.pack_scale_rows(vs))
    for b2, eps, count in ((0.999, 1e-8, 1), (0.999, 1e-8, 7),
                           (0.9999999, 1e-8, 1), (0.999, 0.0, 1),
                           (0.999, 1e-45, 1)):
        kw = dict(b1=0.9, b2=b2, eps=eps)
        bc = bias_corrections(0.9, b2, count)
        got = _launches(adam8bit_step.fused_adam8bit_update_packed,
                        lambda: adam8bit_step.fused_adam8bit_update_packed(
                            g2d, *state, *bc, **kw))
        want = adam8bit_step.fused_adam8bit_update_packed_plain(
            g2d, *state, *bc, **kw)
        for a, b in zip(got, want):
            assert _bits_equal(a, b), (b2, eps, count)


TABLE_FORMATS = ["posit8_1", "posit16_1", "e4m3", "e5m2", "fp6_e3m2", "int8",
                 "nf3", "nf4", "nf4_6", "bfloat16", "float16"]


@pytest.mark.parametrize("fmt", TABLE_FORMATS)
def test_rounding_kernel_table_form_every_pattern(cuda_device, fmt):
    """Kernel 11's table form for every format it takes: bit-equal to the
    plain version over all 2^16 bf16 patterns, unaligned and ragged views
    of them, and a 7B-sized weight; the arithmetic form too; the format's
    table built once for all these calls."""
    from quantized_training_torch.ops import quantize_elemwise as qe
    qfn = quantize_fn(fmt)
    universe = torch.arange(2 ** 16, dtype=torch.int32,
                            device=cuda_device).to(torch.int16).view(
                                torch.bfloat16)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    w = (torch.randn((4096, 1024), generator=gen, device=cuda_device)
         * torch.exp2(torch.randn((4096, 1024), generator=gen,
                                  device=cuda_device) * 4)).bfloat16()
    qe.clear_tables()
    builds = qe.quantize_elemwise.table_builds
    for x in (universe, universe[1:], universe[3:-2], universe[:-7], w,
              w.view(-1)[5:]):
        want = qfn.plain(x)
        for form in ("table", "arith"):
            got = _launches(qe.quantize_elemwise,
                            lambda: qe._quantize_elemwise(x, qfn.fmt, form))
            assert _bits_equal(got, want), (form, x.numel())
    assert qe.quantize_elemwise.table_builds - builds == 1
    with pytest.raises(ValueError, match="no table form"):
        qe._quantize_elemwise(universe.float(), qfn.fmt, "table")


@pytest.mark.parametrize("fmt", ["nf4", "nf4_6", "nf3", "bfloat16",
                                 "float16"])
def test_rounding_kernel_nf_and_cast_forms(cuda_device, fmt):
    """Kernel 11 in its NormalFloat-codebook and native-cast forms: through
    quantize_fn on CUDA tensors it launches once per call and is bit-equal
    to its plain version over every bf16 pattern (NaN lanes compared as
    NaN) and over random f32 patterns; the float32 cast returns its input
    without a launch."""
    from quantized_training_torch.ops import quantize_elemwise as qe
    qfn = quantize_fn(fmt)
    universe = torch.arange(2 ** 16, dtype=torch.int32,
                            device=cuda_device).to(torch.int16).view(
                                torch.bfloat16)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    f32 = torch.randint(-2 ** 31, 2 ** 31 - 1, (1 << 16,), dtype=torch.int32,
                        device=cuda_device, generator=gen).view(torch.float32)
    for x, itype in ((universe, torch.int16), (universe[1:], torch.int16),
                     (f32, torch.int32)):
        got = _launches(qe.quantize_elemwise, lambda: qfn(x))
        want = qfn.plain(x)
        both_nan = torch.isnan(got.float()) & torch.isnan(want.float())
        assert bool(((got.view(itype) == want.view(itype)) | both_nan).all())
    before = qe.quantize_elemwise.launches
    assert quantize_fn("float32")(universe) is universe
    assert qe.quantize_elemwise.launches == before


def test_flash_backward_refuses_nf_and_cast(cuda_device):
    """The flash backward kernels take only the roundings they are checked
    with on the card: an NF or native-cast p or error rounding in a
    training call raises before any launch."""
    q = torch.zeros((1, 2, 128, 128), device=cuda_device,
                    dtype=torch.bfloat16, requires_grad=True)
    for hooks in (dict(p_qfn=quantize_fn("nf4")),
                  dict(err_qfn=quantize_fn("bfloat16"))):
        with pytest.raises(ValueError, match="no checked backward form"):
            fa.flash_attention(q, q, q, **hooks)


def _rnd(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device).bfloat16()


def _head_map_fault(plain, q, *args, G, KV, **kw):
    """The plain output of a kernel whose query head h reads kv head h % KV
    instead of h // G: q's heads placed where the plain version's grouping
    gives them kv head h % KV, and the outputs taken back in head order."""
    H = q.shape[1]
    pos = torch.tensor([(h % KV) * G + h // KV for h in range(H)],
                       device=q.device)
    moved = torch.empty_like(q)
    moved[:, pos] = q
    return plain(moved, *args, **kw)[:, pos]


def _int_sym_case(gen, D, G, bits, P=512, R=16, B=2, KV=2):
    cfg = kvc.KVCacheConfig.int_sym(P, R, bits)
    cache = kvc.prefill_cache(kvc.init_cache(cfg, B, KV, D,
                                             device=gen.device),
                              cfg, _rnd(gen, B, P, KV, D),
                              _rnd(gen, B, P, KV, D))
    lens = (torch.tensor([P, 300], dtype=torch.int32, device=gen.device),
            torch.tensor([3, R], dtype=torch.int32, device=gen.device))
    return cache, (_rnd(gen, B, KV, R, D), _rnd(gen, B, KV, R, D)), lens


@pytest.mark.parametrize("D,G", [(d, g) for d in (64, 128)
                                 for g in (1, 2, 4, 8)])
@pytest.mark.parametrize("bits", [4, 8])
def test_int_kv_split_gqa_forms(cuda_device, D, G, bits):
    """Kernel 7's bf16-dot forms over untransposed codes at every
    instantiated (D, G): one launch, within 2e-3 (int4) or 4e-3 (int8) +
    2e-2*|plain| of its plain version, and far outside it from a kernel
    whose head h reads kv head h % KV."""
    from quantized_training_torch.ops import int_kv_attention as ikv
    gen = torch.Generator(device=cuda_device).manual_seed(10 * G + D + bits)
    cache, res, lens = _int_sym_case(gen, D, G, bits)
    q = _rnd(gen, 2, 2 * G, D)
    args = (cache.k_codes, cache.k_scale, cache.v_codes, cache.v_scale,
            *res, *lens)
    form = dict(bits=bits, int_dots=False, k_transposed=False)
    fn = ikv.int_kv_decode_attention
    got = _launches(fn, lambda: fn(q, *args, **form))
    want = ikv.int_kv_decode_plain(q, *args, scale=D ** -0.5, **form)
    atol = 2e-3 if bits == 4 else 4e-3
    assert torch.allclose(got.float(), want.float(), atol=atol, rtol=2e-2)
    if G > 1:
        faulted = _head_map_fault(ikv.int_kv_decode_plain, q, *args, G=G,
                                  KV=2, scale=D ** -0.5, **form)
        assert not torch.allclose(got.float(), faulted.float(), atol=atol,
                                  rtol=2e-2)


@pytest.mark.parametrize("D,G", [(d, g) for d in (64, 128)
                                 for g in (1, 2, 4, 8)])
@pytest.mark.parametrize("int_dots,k_transposed",
                         [(True, True), (True, False), (False, True)])
def test_int_kv_tile_gqa_forms(cuda_device, D, G, int_dots, k_transposed):
    """Kernel 7's integer-dot and K^T forms at every instantiated (D, G):
    one launch, within chip_smoke.py's bounds (max error 2e-3, at most 0.5%
    of outputs outside 1e-4 + 1e-3|plain|), and far outside them from a
    kernel whose head h reads kv head h % KV."""
    from quantized_training_torch.ops import int_kv_attention as ikv
    gen = torch.Generator(device=cuda_device).manual_seed(10 * G + D)
    cache, res, lens = _int_sym_case(gen, D, G, 8, P=256)
    kc = (cache.k_codes.transpose(2, 3).contiguous() if k_transposed
          else cache.k_codes)
    q = _rnd(gen, 2, 2 * G, D)
    args = (kc, cache.k_scale, cache.v_codes, cache.v_scale, *res, *lens)
    form = dict(bits=8, int_dots=int_dots, k_transposed=k_transposed)
    fn = ikv.int_kv_decode_attention
    before = fn.tile_launches
    got = fn(q, *args, **form)
    torch.cuda.synchronize()
    assert fn.tile_launches == before + 1

    def outside(want):
        err = (got.float() - want.float()).abs()
        return err, float((err > 1e-4 + 1e-3 * want.float().abs())
                          .float().mean())

    err, share = outside(ikv.int_kv_decode_plain(q, *args, scale=D ** -0.5,
                                                 **form))
    assert float(err.max()) <= 2e-3 and share <= 0.005
    if G > 1:
        assert outside(_head_map_fault(ikv.int_kv_decode_plain, q, *args,
                                       G=G, KV=2, scale=D ** -0.5,
                                       **form))[1] > 0.05


# kernel 7's forms: (bits, int_dots, k_transposed)
INT_KV_FORMS = {"int4": (4, False, False), "int8": (8, False, False),
                "int8_kt": (8, False, True), "int8_int_dots": (8, True, False),
                "int8_int_dots_kt": (8, True, True)}


def _int_kv_within(got, want):
    """chip_smoke.py's INT_KV_* bounds: max error 2e-3, at most 0.5% of the
    outputs outside 1e-4 + 1e-3|plain|."""
    err = (got.float() - want.float()).abs()
    share = float((err > 1e-4 + 1e-3 * want.float().abs()).float().mean())
    return bool(got.float().isfinite().all()) and float(err.max()) <= 2e-3 \
        and share <= 0.005


@pytest.mark.parametrize("D,G", [(d, g) for d in (64, 128)
                                 for g in (1, 2, 4, 8)])
@pytest.mark.parametrize("form", list(INT_KV_FORMS))
def test_int_kv_every_form_and_length(cuda_device, D, G, form):
    """Kernel 7 in every form at every instantiated (D, G), against its
    plain version within chip_smoke.py's bounds, at res_len 0, 1 and R with
    mixed main lengths (1 and P among them, a word row's edge at int4): one
    launch a call, counted in ``launches`` (bf16 dots over untransposed
    codes) or ``tile_launches`` (the others), the same bits from a repeated
    call, and the library's shared memory equal to the plan's formula."""
    from quantized_training_torch.ops import int_kv_attention as ikv
    bits, int_dots, kt = INT_KV_FORMS[form]
    gen = torch.Generator(device=cuda_device).manual_seed(7 * G + D + bits)
    B, KV, P, R = 4, 2, 512, 32
    cache, res, _ = _int_sym_case(gen, D, G, bits, P=P, R=R, B=B, KV=KV)
    kc = cache.k_codes.transpose(2, 3).contiguous() if kt else cache.k_codes
    q = _rnd(gen, B, KV * G, D)
    args = (q, kc, cache.k_scale, cache.v_codes, cache.v_scale, *res)
    kw = dict(bits=bits, int_dots=int_dots, k_transposed=kt)
    fn = ikv.int_kv_decode_attention
    counter = "tile_launches" if int_dots or kt else "launches"
    i32 = dict(dtype=torch.int32, device=cuda_device)
    for rl_val in (0, 1, R):
        ml = torch.tensor([1, P, 300, 257], **i32)
        rl = torch.full((B,), rl_val, **i32)
        before = getattr(fn, counter)
        got = fn(*args, ml, rl, **kw)
        torch.cuda.synchronize()
        assert getattr(fn, counter) == before + 1
        want = ikv.int_kv_decode_plain(*args, ml, rl, scale=D ** -0.5, **kw)
        assert _int_kv_within(got, want), (form, rl_val)
        assert torch.equal(got.view(torch.int16),
                           fn(*args, ml, rl, **kw).view(torch.int16))
    fid = ikv._form(bits, int_dots, kt)
    for splits in (1, 2, 8):
        assert ikv._lib().int_kv_decode_smem(B, KV * G, KV, D, P, R, fid,
                                             splits) == \
            ikv.int_kv_decode_smem(fid, D, G, P, R, splits)


@pytest.mark.parametrize("form", ["int8_int_dots_kt", "int4"])
def test_int_kv_past_the_old_whole_tile_limit(cuda_device, form):
    """G = 8, D = 128, P + R = 8320: beyond the 6079 the whole-tile kernel
    kept in one block's shared memory, now split over a cluster, within
    chip_smoke.py's bounds."""
    from quantized_training_torch.ops import int_kv_attention as ikv
    bits, int_dots, kt = INT_KV_FORMS[form]
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    B, KV, G, D, P, R = 1, 2, 8, 128, 8192, 128
    cache, res, _ = _int_sym_case(gen, D, G, bits, P=P, R=R, B=B, KV=KV)
    kc = cache.k_codes.transpose(2, 3).contiguous() if kt else cache.k_codes
    args = (_rnd(gen, B, KV * G, D), kc, cache.k_scale, cache.v_codes,
            cache.v_scale, *res)
    lens = (torch.tensor([P - 3], dtype=torch.int32, device=cuda_device),
            torch.tensor([R], dtype=torch.int32, device=cuda_device))
    kw = dict(bits=bits, int_dots=int_dots, k_transposed=kt)
    got = ikv.int_kv_decode_attention(*args, *lens, **kw)
    want = ikv.int_kv_decode_plain(*args, *lens, scale=D ** -0.5, **kw)
    assert _int_kv_within(got, want)


@pytest.mark.parametrize("D,G", [(d, g) for d in (64, 128)
                                 for g in (1, 2, 4, 8)])
@pytest.mark.parametrize("bits", [2, 4, None])
def test_kivi_decode_gqa_forms(cuda_device, D, G, bits):
    """The KIVI decode at every instantiated (D, G) and cache form: one
    launch, within 2e-2 + 2e-2*|plain| of its plain version, and outside
    it from a kernel whose head h reads kv head h % KV."""
    gen = torch.Generator(device=cuda_device).manual_seed(10 * G + D)
    B, KV, P, R = 2, 2, 256, 8
    spec = "uint{},qs=group_wise_affine,bs=32,ax={}"
    nb = bits or 2
    cfg = kvc.KVCacheConfig.kivi(P, R, spec.format(nb, -2),
                                 spec.format(nb, -1), bits is not None)
    cache = kvc.prefill_cache(kvc.init_cache(cfg, B, KV, D,
                                             device=cuda_device),
                              cfg, _rnd(gen, B, P, KV, D),
                              _rnd(gen, B, P, KV, D), length=200)
    lens = (torch.tensor([200, 77], dtype=torch.int32, device=cuda_device),
            torch.tensor([3, R], dtype=torch.int32, device=cuda_device))
    q = _rnd(gen, B, KV * G, D)
    args = (*cache[:6], _rnd(gen, B, KV, R, D), _rnd(gen, B, KV, R, D),
            *lens)
    kw = dict(bits_k=bits, bits_v=bits)
    fn = kivi_attention.kivi_decode_attention
    got = _launches(fn, lambda: fn(q, *args, **kw))
    want = kivi_attention.kivi_decode_plain(q, *args, scale=D ** -0.5, **kw)
    assert torch.allclose(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(got.view(torch.int16), fn(q, *args, **kw).view(
        torch.int16))
    if G > 1:
        faulted = _head_map_fault(kivi_attention.kivi_decode_plain, q, *args,
                                  G=G, KV=KV, scale=D ** -0.5, **kw)
        assert not torch.allclose(got.float(), faulted.float(), atol=2e-2,
                                  rtol=2e-2)


def test_decode_kernels_refuse_uninstantiated_forms(cuda_device):
    """A (D, G) no kernel is built for raises before any launch, as does a
    cache whose scores exceed a block's shared memory at 8 blocks a pair
    (P = 65536 at G = 8, D = 128); none falls back to a plain version."""
    from quantized_training_torch.ops import int_kv_attention as ikv
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    B, KV, R = 1, 2, 8
    for D, G, P in ((96, 1, 64), (128, 3, 64), (128, 16, 64),
                    (128, 8, 65536)):
        cfg = kvc.KVCacheConfig.int_sym(P, R, 8)
        c = kvc.init_cache(cfg, B, KV, D, device=cuda_device)
        lens = torch.ones((B,), dtype=torch.int32, device=cuda_device)
        q = _rnd(gen, B, KV * G, D)
        kT = c.k_codes.transpose(2, 3).contiguous()
        with pytest.raises(ValueError):
            ikv.int_kv_decode_attention(q, kT, c.k_scale, c.v_codes,
                                        c.v_scale, c.k_res.bfloat16(),
                                        c.v_res.bfloat16(), lens, lens)
        if P == 65536:
            continue
        spec = "uint2,qs=group_wise_affine,bs=32,ax={}"
        kcfg = kvc.KVCacheConfig.kivi(P, R, spec.format(-2), spec.format(-1),
                                      True)
        k = kvc.init_cache(kcfg, B, KV, D, device=cuda_device)
        with pytest.raises(ValueError):
            kivi_attention.kivi_decode_attention(
                q, *k[:6], k.k_res.bfloat16(), k.v_res.bfloat16(), lens,
                lens, bits_k=2, bits_v=2)


# ---- the flash forward (kernel 1) on the tensor cores, every form ----------
# Bounds (atol, rtol) are chip_smoke.py's for each form: the single pass
# rounds p to bf16 before the running rescale (4e-3 + 0.02|plain|); the
# two-pass form's p = exp(s - lse) lands a posit step away wherever a score
# is an ulp off at a rounding boundary, and the plain version's f32 GEMM
# scores are ulps off the exact dot themselves, so 6e-3 + 0.02|exact| is
# held against the exact reference below and the plain version is a floor
# reading (every output within 3e-2 + 0.02|plain|, at most 1e-5 of them
# outside 6e-3 + 0.02|plain|); the training form's lse (1e-5) and o_unq
# (2e-3) sum in other orders, and its o is the inference form's bit for bit.
_FWD_SHAPES = [(200, 200, 0), (128, 640, 512)]       # (S, T, q_offset)


def _exact_two_pass(q, k, v, scale, q_offset, p_qfn):
    """The two-pass form at the TPU kernel's rounding points with no
    summation error of its own (chip_smoke.py's exact_two_pass, causal at
    q_offset): each score the exact dot rounded once to f32 and scaled in
    f32, the logsumexp in float64, p = exp(s - lse) to f32, bf16 and
    ``p_qfn``, round(p) @ v in float64 rounded to bf16."""
    H, S, T = q.shape[1], q.shape[2], k.shape[2]
    k, v = (t.repeat_interleave(H // t.shape[1], 1) for t in (k, v))
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)).float() * scale
    seen = (torch.arange(T, device=q.device)[None, :]
            <= torch.arange(S, device=q.device)[:, None] + q_offset)
    s = torch.where(seen, s, torch.full_like(s, fa.NEG_INF)).double()
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True)).float()
    pr = p_qfn.plain(p.to(torch.bfloat16)).double()
    return torch.matmul(pr, v.double()).to(torch.bfloat16)


@pytest.mark.parametrize("form", ["single", "single_lse", "two_pass",
                                  "two_pass_lse"])
@pytest.mark.parametrize("KV", [8, 2], ids=["mha", "gqa4"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S,T,q_offset", _FWD_SHAPES,
                         ids=["ragged", "offset"])
def test_flash_forward_forms_match_plain(cuda_device, form, KV, D, S, T,
                                         q_offset):
    from quantized_training_torch.numerics import quantize_fn_unit
    from quantized_training_torch.ops import quantize_elemwise as qe
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    B, H = 2, 8
    q = _rnd(gen, B, H, S, D)
    k, v = _rnd(gen, B, KV, T, D), _rnd(gen, B, KV, T, D)
    scale = D ** -0.5
    hooks = dict(scale=scale, q_offset=q_offset)
    if form.startswith("two_pass"):
        hooks["p_qfn"] = quantize_fn_unit("posit8_1")
    counter = "launches" if form.startswith("single") else "two_pass_launches"
    before = (getattr(fa.flash_attention, counter),
              fa.flash_attention.lse_launches)
    save = form.endswith("_lse")
    if save:
        o, lse, o_unq = fa.flash_forward_train(q, k, v, **hooks)
    else:
        o = fa.flash_attention(q, k, v, **hooks)
    torch.cuda.synchronize()
    assert (getattr(fa.flash_attention, counter) - before[0],
            fa.flash_attention.lse_launches - before[1]) == (1, int(save))
    o_p, lse_p, o_unq_p = fa.attention_forward_plain(q, k, v, **hooks)
    assert torch.isfinite(o.float()).all()
    if form.startswith("two_pass"):
        exact = _exact_two_pass(q, k, v, scale, q_offset, hooks["p_qfn"])
        torch.testing.assert_close(o.float(), exact.float(), atol=6e-3,
                                   rtol=2e-2)
        err = (o.float() - o_p.float()).abs()
        assert (err <= 3e-2 + 2e-2 * o_p.float().abs()).all()
        assert (err > 6e-3 + 2e-2 * o_p.float().abs()).float().mean() <= 1e-5
    else:
        torch.testing.assert_close(o.float(), o_p.float(), atol=4e-3,
                                   rtol=2e-2)
    if save:
        torch.testing.assert_close(lse, lse_p, atol=1e-5, rtol=0.0)
    if form == "single_lse":
        assert o_unq is o
    if form == "two_pass_lse":
        torch.testing.assert_close(o_unq.float(), o_unq_p.float(), atol=2e-3,
                                   rtol=2e-2)
        assert torch.equal(o, fa.flash_attention(q, k, v, **hooks))
    if form == "two_pass":
        p8 = quantize_fn("posit8_1")
        assert torch.equal(fa.flash_attention(q, k, v, out_qfn=p8, **hooks),
                           qe.quantize_elemwise(o, p8.fmt))


def test_flash_forward_refuses_other_head_dims(cuda_device):
    """A head dim the kernel does not take raises in the wrapper before any
    launch."""
    q = torch.zeros((1, 2, 64, 96), device=cuda_device, dtype=torch.bfloat16)
    before = (fa.flash_attention.launches, fa.flash_attention.two_pass_launches)
    with pytest.raises(ValueError, match="D must be 64 or 128"):
        fa.flash_attention(q, q, q)
    assert (fa.flash_attention.launches,
            fa.flash_attention.two_pass_launches) == before


# The backward kernels' bounds are chip_smoke.py's (atol, rtol), from shared
# inputs (the plain lse, o_unq and di feed both sides): di sums p * err(dp)
# in another order; dq and dk_h are bf16 outputs of f32 sums in other
# orders; dv_h's operand is round(bf16(p)), where a p at a format boundary
# may land one step away, and without a p format bf16(p) against the plain
# version's f32 p.  Under the error tap a dp at a bf16 rounding midpoint
# lands a posit step away wherever a dot's last f32 bit differs, and the
# plain version's f32 GEMM sums differ from the exact dot there: so the
# bounds are held against a float64 reference at the kernels' rounding
# points (_exact_bwd, chip_smoke.py's exact_bwd), and the plain version is
# a floor reading (every output within the floor atol, at most the floor
# share outside the bound).
_BWD_TOL = {"di": (2e-5, 1e-4), "dq": (2e-3, 2e-2), "dk": (2e-3, 2e-2),
            "dv": (1.5e-2, 2e-2)}
_BWD_FLOOR = {"di": (5e-2, 2e-3), "dq": (3e-2, 5e-5), "dk": (3e-2, 5e-5),
              "dv": (3e-2, 1e-5)}


def _exact_bwd(q, k, v, do, lse, di, scale, q_offset, p_qfn, err_qfn):
    """(di, dq, dk_h, dv_h) at the kernels' rounding points with exact
    (float64) dots, each rounded once to f32, and float64 products
    (chip_smoke.py's exact_bwd)."""
    bf16, f32, f64 = torch.bfloat16, torch.float32, torch.float64
    H, S, T = q.shape[1], q.shape[2], k.shape[2]
    k, v = (t.repeat_interleave(H // t.shape[1], 1) for t in (k, v))
    s = torch.matmul(q.to(f64), k.to(f64).transpose(-1, -2)).to(f32)
    seen = (torch.arange(T, device=q.device)[None, :]
            <= torch.arange(S, device=q.device)[:, None] + q_offset)
    p = torch.where(seen, torch.exp(s * scale - lse[..., None]),
                    torch.zeros((), dtype=f32, device=q.device))
    dp = torch.matmul(do.to(f64), v.to(f64).transpose(-1, -2)).to(f32)
    dp = err_qfn.plain(dp.to(bf16)).to(f32)
    di_x = torch.sum(p.to(f64) * dp.to(f64), dim=-1).to(f32)
    ds = (p * (dp - di[..., None]) * scale).to(bf16).to(f64)
    pv = p.to(bf16) if p_qfn is None else p_qfn.plain(p.to(bf16))
    return (di_x, torch.matmul(ds, k.to(f64)).to(bf16),
            torch.matmul(ds.transpose(-1, -2), q.to(f64)).to(bf16),
            torch.matmul(pv.to(f64).transpose(-1, -2), do.to(f64)).to(bf16))


def _outside(got, want, atol, rtol):
    """(max |got - want|, outputs outside atol + rtol|want|, NaN counted)."""
    w = want.float()
    err = (got.float() - w).abs()
    return float(err.max()), int((~(err <= atol + rtol * w.abs())).sum())


@pytest.mark.parametrize("form", ["no_hooks", "err", "p_err"])
@pytest.mark.parametrize("KV", [8, 2], ids=["mha", "gqa4"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S,T,q_offset", _FWD_SHAPES,
                         ids=["ragged", "offset"])
def test_flash_backward_forms_match_plain(cuda_device, form, KV, D, S, T,
                                          q_offset):
    """Kernels 2-4 in every form they serve (no hooks; err_qfn; p_qfn with
    err_qfn), at D 64 and 128, GQA groups 1 and 4, a ragged S and a
    q_offset with T > S: each launches, holds its bound (against the exact
    reference under the error tap, with the plain version a floor reading)
    and repeats bit for bit."""
    from quantized_training_torch.numerics import quantize_fn_unit
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    B, H = 2, 8
    q, do = _rnd(gen, B, H, S, D), _rnd(gen, B, H, S, D)
    k, v = _rnd(gen, B, KV, T, D), _rnd(gen, B, KV, T, D)
    scale = D ** -0.5
    p_qfn = quantize_fn_unit("posit8_1") if form == "p_err" else None
    err_qfn = None if form == "no_hooks" else quantize_fn("posit8_1")
    _, lse, o_unq = fa.attention_forward_plain(q, k, v, scale=scale,
                                               q_offset=q_offset, p_qfn=p_qfn)
    kw = dict(scale=scale, q_offset=q_offset, err_qfn=err_qfn)
    if err_qfn is None:
        di_p = torch.sum(do.float() * o_unq.float(), dim=-1)
    else:
        di_p = fa.flash_bwd_di_plain(q, k, v, do, lse, **kw)
    counters = (fa.flash_bwd_di, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [fn.launches for fn in counters]
    runs = []
    for _ in range(2):
        di = fa.flash_bwd_di(q, k, v, do, lse, **kw) if err_qfn else None
        dq = fa.flash_bwd_dq(q, k, v, do, lse, di_p, **kw)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, di_p, p_qfn=p_qfn, **kw)
        runs.append({"di": di, "dq": dq, "dk": dk, "dv": dv})
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == [
        2 if err_qfn else 0, 2, 2]
    plain = {"di": di_p, "dq": fa.flash_bwd_dq_plain(q, k, v, do, lse, di_p,
                                                     **kw)}
    plain["dk"], plain["dv"] = fa.flash_bwd_dkv_plain(q, k, v, do, lse, di_p,
                                                      p_qfn=p_qfn, **kw)
    exact = None if err_qfn is None else dict(zip(
        ("di", "dq", "dk", "dv"),
        _exact_bwd(q, k, v, do, lse, di_p, scale, q_offset, p_qfn, err_qfn)))
    bad = []
    for name, got in runs[0].items():
        if got is None:
            continue
        atol, rtol = _BWD_TOL[name]
        if exact is None:
            err, out = _outside(got, plain[name], atol, rtol)
            if out:
                bad.append(f"{name}: {err:.3g}, {out} outside the bound")
        else:
            err, out = _outside(got, exact[name], atol, rtol)
            if out:
                bad.append(f"{name}: {err:.3g} from the exact reference, "
                           f"{out} outside the bound")
            floor_atol, cap = _BWD_FLOOR[name]
            err, far = _outside(got, plain[name], floor_atol, rtol)
            _, out = _outside(got, plain[name], atol, rtol)
            if far or out > cap * got.numel():
                bad.append(f"{name}: {err:.3g} from the plain version, "
                           f"{out} outside the bound")
        if not torch.equal(got, runs[1][name]):
            bad.append(f"{name} did not repeat")
    assert not bad, bad


def _speculative_models(cache):
    """A small w4a16 LLaMA (hidden 256, D 128, GQA 2, fused qkv, flash
    prefill) on a packed uint2 KIVI or int4 cache of P 128, R 24: the
    target on the naive decode, the target on its fused decode, and the
    target's weights on the full-precision ring (a self draft)."""
    from dataclasses import replace
    import quantized_training_torch as qt
    spec = "uint2,qs=group_wise_affine,bs=32,ax={}"
    kcfg = (kvc.KVCacheConfig.kivi(128, 24, spec.format(-2), spec.format(-1),
                                   pack=True) if cache == "kivi2"
            else kvc.KVCacheConfig.int_sym(128, 24, 4))
    cfg = qt.LlamaConfig(vocab_size=512, hidden_size=256,
                         intermediate_size=512, num_hidden_layers=2,
                         num_attention_heads=2, num_key_value_heads=1,
                         max_position_embeddings=160, kv_cache=kcfg,
                         fused_qkv=True, use_flash_attention=True,
                         use_fused_kivi=False)
    qc = qt.QuantConfig().with_storage("w4a16", 64)
    weights = qt.random_params(cfg, "w4a16", 64, seed=0, device="cuda")

    def build(c):
        model = qt.LlamaForCausalLM(c, qc, device="meta")
        model.load_state_dict(weights, assign=True)
        return model
    return (build(cfg), build(replace(cfg, use_fused_kivi=True)),
            build(replace(cfg, kv_cache=None)))


@pytest.mark.parametrize("cache", ["kivi2", "int4"])
def test_greedy_speculative_decoding_through_the_kernels(cuda_device, cache):
    """Greedy speculative decoding with a self draft gives the naive
    target alone's tokens (up to a step whose top-two logit gap is a near
    tie) and accepts draft tokens; its verify blocks launch kernel 5 at
    M = k + 1 and never the fused decode, which the target alone with its
    fused decode launches once a layer a step."""
    import quantized_training_torch as qt
    from quantized_training_torch.ops import int_kv_attention
    naive, fused, draft = _speculative_models(cache)
    decode = (kivi_attention.kivi_decode_attention if cache == "kivi2"
              else int_kv_attention.int_kv_decode_attention)
    ids = torch.randint(0, 512, (1, 128),
                        generator=torch.Generator().manual_seed(1)).cuda()
    k, n = 3, 16
    gaps = []
    hook = naive.register_forward_hook(
        lambda mod, args, out: gaps.append(
            float(out[0][0, -1].float().topk(2).values.diff().abs())))
    with torch.no_grad():
        want = qt.generate(naive, ids, n)
    hook.remove()
    verify = (k + 1, 256, 512)
    before = (aff.affine_matmul.shape_launches[verify], decode.launches)
    got, stats = qt.speculative_generate(fused, draft, ids, n, k=k,
                                         return_stats=True)
    torch.cuda.synchronize()
    assert aff.affine_matmul.shape_launches[verify] > before[0]
    assert decode.launches == before[1]
    assert stats["accept_rate"] > 0
    g, w = got[0, 128:].tolist(), want[0, 128:].tolist()
    part = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
    assert part is None or gaps[part] < 0.1, (part, gaps[part], g, w)
    with torch.no_grad():
        qt.generate(fused, ids, n)
    torch.cuda.synchronize()
    assert decode.launches - before[1] == 2 * (n - 1)
