#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py        # one card

Phases, each of which exits non-zero on failure:
  1. build the hand-written kernels from quantized_training_torch/csrc
     (one nvcc per source, all started together);
  2. hold each kernel against its plain PyTorch version on the card, at the
     main paths' shapes and at the edges, beside a stated tolerance, and
     show that the tolerance is tight: a planted fault (the plain output of
     a kernel that drops one K group, one key tile or one split's values,
     or leaves one tile unrounded) must breach it.  The elementwise rounding
     kernel must be bit-equal to its plain version over every bf16 pattern,
     2^20 random f32 patterns and the main path's tensor shapes, for six
     formats;
  3. time each kernel, its plain version and one PyTorch library call that
     computes the same function (a yardstick only: the port never calls
     it), beside the least time the card could take (``bound_ms``);
  4. a 2-layer LLaMA-2 7B-width model: the kernel path's logits against the
     plain path's (the same model on the CPU);
  5. the posit8 fusion ladder of bench.py: a 2-layer model at its width,
     kernel path against plain path at residual_fusion (each side also run
     again on the same input, with a digest of its logits); then the full
     configuration (8 layers, batch 4 x 1024, weights folded offline):
     forward tokens/s at every FUSION_LADDER rung and in bf16, peak memory,
     and the launch counters read around one residual_fusion forward;
  6. serve at full LLaMA-2 7B width (random seeded weights, w4a16 group 64,
     int4 cache P=2048 R=128, fused qkv, 8 slots): ~16 greedy requests
     through ContinuousBatchingEngine, with every kernel's launch counter
     read around that run.

The last two lines of output are the kernel table as one JSON object and
``{"ok": true, "device": {...}}``.
"""

import hashlib
import json
import math
import platform
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak

SEED = 0


def log(*args):
    print(*args, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = nops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Timer:
    """Median device time of one call, with the 50 MB L2 cache flushed
    before each launch (the serving path finds weights and caches cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps=15):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in pairs)
        return times[len(times) // 2]


def check_close(name, got, want, atol, rtol):
    """Max |got - want| and whether every element is finite and within
    atol + rtol*|want|.  Also prints the least atol that would pass at this
    rtol, the reading the atol is set from, and where it is needed."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(g.isfinite().all()) and bool((err <= atol + rtol * w.abs()).all())
    max_err = float(err.max())
    excess = err - rtol * w.abs()
    need = max(float(excess.max()), 0.0)
    at = [int(i) for i in torch.unravel_index(excess.argmax(), err.shape)]
    log(f"  {name}: max_abs_err {max_err:.6g}, atol needed {need:.3g} at "
        f"{at} (tolerance {atol} + {rtol}*|plain|) "
        f"{'ok' if ok else 'BREACH'}")
    return ok, max_err


def planted_fault(name, got, faulted, atol, rtol, failures):
    """The kernel's output against the plain output of a faulty kernel must
    breach the tolerance, or the tolerance could not catch that fault."""
    ok, _ = check_close(f"planted fault, {name}", got, faulted, atol, rtol)
    if ok:
        failures.append(f"tolerance misses the planted fault: {name}")


# ---------------------------------------------------------------- kernels
def kernel_phases(torch, timer):
    from quantized_training_torch.ops import affine_storage as aff
    from quantized_training_torch.ops import flash_attention as fa
    from quantized_training_torch.ops import int_kv_attention as ikv
    from quantized_training_torch.serving import kv_cache as kvc

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"
    bf16 = torch.bfloat16
    rows = {}
    failures = []

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # ---- w4 storage GEMM -----------------------------------------------
    # The kernel and the plain version multiply the same bf16 weights: f32
    # sums in another order and one bf16 rounding of the output (2^-8
    # relative) differ.  On the H100 no case needed an atol above 1.4e-6.
    atol, rtol = 1e-4, 1e-2
    log(f"phase 2/3: affine_w4_matmul (tolerance {atol} + {rtol}*|plain|)")
    packs = {}

    def packed(K, N):
        if (K, N) not in packs:
            w = randn(K, N, scale=1.0 / math.sqrt(K))
            packs[(K, N)] = aff.pack_affine_weights(w, 4, 64)
        return packs[(K, N)]

    max_err = 0.0
    cases = [(8, 4096, 12288), (8, 4096, 4096), (8, 4096, 11008),
             (8, 11008, 4096), (8, 4096, 32000), (8, 11008, 32000),
             (1, 4096, 4096), (5, 11008, 4096), (67, 4096, 12288),
             (512, 4096, 12288), (2048, 11008, 4096), (2048, 4096, 32000)]
    for M, K, N in cases:
        codes, sf, zp = packed(K, N)
        x = randn(M, K, dtype=bf16)
        got = aff.affine_matmul(x, codes, sf, zp, nbits=4, group_size=64)
        want = aff.affine_matmul_plain(x, codes, sf, zp, nbits=4,
                                       group_size=64)
        torch.cuda.synchronize()
        ok, err = check_close(f"M={M} K={K} N={N}", got, want, atol, rtol)
        max_err = max(max_err, err)
        if not ok:
            failures.append(f"affine_w4_matmul M={M} K={K} N={N}")
        if (M, K, N) == (8, 11008, 4096):
            x_f = x.clone()
            x_f[:, 64 * 100:64 * 101] = 0          # K group 100 skipped
            planted_fault("down_proj, one K group skipped", got,
                          aff.affine_matmul_plain(x_f, codes, sf, zp, nbits=4,
                                                  group_size=64),
                          atol, rtol, failures)

    def affine_row(M, K, N):
        codes, sf, zp = packed(K, N)
        x = randn(M, K, dtype=bf16)
        w_bf16 = aff._dequant_planes(codes, sf, zp, 4, 64).to(bf16)
        ms = timer(lambda: aff.affine_matmul(x, codes, sf, zp, nbits=4,
                                             group_size=64))
        plain = timer(lambda: aff.affine_matmul_plain(x, codes, sf, zp,
                                                      nbits=4, group_size=64))
        lib = timer(lambda: torch.matmul(x, w_bf16))
        nbytes = K * N // 2 + 2 * (K // 64) * N * 4 + M * K * 2 + M * N * 2
        b, by = bound_ms(nbytes, 2 * M * K * N)
        log(f"  time M={M} K={K} N={N}: kernel_ms {ms:.4f} plain_ms "
            f"{plain:.4f} library_ms {lib:.4f} bound_ms {b:.4f} ({by})")
        return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                    bound_by=by)

    for M, K, N in [(8, 4096, 4096), (8, 4096, 11008), (8, 11008, 4096),
                    (8, 4096, 32000), (2048, 4096, 12288),
                    (2048, 11008, 4096)]:
        affine_row(M, K, N)
    rows["affine_w4_matmul"] = dict(
        name="affine_w4_matmul", route="cuda",
        source="quantized_training_torch/csrc/affine_w4_matmul.cu",
        replaces="quantized_training_tpu/ops/pallas/affine_storage.py:255",
        max_abs_err=max_err, shape="decode qkv M=8 K=4096 N=12288",
        **affine_row(8, 4096, 12288))
    packs.clear()

    # ---- flash prefill ---------------------------------------------------
    # The kernel rounds p to bf16 before the running rescale, the plain
    # version after the softmax.  That 2^-9 relative error of each p does
    # not cancel in the first rows, where a few keys carry all the weight
    # and |out| can be near 0 while |v| is up to ~3: on the H100 those rows
    # needed an atol of up to 3.5e-3.  Rows past a few hundred keys have
    # |out| ~ 0.03, so the planted faults below show what this atol catches.
    atol, rtol = 4e-3, 2e-2
    log(f"phase 2/3: flash_attn_fwd (tolerance {atol} + {rtol}*|plain|)")
    max_err = 0.0
    for B, H, KV, S, T, D, off in [(1, 32, 32, 512, 512, 128, 0),
                                   (1, 32, 32, 2048, 2048, 128, 0),
                                   (1, 32, 32, 128, 640, 128, 512),
                                   (2, 4, 2, 200, 200, 128, 0),
                                   (1, 4, 4, 96, 160, 64, 64)]:
        q = randn(B, H, S, D, dtype=bf16)
        k = randn(B, KV, T, D, dtype=bf16)
        v = randn(B, KV, T, D, dtype=bf16)
        got = fa.flash_attention(q, k, v, q_offset=off)
        want = fa.naive_attention(q, k, v, scale=1 / math.sqrt(D),
                                  q_offset=off)
        torch.cuda.synchronize()
        ok, err = check_close(
            f"B={B} H={H} KV={KV} S={S} T={T} D={D} q_offset={off}",
            got, want, atol, rtol)
        max_err = max(max_err, err)
        if not ok:
            failures.append(f"flash_attn_fwd S={S} T={T} off={off}")
        # Rows row0.. skip the key tile [j0, j0 + 32): the plain attention
        # of those rows over the keys without that tile, positions shifted
        # by its 32 keys.
        for row0, j0 in ([(1024, 512), (1984, 0)] if S == 2048 else []):
            keep = torch.cat([torch.arange(j0, device=dev),
                              torch.arange(j0 + 32, T, device=dev)])
            faulted = want.clone()
            faulted[:, :, row0:] = fa.naive_attention(
                q[:, :, row0:], k[:, :, keep], v[:, :, keep],
                scale=1 / math.sqrt(D), q_offset=row0 - 32)
            planted_fault(f"S=2048, rows {row0}.. skip keys {j0}..{j0 + 31}",
                          got, faulted, atol, rtol, failures)

    def flash_row(S, H=32, D=128):
        q, k, v = (randn(1, H, S, D, dtype=bf16) for _ in range(3))
        ms = timer(lambda: fa.flash_attention(q, k, v))
        plain = timer(lambda: fa.naive_attention(q, k, v,
                                                 scale=1 / math.sqrt(D)))
        lib = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True))
        b, by = bound_ms(4 * H * S * D * 2, 4 * S * S * D * H / 2)
        log(f"  time S={S}: kernel_ms {ms:.4f} plain_ms {plain:.4f} "
            f"library_ms {lib:.4f} bound_ms {b:.4f} ({by})")
        return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                    bound_by=by)

    flash_row(512)
    rows["flash_attn_fwd"] = dict(
        name="flash_attn_fwd", route="cuda",
        source="quantized_training_torch/csrc/flash_attn_fwd.cu",
        replaces="quantized_training_tpu/ops/pallas/flash_attention.py:66",
        max_abs_err=max_err, shape="prefill B=1 H=32 S=2048 D=128",
        **flash_row(2048))

    # ---- int4 decode attention -------------------------------------------
    # The kernel rounds p*vs to bf16 against each split's own max, the
    # plain version against the global max; a full slot has |out| ~ 0.02.
    atol, rtol = 2e-3, 2e-2
    log(f"phase 2/3: int_kv_decode (tolerance {atol} + {rtol}*|plain|)")
    B, H, KV, D, P, R = 8, 32, 32, 128, 2048, 128
    kcfg = kvc.KVCacheConfig.int_sym(P, R, 4)
    k = randn(B, P, KV, D, dtype=bf16)
    v = randn(B, P, KV, D, dtype=bf16)
    cache = kvc.prefill_cache(kvc.init_cache(kcfg, B, KV, D, device=dev),
                              kcfg, k, v)
    del k, v
    k_res = randn(B, KV, R, D, dtype=bf16)
    v_res = randn(B, KV, R, D, dtype=bf16)
    q = randn(B, H, D, dtype=bf16)
    ml_mix = torch.tensor([2048, 1500, 700, 64, 1, 2047, 1024, 333],
                          dtype=torch.int32, device=dev)
    args = (cache.k_codes, cache.k_scale, cache.v_codes, cache.v_scale,
            k_res, v_res)
    max_err = 0.0
    for ml, rl_val in [(ml_mix, 0), (ml_mix, 1), (ml_mix, 128),
                       (torch.full((B,), P, dtype=torch.int32, device=dev),
                        64)]:
        rl = torch.full((B,), rl_val, dtype=torch.int32, device=dev)
        got = ikv.int_kv_decode_attention(q, *args, ml, rl)
        want = ikv.int_kv_decode_plain(q, *args, ml, rl,
                                       scale=1 / math.sqrt(D))
        torch.cuda.synchronize()
        ok, err = check_close(f"main_len={ml.tolist()} res_len={rl_val}",
                              got, want, atol, rtol)
        max_err = max(max_err, err)
        if not ok:
            failures.append(f"int_kv_decode res_len={rl_val}")

    # Planted faults at main_len=P: split 3 (word rows 96..127, i.e. tokens
    # s*P/8 + 96..127 for each plane s) reads the v scale of the next
    # token, or loses its values altogether.
    ml = torch.full((B,), P, dtype=torch.int32, device=dev)
    rl = torch.full((B,), 64, dtype=torch.int32, device=dev)
    got = ikv.int_kv_decode_attention(q, *args, ml, rl)
    toks = (torch.arange(8, device=dev)[:, None] * (P // 8)
            + torch.arange(96, 128, device=dev)).flatten()
    for fault in ("reads the next token's v scale", "loses its values"):
        vs_f = cache.v_scale.clone()
        vs_f[..., toks] = (cache.v_scale[..., toks + 1]
                           if fault.startswith("reads") else 0.0)
        faulted = ikv.int_kv_decode_plain(
            q, cache.k_codes, cache.k_scale, cache.v_codes, vs_f, k_res,
            v_res, ml, rl, scale=1 / math.sqrt(D))
        planted_fault(f"main_len={P} res_len=64, split 3 {fault}", got,
                      faulted, atol, rtol, failures)

    rl = torch.full((B,), R, dtype=torch.int32, device=dev)
    ms = timer(lambda: ikv.int_kv_decode_attention(q, *args, ml, rl))
    plain = timer(lambda: ikv.int_kv_decode_plain(q, *args, ml, rl,
                                                  scale=1 / math.sqrt(D)))
    kd, vd = kvc.cache_kv(cache._replace(k_res=k_res, v_res=v_res), kcfg)
    kd, vd = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
    mask = torch.ones((B, 1, 1, P + R), dtype=torch.bool, device=dev)
    q4 = q[:, :, None, :]
    lib = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask))
    # bytes this run's data needs: word rows below main_len, the scales of
    # valid tokens, valid residual rows, q and out
    n_tok = int(ml.sum())
    n_rows = int(torch.clamp(ml, max=P // 8).sum())
    n_res = int(rl.sum())
    nbytes = (2 * KV * n_rows * D * 4 + 2 * KV * n_tok * 4
              + 2 * KV * n_res * D * 2 + 2 * B * H * D * 2 + 2 * B * 4)
    b, by = bound_ms(nbytes, 4 * H * (n_tok + n_res) * D)
    log(f"  time B={B} main_len={P} res_len={R}: kernel_ms {ms:.4f} "
        f"plain_ms {plain:.4f} library_ms {lib:.4f} bound_ms {b:.4f} ({by})")
    rows["int_kv_decode"] = dict(
        name="int_kv_decode", route="cuda",
        source="quantized_training_torch/csrc/int_kv_decode.cu",
        replaces="quantized_training_tpu/ops/pallas/int_kv_attention.py:77",
        max_abs_err=max_err, shape="decode B=8 H=KV=32 D=128 P=2048 R=128 full",
        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by)
    if failures:
        fail("kernel disagrees with its plain version: " + ", ".join(failures))
    return rows


def bit_mismatches(got, want):
    """Lanes whose bits differ, NaN lanes counting as equal to each other:
    (count, first few flat indices)."""
    import torch
    itype = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    both_nan = torch.isnan(got.float()) & torch.isnan(want.float())
    bad = (got.view(itype) != want.view(itype)) & ~both_nan
    idx = torch.nonzero(bad.flatten()).flatten()
    return int(idx.numel()), idx[:4].tolist()


def rounding_kernel_phases(torch, timer):
    """Slice 2's kernels: the elementwise rounding, the two-pass flash
    forward with its output epilogue, and the fused quantize-matmul."""
    from quantized_training_torch.numerics import quantize_fn, quantize_fn_unit
    from quantized_training_torch.ops import flash_attention as fa
    from quantized_training_torch.ops import quantize_elemwise as qe
    from quantized_training_torch.ops import quantized_matmul as qmm

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"
    bf16 = torch.bfloat16
    rows = {}
    failures = []

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # ---- elementwise rounding: exact --------------------------------------
    log("phase 2/3: quantize_elemwise (bit-equal to the plain version; "
        "NaN lanes compared as NaN)")
    universe = torch.arange(2 ** 16, dtype=torch.int32, device=dev).to(
        torch.int16).view(bf16)
    f32_bits = torch.randint(-2 ** 31, 2 ** 31 - 1, (1 << 20,),
                             dtype=torch.int32, device=dev, generator=gen)
    cases = [("all bf16", universe), ("all bf16 but the first (unaligned, "
                                      "ragged)", universe[1:]),
             ("2^20 random f32 patterns", f32_bits.view(torch.float32))]
    for dtype in ("posit8_1", "posit16_1", "e4m3", "e5m2", "fp6_e3m2",
                  "int8"):
        qfn = quantize_fn(dtype)
        for name, x in cases:
            got = qe.quantize_elemwise(x, qfn.fmt)
            want = qe.quantize_elemwise_plain(x, qfn)
            torch.cuda.synchronize()
            n_bad, first = bit_mismatches(got, want)
            cpu_bad, _ = bit_mismatches(want.cpu(),
                                        qe.quantize_elemwise_plain(x.cpu(), qfn))
            log(f"  {dtype}, {name}: {n_bad} lanes differ from the plain "
                f"version{f' (first {first})' if n_bad else ''}; the plain "
                f"version on the card differs from the CPU's in {cpu_bad}")
            if n_bad:
                failures.append(f"quantize_elemwise {dtype} {name}")

    # At the main path's shapes the grid-stride loop (at most 132 * 16
    # blocks of 256 threads) takes several rounds: bench.py's bf16 GEMM
    # inputs and q/k/v, the same with a 2-byte offset (the scalar loop), and
    # an f32 tensor.  Magnitudes spread over 2^-24..2^24 reach every regime.
    def spread(*shape, dtype):
        return (randn(*shape) * torch.exp2(randn(*shape) * 6)).to(dtype)

    down = spread(4096, 5504, dtype=bf16)
    path_cases = [("(4096, 5504) bf16, down_proj input", down),
                  ("(4096, 2048) bf16, q/k/v/o and gate/up input",
                   spread(4096, 2048, dtype=bf16)),
                  ("(4, 16, 1024, 128) bf16, q/k/v before flash",
                   spread(4, 16, 1024, 128, dtype=bf16)),
                  ("(4096, 5504) bf16 less its first element (unaligned)",
                   down.flatten()[1:]),
                  ("(4096, 1024) f32", spread(4096, 1024, dtype=torch.float32))]
    for dtype in ("posit8_1", "posit16_1", "e4m3", "e5m2", "fp6_e3m2",
                  "int8"):
        qfn = quantize_fn(dtype)
        for name, x in path_cases:
            n_bad, first = bit_mismatches(qe.quantize_elemwise(x, qfn.fmt),
                                          qe.quantize_elemwise_plain(x, qfn))
            log(f"  {dtype}, {name}: {n_bad} lanes differ from the plain "
                f"version{f' (first {first})' if n_bad else ''}")
            if n_bad:
                failures.append(f"quantize_elemwise {dtype} {name}")
    del path_cases

    p8 = quantize_fn("posit8_1")
    M, N = 4096, 5504
    x = down
    ms = timer(lambda: qe.quantize_elemwise(x, p8.fmt))
    plain = timer(lambda: qe.quantize_elemwise_plain(x, p8))
    lib = timer(lambda: x.to(torch.float8_e4m3fn).to(bf16))
    b, by = bound_ms(2 * x.numel() * 2, 0)
    log(f"  time posit8_1 ({M}, {N}) bf16: kernel_ms {ms:.4f} plain_ms "
        f"{plain:.4f} library_ms {lib:.4f} (e4m3fn cast round trip) "
        f"bound_ms {b:.4f} ({by})")
    rows["quantize_elemwise"] = dict(
        name="quantize_elemwise", route="cuda",
        source="quantized_training_torch/csrc/quantize_elemwise.cu",
        replaces="quantized_training_tpu/ops/pallas/quantize_elemwise.py:30",
        max_abs_err=0.0, shape=f"posit8_1 bf16 ({M}, {N}) (down_proj input)",
        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by)

    # ---- two-pass flash: p rounded to posit8_1 ----------------------------
    # The kernel's row logsumexp (online max and sum) and the plain one
    # (torch.logsumexp) differ in the last f32 bits, so a p that lies within
    # an ulp of a bf16 or posit rounding boundary can land one posit step
    # away; the tolerance is set from the least atol each case needed.
    # On the H100 the worst case needed an atol of 3.7e-3 (B=4, S=1024);
    # the planted fault below needs 4.3e-2.
    atol, rtol = 6e-3, 2e-2
    pq, oq = quantize_fn_unit("posit8_1"), quantize_fn("posit8_1")
    log(f"phase 2/3: flash_attn_fwd_two_pass, p and out rounded to posit8_1 "
        f"(tolerance {atol} + {rtol}*|plain|)")
    max_err = 0.0
    for B, H, KV, S, D in [(4, 16, 16, 1024, 128), (1, 16, 4, 512, 128)]:
        scale = 1 / math.sqrt(D)
        q = randn(B, H, S, D, dtype=bf16)
        k = randn(B, KV, S, D, dtype=bf16)
        v = randn(B, KV, S, D, dtype=bf16)
        got = fa.flash_attention(q, k, v, p_qfn=pq)
        want = fa.naive_attention(q, k, v, scale=scale, p_qfn=pq)
        torch.cuda.synchronize()
        label = f"B={B} H={H} KV={KV} S=T={S} D={D}"
        ok, err = check_close(label, got, want, atol, rtol)
        max_err = max(max_err, err)
        if not ok:
            failures.append(f"flash_attn_fwd_two_pass {label}")
        got_o = fa.flash_attention(q, k, v, p_qfn=pq, out_qfn=oq)
        n_bad, first = bit_mismatches(got_o, qe.quantize_elemwise(got, oq.fmt))
        log(f"  {label}: flash(out_qfn) against the rounding kernel on "
            f"flash(): {n_bad} lanes differ")
        if n_bad:
            failures.append(f"flash out_qfn epilogue {label}")
        if S == 1024:
            # planted fault: rows 0..127 leave p unrounded in key tile 0..31
            if KV != H:
                k, v = (torch.repeat_interleave(t, H // KV, dim=1)
                        for t in (k, v))
            s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
            pos = torch.arange(S, device=dev)
            s = torch.where(pos[None, :] <= pos[:, None], s,
                            torch.full_like(s, fa.NEG_INF))
            p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
            pb = p.to(bf16)
            pr = pq.plain(pb)
            pr[:, :, :128, :32] = pb[:, :, :128, :32]
            faulted = torch.matmul(pr.float(), v.float()).to(bf16)
            del s, p, pb, pr
            planted_fault("two-pass S=1024: rows 0..127 leave p unrounded "
                          "in keys 0..31", got, faulted, atol, rtol, failures)

    def flash2_row(B=4, H=16, S=1024, D=128):
        q, k, v = (randn(B, H, S, D, dtype=bf16) for _ in range(3))
        scale = 1 / math.sqrt(D)
        ms = timer(lambda: fa.flash_attention(q, k, v, p_qfn=pq, out_qfn=oq))
        plain = timer(lambda: fa.naive_attention(q, k, v, scale=scale,
                                                 p_qfn=pq, out_qfn=oq))
        lib = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True))
        # the function's own work: one causal q.k and one p.v product
        b, by = bound_ms(4 * B * H * S * D * 2, 4 * S * S * D * B * H / 2)
        log(f"  time B={B} H={H} S={S}: kernel_ms {ms:.4f} plain_ms "
            f"{plain:.4f} library_ms {lib:.4f} (SDPA, unrounded) bound_ms "
            f"{b:.4f} ({by})")
        return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                    bound_by=by)

    rows["flash_attn_fwd_two_pass"] = dict(
        name="flash_attn_fwd_two_pass", route="cuda",
        source="quantized_training_torch/csrc/flash_attn_fwd.cu",
        replaces="quantized_training_tpu/ops/pallas/flash_attention.py:66",
        max_abs_err=max_err,
        shape="B=4 H=16 S=1024 D=128, p and out posit8_1", **flash2_row())

    # ---- fused quantize-matmul --------------------------------------------
    # The kernel and the plain version multiply the same rounded x: only
    # the f32 summation order and the output rounding differ.
    atol, rtol = 1e-4, 1e-2
    log(f"phase 2/3: quantized_matmul, x rounded to posit8_1 (tolerance "
        f"{atol} + {rtol}*|plain|)")
    max_err = 0.0
    mm_rows = {}
    for M, K, N in [(4096, 2048, 2048), (4096, 2048, 5504),
                    (4096, 5504, 2048), (100, 2048, 520)]:
        x = randn(M, K, dtype=bf16)
        w = randn(K, N, dtype=bf16, scale=1 / math.sqrt(K))
        got = qmm.quantized_matmul(x, w, x_qfn=p8)
        want = qmm.quantized_matmul_plain(x, w, p8)
        torch.cuda.synchronize()
        ok, err = check_close(f"M={M} K={K} N={N}", got, want, atol, rtol)
        max_err = max(max_err, err)
        if not ok:
            failures.append(f"quantized_matmul M={M} K={K} N={N}")
        if (M, K, N) == (4096, 2048, 2048):
            xf = p8.plain(x)
            xf[:, 1024:1056] = x[:, 1024:1056]
            planted_fault("M=4096 K=2048 N=2048: K tile 1024..1055 "
                          "unrounded", got,
                          torch.matmul(xf.float(), w.float()).to(bf16),
                          atol, rtol, failures)
        if M == 4096:
            ms = timer(lambda: qmm.quantized_matmul(x, w, x_qfn=p8))
            plain = timer(lambda: qmm.quantized_matmul_plain(x, w, p8))
            pair = timer(lambda: torch.matmul(qe.quantize_elemwise(x, p8.fmt),
                                              w))
            mm = timer(lambda: torch.matmul(x, w))
            b, by = bound_ms((M * K + K * N + M * N) * 2, 2 * M * K * N)
            log(f"  time M={M} K={K} N={N}: kernel_ms {ms:.4f} plain_ms "
                f"{plain:.4f} rounding kernel + torch.matmul {pair:.4f} "
                f"torch.matmul alone {mm:.4f} bound_ms {b:.4f} ({by})")
            mm_rows[(M, K, N)] = dict(ms=ms, plain_ms=plain, library_ms=pair,
                                      matmul_ms=mm, bound_ms=b, bound_by=by)
    rows["quantized_matmul"] = dict(
        name="quantized_matmul", route="cuda",
        source="quantized_training_torch/csrc/quantized_matmul.cu",
        replaces="quantized_training_tpu/ops/pallas/quantized_matmul.py:31",
        max_abs_err=max_err,
        shape="M=4096 K=2048 N=5504 (gate/up), library = rounding kernel + "
              "torch.matmul", **mm_rows[(4096, 2048, 5504)])
    if failures:
        fail("kernel disagrees with its plain version: " + ", ".join(failures))
    return rows


# ------------------------------------------------------------------ models
def serving_config(qt, layers):
    from dataclasses import replace
    P, R = 2048, 128
    cfg = replace(qt.LlamaConfig.llama2_7b(), num_hidden_layers=layers,
                  kv_cache=qt.KVCacheConfig.int_sym(P, R, 4),
                  fused_qkv=True, use_flash_attention=True,
                  use_fused_kivi=True, max_position_embeddings=P + R)
    return cfg, qt.QuantConfig().with_storage("w4a16", 64)


def parity_phase(torch, qt):
    """2 layers at full width: the card's kernel path against the plain path
    (the same weights on the CPU).  Tolerance: the JAX suite's bound between
    its fused and naive decode paths (tests/test_int_kv.py:174)."""
    log("phase 4: 2-layer 7B-width model, kernel path vs plain path "
        "(atol 0.15, rtol 0.05; first greedy token equal)")
    cfg, qc = serving_config(qt, 2)
    params = qt.random_params(cfg, "w4a16", 64, seed=SEED, device="cuda")
    gpu = qt.LlamaForCausalLM(cfg, qc, device="cuda")
    gpu.load_state_dict(params, assign=True)
    cpu = qt.LlamaForCausalLM(cfg, qc, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in params.items()}, assign=True)
    del params
    S = 512
    ids = torch.randint(0, cfg.vocab_size, (1, S),
                        generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        lg, cg = gpu(ids.cuda(), use_cache=True, prompt_len=S)
        lc, cc = cpu(ids, use_cache=True, prompt_len=S)
        ok, _ = check_close("prefill logits", lg.cpu(), lc, 0.15, 0.05)
        first_g = int(lg[0, -1].argmax())
        first_c = int(lc[0, -1].argmax())
        log(f"  first greedy token: kernel path {first_g}, plain path "
            f"{first_c}")
        ok = ok and first_g == first_c
        # Decode both paths from the plain path's cache: a 1-ulp difference
        # in a prefill K/V value can flip its int4 code by a whole step
        # (amax/7), which would measure the quantizer's boundaries rather
        # than the decode kernels.
        cg = [type(c)(*(t.cuda() for t in c)) for c in cc]
        tok = first_c
        for step in range(3):
            t = torch.tensor([[tok]])
            lg, cg = gpu(t.cuda(), use_cache=True, caches=cg,
                         cache_index=S + step)
            lc, cc = cpu(t, use_cache=True, caches=cc, cache_index=S + step)
            step_ok, _ = check_close(f"decode step {step} logits", lg.cpu(),
                                     lc, 0.15, 0.05)
            ok = ok and step_ok
            tok = int(lc[0, -1].argmax())
    del gpu, cpu
    if not ok:
        fail("kernel path disagrees with the plain path")


def bench_config(qt, layers):
    """bench.py's model (bench.py:23-45)."""
    return qt.LlamaConfig(
        vocab_size=32000, hidden_size=2048, intermediate_size=5504,
        num_hidden_layers=layers, num_attention_heads=16,
        num_key_value_heads=16, max_position_embeddings=1024,
        use_flash_attention=True)


def rung_config(qt, rung):
    """bench.py's quantized config at a ladder rung, weight specs stripped
    (the weights are folded offline); None for the bf16 baseline."""
    if rung == "bf16":
        return None
    qc = qt.QuantConfig(global_qconfig=qt.QConfig.from_strs(
        activation="posit8_1", weight="posit8_1"))
    return qt.strip_weight_specs(
        qc.with_fusion(forward=dict(qt.FUSION_LADDER)[rung]))


def folded_params(qt, cfg, device):
    qc = qt.QuantConfig(global_qconfig=qt.QConfig.from_strs(
        activation="posit8_1", weight="posit8_1"))
    return qt.fold_quantized_weights(
        qt.random_params(cfg, None, seed=SEED, device=device), qc)


def ladder_parity_phase(torch, qt):
    """2 layers at bench.py's width, residual_fusion: the card's kernel path
    against the plain path (the same folded weights on the CPU).

    posit8 rounding at every GEMM input turns a last-bit difference (cuBLAS
    and the CPU sum in other orders; the flash kernel's logsumexp is not
    torch.logsumexp's) into a whole posit step wherever it meets a rounding
    boundary, so the check is statistical: the relative Frobenius error of
    the logits and the share of logits outside 0.15 + 0.05*|plain| (the
    elementwise bound of the port's CPU parity tests).  On the H100 the
    kernel path read 0.0008-0.0037 and 0; the planted fault (the flash
    kernel leaving p unrounded) reads 0.16 and 0.21-0.23."""
    from quantized_training_torch.models import llama
    max_rel, max_bad = 0.05, 0.005
    log(f"phase 5: 2-layer bench.py-width model at residual_fusion, kernel "
        f"path vs plain path (relative error at most {max_rel}, at most "
        f"{max_bad} of the logits outside 0.15 + 0.05*|plain|)")
    cfg = bench_config(qt, 2)
    qc = rung_config(qt, "residual_fusion")
    params = folded_params(qt, cfg, "cuda")
    gpu = qt.LlamaForCausalLM(cfg, qc, device="cuda")
    gpu.load_state_dict(params, assign=True)
    cpu = qt.LlamaForCausalLM(cfg, qc, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in params.items()}, assign=True)
    del params

    def reading(name, got, want):
        err = (got - want).abs()
        rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
        bad = float((err > 0.15 + 0.05 * want.abs()).float().mean())
        same = int((got.argmax(-1) == want.argmax(-1)).sum())
        log(f"  {name}: relative error {rel:.5f}, outside {bad:.6f}, max abs "
            f"err {float(err.max()):.4f}, greedy tokens equal at {same} of "
            f"{got.shape[1]}")
        return rel <= max_rel and bad <= max_bad

    def digest(t):
        return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()[:16]

    # A second witness for a reading that moves between calls: each side
    # run again on the same input within this call, and a digest of each
    # side's logits, which can be compared across calls and hosts.
    log(f"  host CPU: {platform.machine()}, torch CPU capability "
        f"{torch.backends.cpu.get_cpu_capability()}, "
        f"{torch.get_num_threads()} threads")
    ok = True
    with torch.no_grad():
        for seed in (0, 1):
            ids = torch.randint(0, cfg.vocab_size, (1, 512),
                                generator=torch.Generator().manual_seed(seed))
            lc, _ = cpu(ids)
            lg, _ = gpu(ids.cuda())
            lg = lg.cpu()
            ok = reading(f"seed {seed}", lg, lc) and ok
            gpu_moves = max(float((gpu(ids.cuda())[0].cpu() - lg).abs().max())
                            for _ in range(3))
            cpu_moves = float((cpu(ids)[0] - lc).abs().max())
            log(f"    repeated on the same input: the kernel path moves by "
                f"at most {gpu_moves:.6g} over 3 more forwards, the plain "
                f"path by {cpu_moves:.6g} over 1; digests kernel path "
                f"{digest(lg)}, plain path {digest(lc)}")
        unit = llama.quantize_fn_unit
        llama.quantize_fn_unit = lambda dtype: None
        try:
            faulted, _ = gpu(ids.cuda())
        finally:
            llama.quantize_fn_unit = unit
        if reading("planted fault, flash leaves p unrounded (seed 1)",
                   faulted.cpu(), lc):
            fail("the parity check misses p left unrounded")
    del gpu, cpu
    if not ok:
        fail("kernel path disagrees with the plain path at residual_fusion")


def profile_forward(torch, model, ids, forward_ms):
    """Device time by kernel in one forward (torch.profiler), and the
    device's idle share of the timed forward."""
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(ids)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy == 0:
        log("  profile: the trace holds no device time (not measured)")
        return
    log(f"  profile: device busy {busy:.3f} ms of the {forward_ms:.3f} ms "
        f"forward, idle share {max(0.0, 1 - busy / forward_ms):.4f}; by "
        "kernel (ms, launches):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} {e.count:5d}  "
            f"{e.key[:90]}")


def ladder_phase(torch, qt):
    """bench.py's configuration at full width: tokens/s at every rung and in
    bf16, and the launch counters around one residual_fusion forward."""
    from quantized_training_torch.ops import launch_counts, \
        reset_launch_counts

    B, S, reps = 4, 1024, 5
    log(f"phase 5: bench.py ladder, 8 layers, hidden 2048, batch {B} x {S}, "
        f"posit8_1 folded weights; median of {reps} forwards after a "
        "warm-up")
    cfg = bench_config(qt, 8)
    params = folded_params(qt, cfg, "cuda")
    ids = torch.randint(0, cfg.vocab_size, (B, S),
                        generator=torch.Generator().manual_seed(SEED)).cuda()
    result, launches = {}, None
    for rung in ["bf16"] + [r for r, _ in qt.FUSION_LADDER]:
        model = qt.LlamaForCausalLM(cfg, rung_config(qt, rung), device="cuda")
        model.load_state_dict(params, assign=True)
        with torch.no_grad():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            logits, _ = model(ids)
            torch.cuda.synchronize()
            counts = launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if tuple(logits.shape) != (B, S, cfg.vocab_size) or not bool(
                    torch.isfinite(logits).all()):
                fail(f"ladder {rung}: logits {tuple(logits.shape)} not "
                     "finite")
            del logits
            times = []
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                model(ids)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
        ms = sorted(times)[reps // 2]
        result[rung] = {"forward_ms": ms, "tokens_per_s": B * S / ms * 1e3,
                        "peak_gib": peak}
        log(f"  {rung}: {ms:.3f} ms/forward, "
            f"{result[rung]['tokens_per_s']:.1f} tokens/s, peak "
            f"{peak:.2f} GiB, launches {counts}")
        if rung in ("bf16", "residual_fusion"):
            profile_forward(torch, model, ids, ms)
        if rung == "residual_fusion":
            launches = counts
        del model
    base = result["bf16"]["tokens_per_s"]
    for rung in result:
        result[rung]["vs_baseline"] = result[rung]["tokens_per_s"] / base
    log("ladder " + json.dumps(result))
    log(f"  residual_fusion vs_baseline "
        f"{result['residual_fusion']['vs_baseline']:.4f}")
    want = {"quantize_elemwise": 6 * cfg.num_hidden_layers + 1,
            "flash_attn_fwd_two_pass": cfg.num_hidden_layers}
    if any(launches[k] != n for k, n in want.items()):
        fail(f"one residual_fusion forward launched {launches}, expected "
             f"{want}")
    return launches


def serve_phase(torch, qt):
    from quantized_training_torch.ops import launch_counts, \
        reset_launch_counts
    import numpy as np

    log("phase 6: serve LLaMA-2 7B width, 32 layers, w4a16/64, int4 cache "
        "P=2048 R=128, 8 slots, 16 greedy requests x 32 new tokens")
    cfg, qc = serving_config(qt, 32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = qt.LlamaForCausalLM(cfg, qc, device="cuda")
    model.load_state_dict(qt.random_params(cfg, "w4a16", 64, seed=SEED,
                                           device="cuda"), assign=True)
    torch.cuda.synchronize()
    log(f"  weights built and packed in {time.perf_counter() - t0:.1f} s")

    engine = qt.ContinuousBatchingEngine(model, batch_slots=8)
    rng = np.random.default_rng(SEED)
    lengths = [int(n) for n in rng.permutation(
        np.linspace(64, 2048, 16).round().astype(int))]
    new_tokens = 32
    rids = {engine.submit(rng.integers(0, cfg.vocab_size, n),
                          max_new_tokens=new_tokens): n for n in lengths}

    stats = dict(prefill_s=0.0, prefills=0, bucket_tokens=0, decode_s=0.0,
                 decode_cpu_s=0.0, steps=0)
    prefill_slot, step = engine._prefill_slot, engine.step

    def timed_prefill(b, ids):
        torch.cuda.synchronize()
        t = time.perf_counter()
        prefill_slot(b, ids)
        torch.cuda.synchronize()
        stats["prefill_s"] += time.perf_counter() - t
        stats["prefills"] += 1
        stats["bucket_tokens"] += next(
            bk for bk in engine.prefill_buckets if bk >= len(ids))

    def timed_step():
        torch.cuda.synchronize()
        t, c = time.perf_counter(), time.process_time()
        step()
        torch.cuda.synchronize()
        stats["decode_s"] += time.perf_counter() - t
        stats["decode_cpu_s"] += time.process_time() - c
        stats["steps"] += 1

    engine._prefill_slot, engine.step = timed_prefill, timed_step
    reset_launch_counts()
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()

    generated = sum(len(t) for t in results.values())
    log(f"  requests {len(results)}, prompt tokens {sum(lengths)}, bucket "
        f"tokens {stats['bucket_tokens']}, generated tokens {generated}")
    log(f"  prefill: {stats['prefills']} calls, {stats['prefill_s']:.3f} s, "
        f"{sum(lengths) / stats['prefill_s']:.1f} prompt tokens/s")
    log(f"  decode: {stats['steps']} steps, "
        f"{1e3 * stats['decode_s'] / stats['steps']:.2f} ms/step, "
        f"{(generated - len(results)) / stats['decode_s']:.1f} tokens/s; "
        f"host CPU {1e3 * stats['decode_cpu_s'] / stats['steps']:.2f} "
        f"ms/step")
    log(f"  end to end: {wall:.2f} s, {generated / wall:.1f} generated "
        f"tokens/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  launches in the serving run: {launches}")
    if sorted(results) != sorted(rids):
        fail(f"requests unfinished: {set(rids) - set(results)}")
    for rid, toks in results.items():
        if len(toks) != new_tokens or not all(
                0 <= t < cfg.vocab_size for t in toks):
            fail(f"request {rid}: {len(toks)} tokens, {toks[:8]}...")
    serving = ("affine_w4_matmul", "flash_attn_fwd", "int_kv_decode")
    if any(launches[k] == 0 for k in serving):
        fail(f"a kernel of the serving path was never launched: {launches}")

    # What bounds a decode step: the host's time to enqueue one decode
    # forward (it has no host sync) against its time to completion.  When
    # the device finishes right after the last launch is issued, it was
    # waiting on the host.
    first = engine.caches[0]
    positions = (first.main_len + first.res_len)[:, None].to(torch.int64)
    enqueue, done = [], []
    for _ in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.no_grad():
            model(engine.tokens, positions=positions, use_cache=True,
                  caches=engine.caches)
        enqueue.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        done.append(time.perf_counter() - t)
    log(f"  one decode forward (median of 7): host enqueue "
        f"{1e3 * sorted(enqueue)[3]:.2f} ms, completion "
        f"{1e3 * sorted(done)[3]:.2f} ms")
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's kernels need "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi failed"
    log(card)

    import quantized_training_torch as qt
    from quantized_training_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log(sys.version.split()[0], torch.__version__, torch.version.cuda,
        torch.cuda.get_device_name(0))

    log("phase 1: build")
    t0 = time.perf_counter()
    report = _cuda.build()
    for name, r in report.items():
        log(f"  {name}: {r['seconds']:.1f} s")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")
    log(f"  build wall {time.perf_counter() - t0:.1f} s")

    timer = Timer(torch)
    rows = kernel_phases(torch, timer)
    rows.update(rounding_kernel_phases(torch, timer))
    parity_phase(torch, qt)
    ladder_parity_phase(torch, qt)
    ladder = ladder_phase(torch, qt)
    serving = serve_phase(torch, qt)
    # each kernel's launches in the main path that runs it: the serving run
    # (slice 1) or one residual_fusion forward (slice 2); the fused
    # quantize-matmul is on neither
    for key, row in rows.items():
        row["launches"] = (serving[key] if key in (
            "affine_w4_matmul", "flash_attn_fwd", "int_kv_decode")
            else ladder[key])
    log(json.dumps({"kernels": list(rows.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
