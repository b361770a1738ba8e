#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py        # one card

Phases, each of which exits non-zero on failure:
  1. build the hand-written kernels from quantized_training_torch/csrc
     (one nvcc per source, all started together);
  2. hold each kernel against its plain PyTorch version on the card, at the
     serving path's shapes and at the edges, beside a stated tolerance, and
     show that the tolerance is tight: a planted fault (the plain output of
     a kernel that drops one K group, one key tile or one split's values)
     must breach it;
  3. time each kernel, its plain version and one PyTorch library call that
     computes the same function (a yardstick only: the port never calls
     it), beside the least time the card could take (``bound_ms``);
  4. a 2-layer LLaMA-2 7B-width model: the kernel path's logits against the
     plain path's (the same model on the CPU);
  5. serve at full LLaMA-2 7B width (random seeded weights, w4a16 group 64,
     int4 cache P=2048 R=128, fused qkv, 8 slots): ~16 greedy requests
     through ContinuousBatchingEngine, with every kernel's launch counter
     read around that run.

The last two lines of output are the kernel table as one JSON object and
``{"ok": true, "device": {...}}``.
"""

import json
import math
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


def serve_phase(torch, qt):
    from quantized_training_torch.ops import KERNEL_WRAPPERS, \
        reset_launch_counts
    import numpy as np

    log("phase 5: serve LLaMA-2 7B width, 32 layers, w4a16/64, int4 cache "
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
    launches = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}

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
    if any(n == 0 for n in launches.values()):
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
    parity_phase(torch, qt)
    launches = serve_phase(torch, qt)
    for name, n in launches.items():
        key = {"affine_matmul": "affine_w4_matmul",
               "flash_attention": "flash_attn_fwd",
               "int_kv_decode_attention": "int_kv_decode"}[name]
        rows[key]["launches"] = n
    log(json.dumps({"kernels": list(rows.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
