#!/usr/bin/env python3
"""Time the storage GEMMs and the decode attentions of one or more
checkouts of the port on one NVIDIA GPU, so that two versions of a kernel
are compared within one run: kernel 5 (the w4/w2 GEMM,
``csrc/affine_w4_matmul.cu``) at its prefill shapes and at its decode
shapes (M = 8 and 1 at LLaMA-2 7B's, Phi-3-medium's qkv and down, the w2
format's 13B qkv), kernels 9 and 10 (the MX8 and posit8 GEMMs,
``csrc/mx_storage_matmul.cu`` and ``csrc/posit_storage_matmul.cu``) at
LLaMA-2 7B's decode shapes and at M > 8 (its qkv and down at a 2048-token
prefill, its qkv at one slot's 128-token prompt), kernel 8 (the KIVI
decode, ``csrc/kivi_decode.cu``) at the 7B's decode shape (8 full slots, P
= 2048, R = 128) in each cache form (packed uint2 and uint4, uint8 codes)
and at Phi-3-medium's in packed uint2, and kernel 7 (the int-sym decode,
``csrc/int_kv_decode.cu``) in int4 and int8 at the 7B's and Phi-3's decode
shapes and in its integer-dot and K^T forms at the 7B's:

    python3 time_storage_gemm.py [--steps-only | --match TEXT] ROOT [ROOT ...]

Each ROOT is a directory that holds a ``quantized_training_torch`` package
(``.`` for this checkout).  The checkouts are timed in the order given, each
in a process of its own (name one twice to time it twice, as in A B B A).
A process builds its checkout's kernels into that checkout's ``_build/``,
checks one call at each shape against the plain version (the GEMMs within
1e-4 + 1e-2*|plain|, kernel 8 within chip_smoke.py's KIVI_TOL bounds for its
form, kernel 7 within its INT_KV_* bounds) and times it with chip_smoke.py's
``Timer`` (median of 15 calls, L2 flushed); it also reads the host's cost
of a call, the mean over 200 calls queued back to back without a wait (the
card runs behind, so the host sets that pace).  Every weight is seeded, group or MX block 64, posit8 es 1.
Then it serves its arms, each labelled ``step ...``: chip_smoke.py's
posit8_kv4 and mx8_kv4 format arms (2 layers at 7B width) and its 32-layer
7B w4a16 model with the int4 cache (the serving phase's), each with 8
slots of 128 prompt tokens: the median of 5 prefills' wall time, one more
prefill traced (``torch.profiler``) for the device's busy time and the
device time of the storage GEMMs (kernels in ``bsg::`` for the byte
formats, 10 launches at M = 1024 and the lm_head's at M = 8; kernel 5's
``w4_gemm`` kernels for w4a16), then the median of 20 decode steps' wall
time and of their host time (from the step's call until it has been
queued, before the wait for the card), and one more step traced for the
device's busy time, its idle share and the storage GEMMs' device time;
and the 32-layer 7B w4a16 model with the packed uint2 KIVI cache (the
flagship), its 8 slots prefilled with 2048 tokens each (one untimed
prefill), whose traced decode step also reports kernel 8's device time
(kernels named ``kivi``), and the same 32-layer model with the int4 cache
at 2048-token prompts, whose traced step reports kernel 7's (kernels named
``int_kv``).  ``--steps-only`` serves the arms and times no shape, for many
alternating runs (P A P A ...) in one call; ``--match TEXT`` times only the
shapes and serves only the arms whose label holds TEXT (``kivi`` takes
kernel 8's shapes and the KIVI step, ``int_kv`` kernel 7's and the int4
step at 2048-token prompts).  Prints a line
per checkout and shape or arm, then the card's name and power limit and
one JSON object with every reading; exits non-zero if a check fails or
CUDA is not available.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# (label, format, M, K, N): kernel 5 at LLaMA-2 7B's qkv and down at the
# largest prefill bucket and its qkv at the smallest, Phi-3-medium's
# gate/up, and the w2 format's two prefill rows of chip_smoke.py; at its
# decode rows (the 7B's five shapes at M = 8 and its qkv at M = 1,
# Phi-3's qkv and down, the w2 format's 13B qkv); kernels 9
# and 10 at the 7B decode shapes (qkv fused, o, gate and up, down, lm_head)
# and at chip_smoke.py's M > 8 rows (TC_SHAPES)
SHAPES = [("7B qkv", "w4", 2048, 4096, 12288),
          ("7B down", "w4", 2048, 11008, 4096),
          ("7B qkv, bucket 512", "w4", 512, 4096, 12288),
          ("Phi-3 gate/up", "w4", 2048, 5120, 17920),
          ("w2, 7B qkv", "w2", 2048, 4096, 12288),
          ("w2, 13B down", "w2", 2048, 13824, 5120)]
SHAPES += [(f"w4 decode {label}", "w4", M, K, N)
           for label, K, N, Ms in [("qkv", 4096, 12288, (8, 1)),
                                   ("o", 4096, 4096, (8,)),
                                   ("gate/up", 4096, 11008, (8,)),
                                   ("down", 11008, 4096, (8,)),
                                   ("lm_head", 4096, 32000, (8,)),
                                   ("Phi-3 qkv", 5120, 7680, (8,)),
                                   ("Phi-3 down", 17920, 5120, (8,))]
           for M in Ms]
SHAPES += [("w2 decode 13B qkv", "w2", 8, 5120, 15360)]
for _fmt in ("mx8", "posit8"):
    SHAPES += [(f"{_fmt} decode {label}", _fmt, M, K, N)
               for label, K, N, Ms in [("qkv", 4096, 12288, (8, 1)),
                                       ("o", 4096, 4096, (8,)),
                                       ("gate/up", 4096, 11008, (8,)),
                                       ("down", 11008, 4096, (8,)),
                                       ("lm_head", 4096, 32000, (8,))]
               for M in Ms]
    SHAPES += [(f"{_fmt} prefill qkv", _fmt, 2048, 4096, 12288),
               (f"{_fmt} prefill down", _fmt, 2048, 11008, 4096),
               (f"{_fmt} prompt qkv", _fmt, 128, 4096, 12288)]


# (label, B, H, KV, D, P, R, bits, packed): kernel 8 at every slot full
KIVI_SHAPES = [("kivi 7B uint2", 8, 32, 32, 128, 2048, 128, 2, True),
               ("kivi 7B uint4", 8, 32, 32, 128, 2048, 128, 4, True),
               ("kivi 7B uint8", 8, 32, 32, 128, 2048, 128, 2, False),
               ("kivi Phi-3 uint2", 8, 40, 10, 128, 2048, 128, 2, True)]

# (label, B, H, KV, D, P, R, bits, int_dots, k_transposed): kernel 7 at
# every slot full, its served int4 form and int8 at the 7B and Phi-3 decode
# shapes, the integer-dot and K^T forms at the 7B's
INT_KV_SHAPES = [
    ("int_kv 7B int4", 8, 32, 32, 128, 2048, 128, 4, False, False),
    ("int_kv 7B int8", 8, 32, 32, 128, 2048, 128, 8, False, False),
    ("int_kv Phi-3 int4", 8, 40, 10, 128, 2048, 128, 4, False, False),
    ("int_kv Phi-3 int8", 8, 40, 10, 128, 2048, 128, 8, False, False),
    ("int_kv 7B int8 K^T", 8, 32, 32, 128, 2048, 128, 8, False, True),
    ("int_kv 7B int8 integer dots", 8, 32, 32, 128, 2048, 128, 8, True,
     False),
    ("int_kv 7B int8 integer dots K^T", 8, 32, 32, 128, 2048, 128, 8, True,
     True)]

# (label, storage format, layers, cache, prompt tokens a slot, watched
# kernel names): the served arms
ARMS = [("step posit8_kv4", "posit8", 2, "int4", 128, ("bsg::",)),
        ("step mx8_kv4", "mx8", 2, "int4", 128, ("bsg::",)),
        ("step w4a16_kv4", "w4a16", 32, "int4", 128, ("w4_gemm",)),
        ("step w4a16_kivi2", "w4a16", 32, "kivi2", 2048,
         ("w4_gemm", "kivi")),
        ("step w4a16_kv4 int_kv", "w4a16", 32, "int4", 2048,
         ("w4_gemm", "int_kv"))]


def kivi_row(torch, smoke, timer, gen, label, B, H, KV, D, P, R, bits,
             pack):
    """Kernel 8 at one shape, every slot full: checked against its plain
    version within chip_smoke.py's bound for the form, timed."""
    from quantized_training_torch.ops import kivi_attention as ka
    from quantized_training_torch.serving import kv_cache as kvc
    bf16 = torch.bfloat16
    cfg = smoke.kivi_config(P, R, bits, pack)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    cache = kvc.prefill_cache(kvc.init_cache(cfg, B, KV, D, device="cuda"),
                              cfg, rnd(B, P, KV, D), rnd(B, P, KV, D))
    bk = cfg._pack_bits(cfg.k_spec)
    full = torch.full((B,), P, dtype=torch.int32, device="cuda")
    args = (rnd(B, H, D), *cache[:6], rnd(B, KV, R, D), rnd(B, KV, R, D),
            full, full * 0 + R)
    kw = dict(bits_k=bk, bits_v=bk)
    ok, _ = smoke.kivi_reading(
        label, ka.kivi_decode_attention(*args, **kw),
        ka.kivi_decode_plain(*args, scale=D ** -0.5, **kw), (128, bits, pack))
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(200):
        ka.kivi_decode_attention(*args, **kw)
    host_us = (time.perf_counter() - t) / 200 * 1e6
    torch.cuda.synchronize()
    ms = timer(lambda: ka.kivi_decode_attention(*args, **kw))
    return dict(shape=label, format=f"kivi uint{bits} "
                f"{'packed' if pack else 'bytes'}", M=B, K=P, N=H, ok=ok,
                ms=ms, host_us=host_us)


def int_kv_row(torch, smoke, timer, gen, label, B, H, KV, D, P, R, bits,
               int_dots, kt):
    """Kernel 7 at one shape and form, every slot full: checked against its
    plain version within chip_smoke.py's INT_KV_* bounds, timed."""
    from quantized_training_torch.ops import int_kv_attention as ikv
    from quantized_training_torch.serving import kv_cache as kvc
    bf16 = torch.bfloat16
    cfg = kvc.KVCacheConfig.int_sym(P, R, bits)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    cache = kvc.prefill_cache(kvc.init_cache(cfg, B, KV, D, device="cuda"),
                              cfg, rnd(B, P, KV, D), rnd(B, P, KV, D))
    kc = cache.k_codes.transpose(2, 3).contiguous() if kt else cache.k_codes
    full = torch.full((B,), P, dtype=torch.int32, device="cuda")
    args = (rnd(B, H, D), kc, cache.k_scale, cache.v_codes, cache.v_scale,
            rnd(B, KV, R, D), rnd(B, KV, R, D), full, full * 0 + R)
    kw = dict(bits=bits, int_dots=int_dots, k_transposed=kt)
    ok, _ = smoke.int_kv_reading(
        label, ikv.int_kv_decode_attention(*args, **kw),
        ikv.int_kv_decode_plain(*args, scale=D ** -0.5, **kw))
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(200):
        ikv.int_kv_decode_attention(*args, **kw)
    host_us = (time.perf_counter() - t) / 200 * 1e6
    torch.cuda.synchronize()
    ms = timer(lambda: ikv.int_kv_decode_attention(*args, **kw))
    return dict(shape=label, format=f"int_kv int{bits} int_dots={int_dots} "
                f"k_transposed={kt}", M=B, K=P, N=H, ok=ok, ms=ms,
                host_us=host_us)


def gemm(fmt, w):
    """(call(x), plain(x)) of the storage GEMM of ``fmt`` on weight w."""
    from quantized_training_torch.ops import affine_storage as aff
    from quantized_training_torch.ops import mx_storage as mx
    from quantized_training_torch.ops import posit_storage as ps
    if fmt in ("w4", "w2"):
        nbits = 4 if fmt == "w4" else 2
        p = aff.pack_affine_weights(w, nbits, 64)
        return (lambda x: aff.affine_matmul(x, *p, nbits=nbits,
                                            group_size=64),
                lambda x: aff.affine_matmul_plain(x, *p, nbits=nbits,
                                                  group_size=64))
    if fmt == "mx8":
        p = mx.pack_mx_weights(w, block_size=64)
        return (lambda x: mx.mx_matmul(x, *p, block_size=64),
                lambda x: mx.mx_matmul_plain(x, *p, block_size=64))
    c = ps.pack_posit_weights(w.bfloat16(), es=1)
    return (lambda x: ps.posit_matmul(x, c, es=1),
            lambda x: ps.posit_matmul_plain(x, c, es=1))


def time_one(root, steps_only=False, match=None):
    """Time ROOT's kernels at every shape (none with ``steps_only``, those
    whose label holds ``match`` where given) and its arms' prefills and
    decode steps (none with ``match``); prints one JSON line."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    import quantized_training_torch.ops as ops
    if not ops.__file__.startswith(root):
        raise RuntimeError(f"imported {ops.__file__}, not from {root}")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = smoke.Timer(torch)
    rows = []
    for label, fmt, M, K, N in [] if steps_only else SHAPES:
        if match is not None and match not in label:
            continue
        w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        call, plain = gemm(fmt, w)
        x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
        got = call(x).float()
        want = plain(x).float()
        ok = bool(((got - want).abs() <= 1e-4 + 1e-2 * want.abs()).all())
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(200):
            call(x)
        host_us = (time.perf_counter() - t) / 200 * 1e6
        torch.cuda.synchronize()
        rows.append(dict(shape=label, format=fmt, M=M, K=K, N=N, ok=ok,
                         ms=timer(lambda: call(x)), host_us=host_us))
        del w, call, plain, x, got, want
    for label, *shape in [] if steps_only else KIVI_SHAPES:
        if match is None or match in label:
            rows.append(kivi_row(torch, smoke, timer, gen, label, *shape))
    for label, *shape in [] if steps_only else INT_KV_SHAPES:
        if match is None or match in label:
            rows.append(int_kv_row(torch, smoke, timer, gen, label, *shape))
    steps = [decode_step(torch, smoke, *arm[1:])
             for arm in ARMS if match is None or match in arm[0]]
    print(json.dumps({"root": root, "rows": rows, "decode_steps": steps}),
          flush=True)


def decode_step(torch, smoke, fmt, layers, cache, S, watch, B=8, steps=20):
    """chip_smoke.py's LLaMA-2 7B-width model in storage format ``fmt`` at
    ``layers`` layers with ``cache`` (int4, or kivi2: packed uint2 KIVI):
    prefills of B slots of S tokens (of 128-token prompts 5 timed and one
    traced; of longer ones one, untimed), then ``steps`` timed decode steps
    (wall and host time), one more traced; the watched kernels are those
    whose names hold each string of ``watch`` (the first: the storage
    GEMMs; a second: the decode attention, kernel 8 or 7)."""
    import quantized_training_torch as qt
    cfg, qc = smoke.serving_config(qt, layers, fmt, cache)
    model = qt.LlamaForCausalLM(cfg, qc, device="cuda")
    model.load_state_dict(qt.random_params(cfg, fmt, 64, seed=0,
                                           device="cuda"), assign=True)
    ids = torch.randint(0, cfg.vocab_size, (B, S),
                        generator=torch.Generator().manual_seed(0)).cuda()
    def prefill():
        with torch.no_grad():
            return model(ids, use_cache=True, prompt_len=S,
                         last_logit_only=True)

    walls = []
    for _ in range(6 if S == 128 else 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, caches = prefill()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    prefill_ms = sorted(walls[1:])[2] if len(walls) > 1 else None
    pre = (smoke.profile(torch, prefill, prefill_ms, "8-slot prefill",
                         watch=watch) or {}) if prefill_ms else {}
    with torch.no_grad():
        tok = logits[:, -1].argmax(-1, keepdim=True)
        times, host = [], []
        for i in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, caches = model(tok, use_cache=True, caches=caches,
                                   cache_index=S + i)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            host.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    ms = sorted(times)[steps // 2]
    host_ms = sorted(host)[steps // 2]

    def one_step():
        with torch.no_grad():
            model(tok, use_cache=True, caches=caches, cache_index=S + steps)

    prof = smoke.profile(torch, one_step, ms, "decode step",
                         watch=watch) or {}
    out = {"format": fmt, "cache": cache, "layers": layers,
           "prompt": S, "prefill_ms": prefill_ms,
           "prefill_busy_ms": pre.get("busy_ms"),
           "prefill_storage_gemm_ms": pre.get("watched_ms", {}).get(watch[0]),
           "decode_ms_per_step": ms, "host_ms_per_step": host_ms,
           "busy_ms": prof.get("busy_ms"),
           "idle_share": prof.get("idle_share"),
           "storage_gemm_ms": prof.get("watched_ms", {}).get(watch[0]),
           "decode_attention_ms": prof.get("watched_ms", {}).get(
               watch[-1]) if len(watch) > 1 else None}
    del model, caches, logits
    torch.cuda.empty_cache()
    return out


def main(roots, steps_only=False, match=None):
    import torch
    if not torch.cuda.is_available():
        print("time_storage_gemm: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    runs, ok = [], True
    for root in roots:
        flags = (["--steps-only"] if steps_only else []) + (
            ["--match", match] if match else [])
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root] + flags, capture_output=True,
                              text=True, timeout=900)
        line = proc.stdout.strip().splitlines()[-1:] or [""]
        if proc.returncode != 0 or not line[0].startswith("{"):
            print(f"{root}: exit {proc.returncode}\n{proc.stdout[-4000:]}"
                  f"\n{proc.stderr[-4000:]}", flush=True)
            ok = False
            continue
        run = json.loads(line[0])
        runs.append(run)
        for r in run["rows"]:
            print(f"{root}  {r['shape']:<24} M={r['M']} "
                  f"K={r['K']} N={r['N']}: {r['ms']:.4f} ms, host "
                  f"{r['host_us']:.1f} us a call, within bound "
                  f"{r['ok']}", flush=True)
            ok = ok and r["ok"]
        for d in run["decode_steps"]:
            arm = (f"{d['format']}_{d['cache']} ({d['layers']} layers, "
                   f"{d['prompt']}-token prompts)")
            if d["prefill_ms"] is not None:
                print(f"{root}  {arm} 8-slot prefill: "
                      f"{d['prefill_ms']:.3f} ms wall, busy "
                      f"{d['prefill_busy_ms']} ms, storage GEMMs "
                      f"{d['prefill_storage_gemm_ms']} ms", flush=True)
            print(f"{root}  {arm} decode step: "
                  f"{d['decode_ms_per_step']:.3f} ms wall, host "
                  f"{d['host_ms_per_step']:.3f} ms, busy "
                  f"{d['busy_ms']} ms, idle share {d['idle_share']}, "
                  f"storage GEMMs {d['storage_gemm_ms']} ms, decode "
                  f"attention {d['decode_attention_ms']} ms", flush=True)
    print(smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed")
    print(json.dumps({"storage_gemm_times": runs}))
    return 0 if ok else 1


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n", 1)[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("roots", nargs="+", metavar="ROOT")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--steps-only", action="store_true",
                      help="serve the arms, time no shape")
    mode.add_argument("--match", metavar="TEXT",
                      help="time only the shapes and serve only the arms "
                      "whose label holds TEXT")
    # one ROOT in this process (main runs each ROOT so)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        time_one(args.roots[0], args.steps_only, args.match)
    else:
        sys.exit(main(args.roots, args.steps_only, args.match))
