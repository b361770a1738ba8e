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
and at Phi-3-medium's in packed uint2, kernel 7 (the int-sym decode,
``csrc/int_kv_decode.cu``) in int4 and int8 at the 7B's and Phi-3's decode
shapes and in its integer-dot and K^T forms at the 7B's, kernel 14 (the
packed 8-bit Adam step, ``csrc/adam8bit_step.cu``) at the posit8 train
step's and BERT-base's leaf sizes (random state, and zeros as the error
taps leave most leaves) and kernel 11 (the rounding,
``csrc/quantize_elemwise.cu``) at chip_smoke.py's timed shapes, each held
bit for bit to its plain version and timed beside its byte bound:

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
step at 2048-token prompts, ``adam8bit`` kernel 14's and the train path,
``elemwise`` kernel 11's and both paths, ``crossover`` kernel 11's two
forms from 2^18 to 2^24 bf16 elements, ``k14 probe`` kernel 14 and a copy
of its bytes under three L2 flushes and kernel 14 rebuilt with other
register caps, lookahead and block sizes; these two this checkout's only).  The paths, whose results must
not move with a kernel's redesign: chip_smoke.py's posit8 train step (8
layers; its losses over 7 steps, median ms/step, one step traced for busy
ms and kernels 14 and 11) and its PTQ presets on the 32-layer 7B (each
perplexity and ms a window; one linear4_matmul6_fp8_mixhead window traced
for kernel 11).  Prints a line per checkout and shape, arm or path, then
the card's name and power limit and one JSON object with every reading;
exits non-zero if a check fails or CUDA is not available.
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

# (label, kind, argument): kernel 14 (the packed 8-bit Adam step,
# ``csrc/adam8bit_step.cu``) at the posit8 train step's three leaf sizes
# and BERT-base's MLP kernel, random state and a leaf whose gradients the
# error taps flushed (zeros); kernel 11 (the rounding,
# ``csrc/quantize_elemwise.cu``) at the timed rows of chip_smoke.py (bf16
# and one f32 tensor, a small activation)
STREAM_SHAPES = [(f"adam8bit nb={nb} {data}", "adam8bit", (nb, data))
                 for nb in (16384, 44032, 256000, 9216)
                 for data in ("random", "zero")]
STREAM_SHAPES += [(f"elemwise {fmt} {shape} {dt}", "elemwise",
                   (fmt, shape, dt))
                  for fmt, shape, dt in [
                      ("nf4", (4096, 11008), "bf16"),
                      ("nf4_6", (4096, 11008), "bf16"),
                      ("float16", (4096, 11008), "bf16"),
                      ("posit8_1", (4096, 5504), "bf16"),
                      ("posit8_1", (1024, 4096), "bf16"),
                      ("nf4_6", (1024, 4096), "bf16"),
                      ("posit8_1", (4096, 1024), "f32")]]

# kernel 11's two forms on 1-D bf16 tensors of 2^18 .. 2^24 elements, one
# format of each kind: where the table form starts to pay for its fill
# (``ops/quantize_elemwise.py:TABLE_MIN_ELEMENTS``); this checkout's forms
# only
STREAM_SHAPES += [(f"crossover n=2^{k} {fmt} {form}", "crossover",
                   (fmt, k, form))
                  for k in range(18, 25)
                  for fmt in ("posit8_1", "e5m2", "int8", "float16", "nf4_6",
                              "fp6_e3m2")
                  for form in ("table", "arith")]

# kernel 14's time beside its bound, taken apart (this checkout's only):
# at nb=16384 and 256000 the kernel and a copy of the same bytes under
# three L2 flushes before each launch ("write", the timer's own: a 256 MB
# buffer zeroed, which leaves the L2 full of dirty lines for the timed
# call to write back; "read": the buffer summed, clean lines; "none":
# warm), and the kernel rebuilt with each of K14_VARIANTS' edits to its
# source (register caps, g one plane ahead, warps a block), each checked
# bit for bit against the plain version
K14_FLUSHES = ("write", "read", "none")
K14_VARIANTS = {
    "as built": (),
    "min 6 blocks an SM": (("__launch_bounds__(PK_WARPS * 32)\n",
                            "__launch_bounds__(PK_WARPS * 32, 6)\n"),),
    "min 8 blocks an SM": (("__launch_bounds__(PK_WARPS * 32)\n",
                            "__launch_bounds__(PK_WARPS * 32, 8)\n"),),
    "g one plane ahead": (("constexpr int G_AHEAD = 2;",
                           "constexpr int G_AHEAD = 1;"),),
    "2 warps a block": (("constexpr int PK_WARPS = 4;",
                         "constexpr int PK_WARPS = 2;"),),
    "8 warps a block": (("constexpr int PK_WARPS = 4;",
                         "constexpr int PK_WARPS = 8;"),)}
STREAM_SHAPES += [(f"k14 probe nb={nb} flush={flush} {what}", "k14flush",
                   (nb, flush, what))
                  for nb in (16384, 256000) for flush in K14_FLUSHES
                  for what in ("kernel", "copy")]
STREAM_SHAPES += [(f"k14 probe nb={nb} {variant}", "k14variant",
                   (nb, variant))
                  for nb in (16384, 256000) for variant in K14_VARIANTS]
# rows that use what only this checkout has (a forced form, the flush hook,
# kernel 14's source edits): skipped for the other ROOTs
OWN_KINDS = ("crossover", "k14flush", "k14variant")

# (label, function name): whole paths that run kernels 14 and 11, whose
# results must not move: the posit8 train step (losses) and the PTQ
# presets (perplexities)
PATHS = [("path train posit8 adam8bit elemwise", "train_path"),
         ("path ptq elemwise", "ptq_path")]

# the profiler's names of kernels 14 and 11, in every version
K14_NAMES = ("adam8bit_packed",)
K11_NAMES = ("quantize_elemwise_kernel", "round_table", "round_arith",
             "qt_table_build")

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


def stream_row(torch, smoke, timer, gen, label, kind, arg):
    """Kernel 14 or 11 at one shape: checked bit for bit against its plain
    version, timed, beside its byte bound."""
    from quantized_training_torch.numerics import quantize_fn
    from quantized_training_torch.ops import adam8bit_step as ad
    from quantized_training_torch.ops import quantize_elemwise as qe
    from quantized_training_torch.training.optim8bit import bias_corrections
    if kind == "adam8bit":
        nb, data = arg
        if data == "random":
            g2d = torch.randn((nb, 256), generator=gen, device="cuda") * 1e-3
            mc = torch.randint(-127, 128, (nb, 256), device="cuda",
                               generator=gen, dtype=torch.int32)
            vc = torch.randint(0, 256, (nb, 256), device="cuda",
                               generator=gen, dtype=torch.int32)
            msf = torch.rand(nb, device="cuda", generator=gen) * 1e-4 + 1e-7
            vsf = torch.rand(nb, device="cuda", generator=gen) * 1e-4 + 1e-7
        else:
            g2d = torch.zeros((nb, 256), device="cuda")
            mc = vc = torch.zeros((nb, 256), device="cuda", dtype=torch.int32)
            msf = vsf = torch.ones(nb, device="cuda")
        state = (ad.pack_moment_rows(mc), ad.pack_scale_rows(msf),
                 ad.pack_moment_rows(vc), ad.pack_scale_rows(vsf))
        bc = bias_corrections(0.9, 0.999, 7)
        kw = dict(b1=0.9, b2=0.999, eps=1e-8)

        def call():
            return ad.fused_adam8bit_update_packed(g2d, *state, *bc, **kw)
        want = ad.fused_adam8bit_update_packed_plain(g2d, *state, *bc, **kw)
        ok = not any(smoke.bit_mismatches(a, b)[0]
                     for a, b in zip(call(), want))
        nbytes = smoke.packed_adam_bytes(nb)
        M, K, N = nb, 256, 0
    else:
        if kind == "crossover":
            fmt, k, form = arg
            shape, dtype = (1 << k,), torch.bfloat16
        else:
            fmt, shape, dt = arg
            dtype = torch.bfloat16 if dt == "bf16" else torch.float32
            form = None
        x = (torch.randn(shape, generator=gen, device="cuda") * torch.exp2(
            torch.randn(shape, generator=gen, device="cuda") * 3)).to(dtype)
        qfn = quantize_fn(fmt)

        def call():
            if form is None:   # the public entry, in every checkout
                return qe.quantize_elemwise(x, qfn.fmt)
            return qe._quantize_elemwise(x, qfn.fmt, form)
        ok = smoke.bit_mismatches(call(), qfn.plain(x))[0] == 0
        nbytes = 2 * x.numel() * x.element_size()
        M, K, N = shape[0], shape[-1], 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(200):
        call()
    host_us = (time.perf_counter() - t) / 200 * 1e6
    torch.cuda.synchronize()
    return dict(shape=label, format=kind, M=M, K=K, N=N, ok=ok,
                ms=timer(call), host_us=host_us,
                bound_ms=smoke.bound_ms(nbytes, 0)[0])


_TIMERS = {}     # smoke.Timer subclasses by flush, built at first use
_VARIANTS = {}   # kernel 14's variant libraries by label


def flush_timer(torch, smoke, flush):
    """smoke.Timer with the L2 flush ``flush`` (K14_FLUSHES) before each
    launch."""
    if flush not in _TIMERS:
        class FlushTimer(smoke.Timer):
            def clear_l2(self):
                if flush == "write":
                    self.flush.zero_()
                elif flush == "read":
                    self.flush.sum()
        _TIMERS[flush] = FlushTimer(torch)
    return _TIMERS[flush]


def k14_variants():
    """{label: (library, ptxas' lines on the packed kernel)}: this
    checkout's csrc/adam8bit_step.cu with each of K14_VARIANTS' edits,
    built into the build directory, every nvcc at once."""
    from quantized_training_torch.ops import _cuda
    if _VARIANTS:
        return _VARIANTS
    import ctypes
    src = (_cuda.CSRC / "adam8bit_step.cu").read_text()
    out = _cuda.BUILD_DIR / "k14_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (label, edits) in enumerate(K14_VARIANTS.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"k14 variant {label}: {old!r} not in "
                                   "the source")
            text = text.replace(old, new)
        cu, so = out / f"v{i}.cu", out / f"libv{i}.so"
        cu.write_text(text)
        procs[label] = (subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    for label, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"k14 variant {label}:\n{log}")
        lines, fn = [], ""
        for line in log.splitlines():
            if "Function properties for" in line or "entry function" in line:
                fn = line
            if "adam8bit_packed_kernel" in fn and (
                    "registers" in line or "spill" in line):
                lines.append(line.strip())
        lib = ctypes.CDLL(str(so))
        lib.qt_error_string.argtypes = [ctypes.c_int]
        lib.qt_error_string.restype = ctypes.c_char_p
        _VARIANTS[label] = (lib, lines)
    return _VARIANTS


def k14_probe_row(torch, smoke, gen, label, kind, arg):
    """One row of the kernel-14 probe (K14_FLUSHES, K14_VARIANTS) at a
    leaf of random state (chip_smoke.py's timed rows' data)."""
    from quantized_training_torch.ops import _cuda
    from quantized_training_torch.ops import adam8bit_step as ad
    from quantized_training_torch.training.optim8bit import bias_corrections
    nb = arg[0]
    g2d = torch.randn((nb, 256), generator=gen, device="cuda") * 1e-3
    state = (ad.pack_moment_rows(torch.randint(
                 -127, 128, (nb, 256), device="cuda", generator=gen,
                 dtype=torch.int32)),
             ad.pack_scale_rows(torch.rand(nb, device="cuda", generator=gen)
                                * 1e-4 + 1e-7),
             ad.pack_moment_rows(torch.randint(
                 0, 256, (nb, 256), device="cuda", generator=gen,
                 dtype=torch.int32)),
             ad.pack_scale_rows(torch.rand(nb, device="cuda", generator=gen)
                                * 1e-4 + 1e-7))
    bc = bias_corrections(0.9, 0.999, 7)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8)
    nbytes = smoke.packed_adam_bytes(nb)
    row = dict(shape=label, format=kind, M=nb, K=256, N=0, ok=True,
               bound_ms=smoke.bound_ms(nbytes, 0)[0], host_us=0.0)

    def call():
        return ad.fused_adam8bit_update_packed(g2d, *state, *bc, **kw)
    want = ad.fused_adam8bit_update_packed_plain(g2d, *state, *bc, **kw)
    if kind == "k14flush":
        _, flush, what = arg
        timer = flush_timer(torch, smoke, flush)
        if what == "copy":
            src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
            dst = torch.empty_like(src)
            row["ms"] = timer(lambda: dst.copy_(src))
        else:
            row["ok"] = not any(smoke.bit_mismatches(a, b)[0]
                                for a, b in zip(call(), want))
            row["ms"] = timer(call)
        return row
    lib, row["ptxas"] = k14_variants()[arg[1]]
    built = _cuda._LIBS.get("adam8bit_step")
    _cuda._LIBS["adam8bit_step"] = lib   # the wrapper launches the variant
    try:
        row["ok"] = not any(smoke.bit_mismatches(a, b)[0]
                            for a, b in zip(call(), want))
        row["ms"] = flush_timer(torch, smoke, "write")(call)
    finally:
        if built is None:
            del _cuda._LIBS["adam8bit_step"]
        else:
            _cuda._LIBS["adam8bit_step"] = built
    return row


def kernel_ms(prof, names):
    """Device ms of the kernels whose names hold any of ``names``."""
    return sum(prof["watched_ms"].get(n, 0.0) for n in names) if prof \
        else None


def train_path(torch, smoke):
    """chip_smoke.py's phase 8 posit8 arm: the 8-layer train_bench.py step
    (batch 4 x 1024, posit8 fwd + err, Adam8bit(1e-4)), one warm-up and 6
    timed steps on the same batch (losses, median ms/step), one more
    traced (busy ms, idle share, kernels 14 and 11)."""
    import quantized_training_torch as qt
    from quantized_training_torch.ops import launch_counts, \
        reset_launch_counts
    from quantized_training_torch.training import (Adam8bit, causal_lm_loss,
                                                   make_train_step)
    cfg = smoke.bench_config(qt, 8)
    model = qt.LlamaForCausalLM(cfg, smoke.train_qconfig(qt), device="cuda")
    model.load_state_dict(qt.random_params(cfg, None, seed=0,
                                           device="cuda"))
    step = make_train_step(model, Adam8bit(model.parameters(), lr=1e-4),
                           causal_lm_loss)
    batch = {"input_ids": smoke.train_batch(torch, cfg.vocab_size).cuda()}
    losses, times = [float(step(batch))], []
    for i in range(6):
        if i == 0:
            reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        if i == 0:
            counts = launch_counts()
        losses.append(float(loss))
    ms = sorted(times)[3]
    prof = smoke.profile(torch, lambda: step(batch), ms, "step",
                         watch=K14_NAMES + K11_NAMES) or {}
    return {"losses": losses, "ms_per_step": ms,
            "busy_ms": prof.get("busy_ms"),
            "idle_share": prof.get("idle_share"),
            "kernel14_ms": kernel_ms(prof, K14_NAMES),
            "kernel14_launches": counts["adam8bit_packed"],
            "kernel11_ms": kernel_ms(prof, K11_NAMES),
            "kernel11_launches": counts["quantize_elemwise"]}


def ptq_path(torch, smoke):
    """chip_smoke.py's phase 12: the six PTQ presets and bf16 on the
    32-layer LLaMA-2 7B (f32 parameters from seed 0, 4096 seeded tokens in
    six 1024-token windows): each perplexity and median ms a window; one
    linear4_matmul6_fp8_mixhead window traced (busy ms, kernel 11)."""
    import numpy as np
    import quantized_training_torch as qt
    from quantized_training_torch.ops import launch_counts, \
        reset_launch_counts
    from quantized_training_torch.quantize import build_preset
    from quantized_training_torch.utils import sliding_window_perplexity
    L, stride, n = 1024, 512, 4096
    cfg = qt.LlamaConfig.llama2_7b()
    params = qt.random_params(cfg, None, seed=0, device="cuda")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, n)
    out = {}
    for label in ("bf16",) + smoke.PTQ_PRESETS:
        qc = None if label == "bf16" else build_preset(label)
        model = qt.LlamaForCausalLM(cfg, qc, device="meta")
        model.load_state_dict(params, assign=True)
        times = []

        def forward(ids):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits = model(ids)[0]
            end.record()
            times.append((start, end))
            return logits

        ppl = sliding_window_perplexity(forward, tokens, L, stride,
                                        device="cuda")
        torch.cuda.synchronize()
        ms = sorted(s.elapsed_time(e) for s, e in times)
        out[label] = {"perplexity": ppl, "ms_per_window": ms[len(ms) // 2]}
        if label == "linear4_matmul6_fp8_mixhead":
            window = torch.as_tensor(tokens[:L][None]).cuda()
            with torch.no_grad():
                reset_launch_counts()
                model(window)
                torch.cuda.synchronize()
                launches = launch_counts()["quantize_elemwise"]
                prof = smoke.profile(torch, lambda: model(window),
                                     ms[len(ms) // 2], "mixhead window",
                                     watch=K11_NAMES) or {}
            out[label].update(busy_ms=prof.get("busy_ms"),
                              kernel11_ms=kernel_ms(prof, K11_NAMES),
                              kernel11_launches=launches)
        del model
    del params
    torch.cuda.empty_cache()
    return out


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
    from quantized_training_torch.ops import _cuda
    _cuda.build()  # every library at once, not one at its first use
    # as chip_smoke.py sets them: f32 products in full f32 (the dense
    # layers refuse a reduced-precision bf16 reduction)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
    for label, kind, arg in [] if steps_only else STREAM_SHAPES:
        if match is not None and match not in label or (
                kind in OWN_KINDS and root != HERE):
            continue
        if kind in ("k14flush", "k14variant"):
            rows.append(k14_probe_row(torch, smoke, gen, label, kind, arg))
        else:
            rows.append(stream_row(torch, smoke, timer, gen, label, kind,
                                   arg))
    steps = [decode_step(torch, smoke, *arm[1:])
             for arm in ARMS if match is None or match in arm[0]]
    paths = {label: globals()[fn](torch, smoke) for label, fn in PATHS
             if match is None or match in label}
    if paths:
        # kernels 14 and 11 as compiled (static instruction counts)
        paths["sass"] = {
            fn[:80]: mix for lib in ("adam8bit_step", "quantize_elemwise")
            for only in K14_NAMES + K11_NAMES
            for fn, mix in smoke.sass_mix(_cuda.sass(lib), only).items()}
    print(json.dumps({"root": root, "rows": rows, "decode_steps": steps,
                      "paths": paths}), flush=True)


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
                              text=True, timeout=1800)
        line = proc.stdout.strip().splitlines()[-1:] or [""]
        if proc.returncode != 0 or not line[0].startswith("{"):
            print(f"{root}: exit {proc.returncode}\n{proc.stdout[-4000:]}"
                  f"\n{proc.stderr[-4000:]}", flush=True)
            ok = False
            continue
        run = json.loads(line[0])
        runs.append(run)
        for r in run["rows"]:
            bound = (f", bound {r['bound_ms']:.4f} ms" if "bound_ms" in r
                     else "")
            print(f"{root}  {r['shape']:<24} M={r['M']} "
                  f"K={r['K']} N={r['N']}: {r['ms']:.4f} ms{bound}, host "
                  f"{r['host_us']:.1f} us a call, within bound "
                  f"{r['ok']}" + "".join(f"\n    {line}"
                                         for line in r.get("ptxas", ())),
                  flush=True)
            ok = ok and r["ok"]
        for label, path in run.get("paths", {}).items():
            print(f"{root}  {label}: {json.dumps(path)}", flush=True)
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
