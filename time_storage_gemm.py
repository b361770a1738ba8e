#!/usr/bin/env python3
"""Time kernel 5, the w4/w2 storage GEMM (``csrc/affine_w4_matmul.cu``), of
one or more checkouts of the port at its prefill shapes on one NVIDIA GPU,
so that two versions of the kernel are compared within one run:

    python3 time_storage_gemm.py ROOT [ROOT ...]

Each ROOT is a directory that holds a ``quantized_training_torch`` package
(``.`` for this checkout).  The checkouts are timed in the order given, each
in a process of its own (name one twice to time it twice, as in A B B A).
A process builds its checkout's kernel into that checkout's ``_build/``,
checks one call at each shape against the plain version (1e-4 +
1e-2*|plain|, chip_smoke.py's bound) and times it with chip_smoke.py's
``Timer`` (median of 15 calls, L2 flushed).  Every weight is seeded, group
64.  Prints a line per checkout and shape, then the card's name and power
limit and one JSON object with every reading; exits non-zero if a check
fails or CUDA is not available.
"""

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# (label, nbits, M, K, N): LLaMA-2 7B's qkv and down at the largest prefill
# bucket and its qkv at the smallest, Phi-3-medium's gate/up, and the w2
# format's two prefill rows of chip_smoke.py
SHAPES = [("7B qkv", 4, 2048, 4096, 12288),
          ("7B down", 4, 2048, 11008, 4096),
          ("7B qkv, bucket 512", 4, 512, 4096, 12288),
          ("Phi-3 gate/up", 4, 2048, 5120, 17920),
          ("w2, 7B qkv", 2, 2048, 4096, 12288),
          ("w2, 13B down", 2, 2048, 13824, 5120)]


def time_one(root):
    """Time ROOT's kernel at every shape; prints one JSON line."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    from quantized_training_torch.ops import affine_storage as aff
    if not aff.__file__.startswith(root):
        raise RuntimeError(f"imported {aff.__file__}, not from {root}")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = smoke.Timer(torch)
    rows = []
    for label, nbits, M, K, N in SHAPES:
        w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        codes, sf, zp = aff.pack_affine_weights(w, nbits, 64)
        x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()

        def call():
            return aff.affine_matmul(x, codes, sf, zp, nbits=nbits,
                                     group_size=64)

        got = call().float()
        want = aff.affine_matmul_plain(x, codes, sf, zp, nbits=nbits,
                                       group_size=64).float()
        ok = bool(((got - want).abs() <= 1e-4 + 1e-2 * want.abs()).all())
        rows.append(dict(shape=label, nbits=nbits, M=M, K=K, N=N, ok=ok,
                         ms=timer(call)))
        del w, codes, sf, zp, x, got, want
    print(json.dumps({"root": root, "rows": rows}), flush=True)


def main(roots):
    import torch
    if not torch.cuda.is_available():
        print("time_storage_gemm: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    runs, ok = [], True
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root], capture_output=True,
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
            print(f"{root}  {r['shape']:<20} nbits={r['nbits']} M={r['M']} "
                  f"K={r['K']} N={r['N']}: {r['ms']:.4f} ms, within bound "
                  f"{r['ok']}", flush=True)
            ok = ok and r["ok"]
    print(smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed")
    print(json.dumps({"storage_gemm_times": runs}))
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        time_one(sys.argv[2])
    elif len(sys.argv) > 1:
        sys.exit(main(sys.argv[1:]))
    else:
        sys.exit(__doc__)
