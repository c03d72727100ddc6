#!/usr/bin/env python3
"""Where the chunked WKV6 route's time goes, on one card: the CUDA source
(``src/repro_torch/kernels/csrc/``) copied and text-patched into variants
that each drop or swap one part, every variant built with ``nvcc`` (all at
once) and timed kernel by kernel with ``torch.profiler``.

    python3 scripts/ablate_wkv6.py
    python3 scripts/ablate_wkv6.py --shapes 4x40x4096x64 --iters 20

A variant computes wrong values; only its time is of use. Variants:
``committed`` (the source as it is), ``cvt_rna_split`` (tf32 hi and lo by
``cvt.rna.tf32`` instead of masking the low bits), ``no_triangles`` (the
diagonal block's per-pair exponentials skipped), ``no_quarter`` (its 8 x 8
tensor-core quarter skipped), ``no_products`` (o = r_exc S_c + A v
skipped), ``loads_only`` (the output pass's copies and stores alone),
``state_no_products`` (the state pass's suffix products skipped),
``state_no_mma`` (its update product skipped). Prints one line per
(variant, shape) and, last, the card's name and power limit. Builds go
to ``build/ablate/`` (ignored by git).
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "ablate")

RNA_SPLIT = '''__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(rest));
}
'''
TRIANGLES = ("        sum[m] += rr.x * kr.x",
             "        if (0) sum[m] += rr.x * kr.x")
QUARTER = ("    for (int kk = 0; kk < D; kk += 8) {\n"
           "      const int tt = r0 + 8 + g, s = r0 + g,",
           "    for (int kk = 0; kk < 0; kk += 8) {\n"
           "      const int tt = r0 + 8 + g, s = r0 + g,")
PRODUCTS = [("      mma3(acc[nt], ah, al, sS", "      if (0) mma3(acc[nt], ah, al, sS"),
            ("  for (int kk = 0; kk < r0 + SUB; kk += 8) {",
             "  for (int kk = 0; kk < 0; kk += 8) {")]
# (file, old, new) edits of each variant
VARIANTS = {
    "committed": [],
    "cvt_rna_split": [("warp_mma.cuh", None, RNA_SPLIT)],
    "no_triangles": [("rwkv6_chunk.cu",) + TRIANGLES],
    "no_quarter": [("rwkv6_chunk.cu",) + QUARTER],
    "no_products": [("rwkv6_chunk.cu",) + p for p in PRODUCTS],
    "loads_only": [("rwkv6_chunk.cu",) + p for p in PRODUCTS] + [
        ("rwkv6_chunk.cu",) + TRIANGLES, ("rwkv6_chunk.cu",) + QUARTER,
        ("rwkv6_chunk.cu", "  log_cumsum<D / 64>(qS, LD, n, 8 * warp, 64, "
         "lane);", ""),
        ("rwkv6_chunk.cu", "    if (r0 > 0) {\n      const float* qe",
         "    if (false) {\n      const float* qe")],
    "state_no_products": [("rwkv6_chunk.cu", "    suffix_prod8(pS, decS, "
                           "T_LD, min(C, t_len - c * C), 8 * warp, lane);",
                           "")],
    "state_no_mma": [("rwkv6_chunk.cu", "        mma3(kk % 16 ? odd[nt] : "
                      "acc[nt], ah, al,", "        if (0) mma3(kk % 16 ? "
                      "odd[nt] : acc[nt], ah, al,")],
}


def _patch(name):
    """The variant's copy of csrc/, edited; the split_tf32 of warp_mma.cuh
    is replaced whole where ``old`` is None."""
    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    for fname, old, new in VARIANTS[name]:
        path = os.path.join(d, fname)
        text = open(path).read()
        if old is None:
            start = text.index("__device__ __forceinline__ void split_tf32")
            end = text.index("}\n", start) + 2
            old = text[start:end]
        if old not in text:
            raise SystemExit(f"ablate_wkv6: variant {name} no longer "
                             f"applies to {fname}")
        open(path, "w").write(text.replace(old, new))
    return os.path.join(d, "rwkv6_chunk.cu")


def _build(name):
    src = _patch(name)
    lib = src[:-3] + ".so"
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    proc = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
         "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-o", lib, src],
        capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"ablate_wkv6: {name} failed to build:\n"
                         + proc.stderr[-3000:])
    return name, lib


def main(argv=None):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="4x40x4096x64,4x40x4096x128")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_wkv6: needs a CUDA card")
    os.makedirs(OUT, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(_build, VARIANTS))
    dev = torch.device("cuda")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, path in built:
        fn = ctypes.CDLL(path).rwkv6_chunk_fwd
        fn.argtypes = [ptr] * 9 + [i32] * 4 + [ptr]
        for spec in args.shapes.split(","):
            b, h, t, d = map(int, spec.split("x"))
            gen = torch.Generator(device=dev).manual_seed(0)
            r, k, v = (0.5 * torch.randn(b, h, t, d, generator=gen,
                                         device=dev) for _ in range(3))
            w = torch.exp(-torch.exp(-3.0 + 0.5 * torch.randn(
                b, h, t, d, generator=gen, device=dev)))
            u = 0.3 * torch.randn(h, d, generator=gen, device=dev)
            s0 = 0.1 * torch.randn(b, h, d, d, generator=gen, device=dev)
            o, s_out = torch.empty_like(r), torch.empty_like(s0)
            ws = torch.empty(b * h, -(-t // 64), d, d, device=dev)
            ptrs = [x.data_ptr() for x in (r, k, v, w, u, s0, o, s_out, ws)]

            def call():
                err = fn(*ptrs, b * h, h, t, d,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"ablate_wkv6: {name} launch error "
                                     f"{err}")

            for _ in range(3):
                call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.iters):
                    call()
                torch.cuda.synchronize()
            per = {}
            for ev in prof.key_averages():
                if ev.device_type != DeviceType.CUDA:
                    continue
                kern = next((n for n in ("wkv6_state", "wkv6_output")
                             if n in ev.key), ev.key)
                us = getattr(ev, "self_device_time_total", None)
                if us is None:
                    us = ev.self_cuda_time_total
                per[kern] = per.get(kern, 0.0) + us / 1e3 / args.iters
            print(f"ablate_wkv6 {name} [{b},{h},{t},{d}]: device ms per call "
                  "by kernel " + json.dumps(per), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
