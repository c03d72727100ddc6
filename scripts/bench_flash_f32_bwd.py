#!/usr/bin/env python3
"""The fp32 flash-attention backward (``flash_bwd_dq``, ``flash_bwd_dkdv``)
on one card, in variants: the source of ``csrc/`` as it is
(``committed``), text-patched copies with other loop-tile widths or
output-column slices, and with ``--parent`` another tree's source. Every
variant is built with ``nvcc -Xptxas -v`` (all at once, into
``build/bench_f32_bwd/``), its fp32 backward's registers and spills are
printed by head dim, its dq, dk and dv are held against the plain
version's autograd (``chip_smoke.FLASH_TOL``) at every timed shape, and
its two kernels are timed (CUDA-graph replays, ``chip_smoke.time_ms``) in
turns: every variant in order, then in reverse order. Every variant is
called through this tree's C interface (``tq, tk, q_off`` after ``bh``),
so a ``--parent`` tree must have it too.

    python3 scripts/bench_flash_f32_bwd.py --parent build/parent
    python3 scripts/bench_flash_f32_bwd.py --variants committed \\
        --shapes 128x1024x64,256x256x128

A shape is ``BHxTxD`` (fp32) or ``BHxTxDxbf16`` (the bf16 kernels, which
the variants share: to hold the two trees' bf16 backward alike), causal,
no window, no softcap. Prints one line per
(variant, head dim) of ptxas, per (variant, shape) of checks and per
(round, variant, shape) of times and, first, the card's name and power
limit. Exits non-zero if a variant fails to build or disagrees.
"""
import argparse
import ctypes
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "bench_f32_bwd")

DKDV_COLS = ("__host__ __device__ constexpr int dkdv_f32_cols() { return "
             "tc_split<D, 144>(); }")
LOOP_COLS = "  return D >= 128 ? 16 : tc_cols<D>();"
# (old, new) edits of flash_attention.cu of each variant, each at the
# first place where `old` stands
VARIANTS = {
    "committed": [],
    # loop tiles 32 wide at D = 128 and 144, or 16 wide from D = 64 on
    "loop_32_at_128": [(LOOP_COLS, "  return D > 144 ? 16 : tc_cols<D>();")],
    "loop_16_at_64": [(LOOP_COLS, "  return D >= 64 ? 16 : tc_cols<D>();")],
    # dkdv's output columns at most 128 a block (three slices of 48 at
    # D = 144)
    "dkdv_cols_128": [(DKDV_COLS, DKDV_COLS.replace("144", "128"))],
}
SHAPES = "128x1024x64,256x256x128,256x256x144,256x32x16,64x1024x256"
# the kernels whose ptxas lines are printed
KERNELS = ("flash_bwd_dq", "flash_bwd_dkdv", "flash_bwd_dq_tc",
           "flash_bwd_dkdv_tc")


def _copy(name, src_dir, edits):
    """``src_dir`` copied to the variant's directory and edited; returns
    its flash_attention.cu."""
    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src_dir, d)
    path = os.path.join(d, "flash_attention.cu")
    text = open(path).read()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"bench_flash_f32_bwd: variant {name} no "
                             f"longer applies")
        text = text.replace(old, new, 1)
    open(path, "w").write(text)
    return path


def _build(item):
    name, src = item
    lib = src[:-3] + ".so"
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    proc = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
         "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         "-o", lib, src], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"bench_flash_f32_bwd: {name} failed to build:\n"
                         + proc.stderr[-3000:])
    return name, lib, proc.stdout + proc.stderr


def main(argv=None):
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--parent", default=None,
                    help="a tree whose csrc/ is built as variant 'parent'")
    ap.add_argument("--shapes", default=SHAPES)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash_f32_bwd: needs a CUDA card")
    print(cs.card_line(), torch.__version__, torch.version.cuda, flush=True)
    os.makedirs(OUT, exist_ok=True)
    jobs = [(n, _copy(n, CSRC, VARIANTS[n]))
            for n in args.variants.split(",")]
    if args.parent:
        jobs.insert(0, ("parent", _copy("parent", os.path.join(
            os.path.abspath(args.parent), "src", "repro_torch", "kernels",
            "csrc"), [])))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(_build, jobs))
    libs = {}
    for name, path, log in built:
        table = cs.ptxas_table(log)
        for kern in KERNELS:
            print(f"bench ptxas {name} {kern}: " + "; ".join(
                f"D={d}: {v.get('registers')} registers, spill stores "
                f"{v.get('spill_stores')} B, loads {v.get('spill_loads')} B"
                for (k, d), v in sorted(table.items()) if k == kern),
                flush=True)
        lib = ctypes.CDLL(path)
        for fn, argtypes in fa._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs, bad = {}, 0
    for spec in args.shapes.split(","):
        dims = spec.split("x")
        bh, t, d = map(int, dims[:3])
        bf16 = dims[3:] == ["bf16"]
        atol, rtol = cs.FLASH_TOL["bfloat16" if bf16 else "float32"]
        q, k, v, do = (torch.randn(bh, t, d, generator=gen, device=dev).to(
            torch.bfloat16 if bf16 else torch.float32) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v)
        rs = [x.float().requires_grad_(True) for x in (q, k, v)]
        want = torch.autograd.grad(ref.flash_attention_ref(*rs), rs,
                                   do.float())
        outs = [torch.empty_like(q) for _ in range(3)]
        delta = torch.empty_like(lse)
        common = (bh, t, t, 0, d, int(bf16), 1, 0, 0.0, d ** -0.5)

        # the C interface's calls, each on the stream current when it runs
        # (a graph captures on its own)
        def calls(lib, q=q, k=k, v=v, o=o, do=do, lse=lse, delta=delta,
                  outs=outs, common=common):
            def dq_call():
                return lib.flash_attention_bwd_dq(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    outs[0].data_ptr(), *common,
                    torch.cuda.current_stream().cuda_stream)

            def dkdv_call():
                return lib.flash_attention_bwd_dkdv(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), outs[1].data_ptr(),
                    outs[2].data_ptr(), *common,
                    torch.cuda.current_stream().cuda_stream)

            return dq_call, dkdv_call

        for name, lib in libs.items():
            for outs_i in outs:
                outs_i.fill_(float("nan"))
            for call in calls(lib):
                if call() != 0:
                    raise SystemExit(f"bench_flash_f32_bwd: {name} launch "
                                     f"failed at {spec}")
            torch.cuda.synchronize()
            errs = [(a.float() - w).abs().max().item()
                    for a, w in zip(outs, want)]
            ok = all(torch.allclose(a.float(), w, rtol=rtol, atol=atol)
                     for a, w in zip(outs, want))
            bad += not ok and not bf16
            print(f"bench check {name} [{spec}] causal: max_abs_err dq "
                  f"{errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} "
                  f"{'ok' if ok else 'MISMATCH'}"
                  + (" (bf16: reported, not held)" if bf16 else ""),
                  flush=True)
        inputs[spec] = calls
        del rs, want
        torch.cuda.empty_cache()

    order = list(libs)
    for rnd, names in enumerate((order, order[::-1])):
        for name in names:
            for spec, calls in inputs.items():
                dq_call, dkdv_call = calls(libs[name])
                ms_dq = cs.time_ms(dq_call, iters=args.iters)
                ms_dkdv = cs.time_ms(dkdv_call, iters=args.iters)
                print(f"bench timing round {rnd} {name} [{spec}] causal: "
                      f"dq {ms_dq:.5f} ms, dkdv {ms_dkdv:.5f} ms, total "
                      f"{ms_dq + ms_dkdv:.5f} ms", flush=True)
    print(f"bench checks failed: {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
