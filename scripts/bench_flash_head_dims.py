#!/usr/bin/env python3
"""The flash-attention kernels at head dims above 128, on one card: build
``csrc/flash_attention.cu`` (its ``nvcc`` wall seconds and every
kernel's registers and spills), hold forward and backward against the
plain version at small shapes of D = 144, 256 and a padded 40 in both
dtypes (``chip_smoke.py``'s ``check_flash_shape`` and ``FLASH_TOL``), then
time the three kernels, causal with no window, at ``[16, 8192, D]`` bf16
and ``[64, 1024, D]`` fp32 for D = 144 and 256 (CUDA-graph replays).

    python3 scripts/bench_flash_head_dims.py

Prints one line per check and timing and, first, the card's name and
power limit. Exits non-zero if a check fails.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

# (b, h, t, d, window, softcap, dtype, causal)
CHECKS = [(1, 2, 256, 144, 0, 0.0, "float32", True),
          (1, 2, 256, 144, 0, 0.0, "bfloat16", True),
          (1, 2, 200, 256, 0, 0.0, "float32", True),
          (1, 2, 512, 256, 128, 50.0, "bfloat16", True),
          (1, 2, 256, 256, 0, 0.0, "bfloat16", False),
          (1, 2, 256, 40, 0, 0.0, "float32", True),
          (1, 2, 256, 40, 0, 0.0, "bfloat16", True),
          (2, 2, 256, 64, 0, 0.0, "bfloat16", True),
          (2, 2, 256, 64, 0, 0.0, "float32", True)]
# (bh, t) of the timed shapes by dtype
TIMED = {"bfloat16": (16, 8192), "float32": (64, 1024)}


def main():
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("bench_flash_head_dims: needs a CUDA card")
    print(cs.card_line(), torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    logs = build.compile_all([fa.SOURCE])
    print(f"nvcc build of {fa.SOURCE.name}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    cs.print_ptxas("bench", logs[fa.SOURCE.name])
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    for shape in CHECKS:
        try:
            cs.check_flash_shape(torch, fa, ref, gen, shape, "bench")
        except SystemExit:
            bad += 1
    for d in (144, 256):
        for name, (bh, t) in TIMED.items():
            dt = getattr(torch, name)
            q, k, v, do = (torch.randn(bh, t, d, generator=gen, device="cuda",
                                       dtype=torch.float32).to(dt)
                           for _ in range(4))
            o, lse = fa.flash_attention_fwd(q, k, v)
            dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse)
            ms = {"fwd": cs.time_ms(lambda: fa.flash_attention_fwd(q, k, v),
                                    iters=5),
                  "dq": cs.time_ms(lambda: fa.flash_attention_bwd_dq(
                      q, k, v, o, do, lse), iters=5),
                  "dkdv": cs.time_ms(lambda: fa.flash_attention_bwd_dkdv(
                      q, k, v, do, lse, delta), iters=5)}
            print(f"bench timing [{bh},{t},{d}] {name} causal: " + ", ".join(
                f"{kk} {v:.5f} ms" for kk, v in ms.items()), flush=True)
            del q, k, v, do, o, lse, dq, delta
    print(f"bench checks failed: {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
