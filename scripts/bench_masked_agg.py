"""Time the fused aggregation kernel at several block sizes, on one card.

At the two shapes of ``chip_smoke.py`` phase 1, the Table-1 family cell
``[12, 100, 2762]`` fp32 and the LM's ``[1, 8, 134,515,008]`` bf16, it
launches the Triton kernel of ``repro_torch.kernels.masked_agg`` at every
candidate ``(num_warps, 16-byte loads a thread makes of each row)`` and
through the wrapper (what ``block_sizes`` picks), holds each against the
plain version, and times each as device time per call (CUDA-graph replays,
``chip_smoke.time_ms``), beside one ``torch.bmm`` of the same weighted sum.
With ``--parent DIR`` (an unpacked tree of another commit) it also times
that tree's wrapper on the same inputs, in turns: parent, this, this,
parent. Prints one JSON line and writes it to ``--out``.

    python3 scripts/bench_masked_agg.py --parent build/parent
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build",
                                                       "triton-cache"))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

CANDIDATES = [(w, c) for w in (1, 2, 4, 8) for c in (1, 2, 4)]


def _parent_wrapper(tree: str):
    """``fused_masked_agg`` of another tree's ``masked_agg.py``, loaded
    under its own module name (its imports resolve to this tree's
    ``dispatch`` and ``ref``)."""
    path = os.path.join(tree, "src", "repro_torch", "kernels",
                        "masked_agg.py")
    spec = importlib.util.spec_from_file_location("parent_masked_agg", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.fused_masked_agg


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/bench_masked_agg.json")
    ap.add_argument("--parent", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_masked_agg: needs a CUDA card")
    from chip_smoke import LM_N, agg_work, peak_rates, time_ms
    from repro_torch.kernels import masked_agg as masked
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    bw = peak_rates(torch.cuda.get_device_name(0))[0]
    parent = _parent_wrapper(args.parent) if args.parent else None

    def inputs(B, m, n, ops, dtype):
        x = torch.randn(B, m, n, generator=gen, device=dev).to(dtype)
        mask = torch.rand(B, m, generator=gen, device=dev) < 0.5
        mask[:, :2] = True
        p = torch.rand(B, m, generator=gen, device=dev)
        prev = torch.randn(B, n, generator=gen, device=dev)
        op = torch.as_tensor(ops, dtype=torch.int32, device=dev)
        return x, mask, op, prev, p

    result = {"card": card, "shapes": {}}
    for label, (B, m, n, ops, dtype, iters) in {
            "table1 [12,100,2762] fp32": (
                12, 100, 2762, [o for o in (0, 0, 1, 2) for _ in range(3)],
                torch.float32, 100),
            f"LM [1,8,{LM_N}] bf16": (1, 8, LM_N, [0], torch.bfloat16,
                                      10)}.items():
        x, mask, op, prev, p = ins = inputs(B, m, n, ops, dtype)
        want = ref.fused_masked_agg_ref(*ins)
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        block_m = masked.block_sizes(m, dtype)[0]
        vec = 16 // x.element_size()
        rows = {}
        for w, c in CANDIDATES:
            block_n = 32 * w * vec * c
            out = torch.empty_like(prev)

            def run(block_n=block_n, w=w, out=out):
                masked._kernel()[(-(-n // block_n), B)](
                    x, mask.view(torch.uint8), p, prev, op, out, m, n,
                    float(m), BLOCK_M=block_m, BLOCK_N=block_n, num_warps=w)

            run()
            torch.cuda.synchronize()
            if not torch.allclose(out, want, rtol=tol, atol=tol):
                raise SystemExit(f"{label} warps {w} x {c}: mismatch")
            rows[f"BLOCK_N {block_n} warps {w}"] = time_ms(run, iters)
        turns = {"this (block_sizes "
                 f"{masked.block_sizes(m, dtype)})": lambda: (
                     masked.fused_masked_agg(*ins))}
        if parent is not None:
            got = parent(*ins)
            torch.cuda.synchronize()
            if not torch.allclose(got, want, rtol=tol, atol=tol):
                raise SystemExit(f"{label}: the parent's kernel mismatches")
            turns["parent"] = lambda: parent(*ins)
        order = (["parent", None, None, "parent"] if parent is not None
                 else [None, None])
        this_key = next(iter(turns))
        for key in order:
            key = key or this_key
            rows.setdefault(key, []).append(time_ms(turns[key], iters))
        mk = mask.float()
        wts = torch.where((op == 2)[:, None], mk / p.clamp_min(1e-3) / m,
                          torch.where((op == 1)[:, None], mk / m, mk))
        wts = wts.to(dtype)[:, None, :]
        rows["torch.bmm"] = time_ms(lambda: torch.bmm(wts, x), iters)
        nbytes, _ = agg_work(x, mask, op)
        rows["bound_ms"] = nbytes / bw * 1e3
        result["shapes"][label] = rows
        print(label, json.dumps(rows), flush=True)
        del x, mask, op, prev, p, ins, want, wts
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
