#!/usr/bin/env python3
"""The flash kernels' self-attention route of this tree against another
tree's, bit for bit, on one card. Both trees' ``csrc/flash_attention.cu``
are built with ``nvcc`` (``kernels.build.compile_all``, in parallel; the
other tree's under the name ``flash_attention_parent.cu``, written beside
its source) and called on the same inputs through their own C
interfaces: this tree's with ``tk = t`` and ``q_off = 0`` after ``bh,
t``; with ``--old-interface`` the other tree's without them (a tree from
before the causal-offset route). At each shape the forward, dq and dkdv
run in both, and every output (o, lse, dq, delta, dk, dv) is compared
with ``torch.equal``. With ``--time`` each kernel of both libraries is
also timed at each shape (CUDA-graph replays, ``chip_smoke.time_ms``) in
turns: the other tree, this tree, this tree, the other tree, and both
trees' registers by kernel instantiation are printed.

    python3 scripts/flash_aligned_bitwise.py --parent build/parent \\
        --old-interface --time

Shapes (``bh, t, d, dtype, window, softcap``, causal): the LM sweep's fp32
``[256, 32, 16]`` and ``[256, 256, 128]``, the LM path's bf16
``[144, 2048, 64]``, and gemma2's masks at D = 256 (bf16 ``[4, 1024,
256]``, window 512, softcap 50). Prints one JSON line a shape and a last
line ``{"bitwise": true|false, ...}`` (with ``--time``, each shape's line
holds ``ms``: each kernel's times by tree, in the order run); exits 1
unless every output is equal.
"""
import argparse
import ctypes
import json
import os
import re
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SHAPES = ((256, 32, 16, "float32", 0, 0.0),
          (256, 256, 128, "float32", 0, 0.0),
          (144, 2048, 64, "bfloat16", 0, 0.0),
          (4, 1024, 256, "bfloat16", 512, 50.0))
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C interface before the causal-offset route: (..., bh, t, d, bf16,
# causal, window, cap, scale, stream)
OLD_SIGNATURES = {
    "flash_attention_fwd": [_P] * 5 + [_I] * 6 + [_F, _F, _P],
    "flash_attention_bwd_dq": [_P] * 8 + [_I] * 6 + [_F, _F, _P],
    "flash_attention_bwd_dkdv": [_P] * 8 + [_I] * 6 + [_F, _F, _P],
}


def _bind(path: Path, signatures) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _kernels(lib, old: bool, q, k, v, do, window: int, cap: float):
    """One library's three launches on these inputs, each writing its own
    outputs (launched on the stream current at the call): ``({"fwd",
    "dq", "dkdv"}: launch, (o, lse, dq, delta, dk, dv))``."""
    bh, t, d = q.shape
    lens = (bh, t) if old else (bh, t, t, 0)
    tail = (d, int(q.dtype == torch.bfloat16), 1, window, cap, d ** -0.5)
    o, lse = torch.empty_like(q), torch.empty(bh, t, device=q.device)
    dq, delta = torch.empty_like(q), torch.empty_like(lse)
    dk, dv = torch.empty_like(k), torch.empty_like(v)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    launch = {
        "fwd": lambda: lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), *lens, *tail, stream()),
        "dq": lambda: lib.flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *lens, *tail, stream()),
        "dkdv": lambda: lib.flash_attention_bwd_dkdv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *lens, *tail, stream())}
    return launch, (o, lse, dq, delta, dk, dv)


def _registers(log: str) -> dict:
    """Registers by kernel instantiation (its mangled name's
    ``flash_...ILi<D>E...`` part) from an ``nvcc -Xptxas -v`` report."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '_Z\w*?\d(flash_\w+?)EvP", line)
        if m:
            key = m.group(1)
        elif key and "Used" in line and "registers" in line:
            out[key] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def _run(launch, outs):
    """The forward, dq and dkdv in order; their outputs."""
    calls = [launch[n]() for n in ("fwd", "dq", "dkdv")]
    torch.cuda.synchronize()
    if any(calls):
        raise SystemExit(f"flash_aligned_bitwise: a launch failed: {calls}")
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a tree whose src/repro_torch/kernels/csrc/"
                         "flash_attention.cu is compared with this one's")
    ap.add_argument("--old-interface", action="store_true",
                    help="the parent's C interface lacks tk and q_off")
    ap.add_argument("--time", action="store_true",
                    help="also time both trees' kernels in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_aligned_bitwise: needs a CUDA card")
    csrc = (Path(os.path.abspath(args.parent)) / "src" / "repro_torch"
            / "kernels" / "csrc")
    # under its own name beside its headers: compile_all reports by name
    parent = csrc / "flash_attention_parent.cu"
    shutil.copyfile(csrc / "flash_attention.cu", parent)
    logs = build.compile_all([fa.SOURCE, parent])
    ours = _bind(build.library_path(fa.SOURCE), fa._SIGNATURES)
    theirs = _bind(build.library_path(parent),
                   OLD_SIGNATURES if args.old_interface else fa._SIGNATURES)
    gen = torch.Generator(device="cuda").manual_seed(0)
    equal = True
    for bh, t, d, dtype, window, cap in SHAPES:
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.randn(bh, t, d, generator=gen, device="cuda")
                       .to(dt) for _ in range(4))
        mine = _kernels(ours, False, q, k, v, do, window, cap)
        other = _kernels(theirs, args.old_interface, q, k, v, do, window,
                         cap)
        a, b = _run(*mine), _run(*other)
        same = {n: bool(torch.equal(x, y)) for n, x, y in zip(
            ("o", "lse", "dq", "delta", "dk", "dv"), a, b)}
        equal = equal and all(same.values())
        row = {"shape": [bh, t, d], "dtype": dtype, "window": window,
               "softcap": cap, "equal": same}
        if args.time:
            from chip_smoke import time_ms

            turns = (("parent", other), ("this", mine), ("this", mine),
                     ("parent", other))
            row["ms"] = {n: [[tree, time_ms(launch[n], iters=20)]
                             for tree, (launch, _) in turns]
                         for n in ("fwd", "dq", "dkdv")}
        print(json.dumps(row), flush=True)
    if args.time:
        print(json.dumps({"registers": {
            name: _registers(log) for name, log in logs.items()}}),
            flush=True)
    print(json.dumps({"bitwise": equal,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
