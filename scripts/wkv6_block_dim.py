#!/usr/bin/env python3
"""The WKV6 block route (``rwkv6_chunk.fold_blocks``: a head dim above 128
as (key block, value block) pairs folded into the head axis) at each block
size the kernels take, 64 and 128, on one card: the numbers that
``rwkv6_chunk.BLOCK_DIM`` is chosen by. At each of ``chip_smoke``'s
``WIDE_WKV_SHAPES``, from a non-zero ``s0`` with a non-zero ``dS_T``, the
route runs with ``BLOCK_DIM`` set to each size in turns (128, 64, 64,
128): the forward over the chunked route (CUDA-graph replays,
``chip_smoke.time_ms``) and the autograd backward over
``rwkv6_chunk_autograd`` (CUDA events, ``chip_smoke.time_ms_events``),
the folds' copies included. The two sizes' outputs are held against each
other within ``chip_smoke.WKV_TOL``.

    python3 scripts/wkv6_block_dim.py

Prints one JSON line a shape (``ms``, ``backward_ms``: each size's times
in the order run) and a last line ``{"card": "<name, power limit>",
"agree": true|false}``; exits 1 unless the sizes agree.
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import rwkv6_chunk as rk  # noqa: E402

SIZES = (128, 64, 64, 128)


def _run(ins, do, ds_t, db):
    """The forward's and the autograd backward's times, and the outputs,
    in blocks of ``db``."""
    rk.BLOCK_DIM = db
    ms = cs.time_ms(lambda: rk.rwkv6_chunk(*ins, route="chunked"), iters=50)
    leaves = [x.clone().requires_grad_(True) for x in ins]
    o, s_t = rk.rwkv6_chunk_autograd(*leaves)
    bwd = cs.time_ms_events(lambda: torch.autograd.grad(
        [o, s_t], leaves, [do, ds_t], retain_graph=True), iters=10)
    return ms, bwd, (o.detach(), s_t.detach())


def main() -> int:
    if not torch.cuda.is_available():
        print("wkv6_block_dim: no CUDA device", file=sys.stderr)
        return 1
    build.compile_all([rk.SOURCE, rk.BWD_SOURCE])
    gen = torch.Generator(device="cuda").manual_seed(26)
    agree = True
    for shape in cs.WIDE_WKV_SHAPES:
        ins, do, ds_t = cs._wkv_bwd_inputs(torch, gen, *shape, "ref")
        row = {"shape": list(shape), "ms": {}, "backward_ms": {}}
        outs = {}
        for db in SIZES:
            ms, bwd, outs[db] = _run(ins, do, ds_t, db)
            row["ms"].setdefault(f"Db={db}", []).append(ms)
            row["backward_ms"].setdefault(f"Db={db}", []).append(bwd)
        row["agree"] = all(torch.allclose(a, b, rtol=cs.WKV_TOL,
                                          atol=cs.WKV_TOL)
                           for a, b in zip(outs[64], outs[128]))
        agree &= row["agree"]
        print(json.dumps(row), flush=True)
        del ins, do, ds_t, outs
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "agree": agree}), flush=True)
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
