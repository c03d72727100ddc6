#!/usr/bin/env python3
"""The meshed dry run of every arch at ``reduced()`` size and the short
shapes of ``tests/test_torch_dryrun_mesh.py``, on both production meshes
(``16x16`` and ``2x16x16``): each row's status, then the counts of ``ok``,
``skip`` and ``FAIL`` rows, and each FAIL row's error. No card is used;
run it where the torch release of interest is installed (the card's host
runs another release than a CPU sandbox may, and DTensor's rules differ
between releases).

    PYTHONPATH=src python3 scripts/dryrun_short_meshes.py
    PYTHONPATH=src python3 scripts/dryrun_short_meshes.py \
        --arch rwkv6-3b,jamba-1.5-large-398b

Prints one JSON line a row (its key fields) and a last JSON line
``{"torch": ..., "ok": n, "skip": n, "FAIL": n, "failed": [...]}``.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import ShapeConfig, get_config, reduced  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

# tests/test_torch_dryrun_mesh.py's SHORT
SHORT = {"train_4k": ShapeConfig("train_4k", 128, 32, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 256, 32, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 256, 32, "decode"),
         "long_500k": ShapeConfig("long_500k", 512, 1, "decode")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None,
                    help="archs, comma-separated (default: all)")
    args = ap.parse_args(argv)
    dryrun.INPUT_SHAPES = SHORT
    dryrun.get_config = lambda arch: reduced(get_config(arch))
    archs = args.arch.split(",") if args.arch else list(dryrun.ARCH_IDS)
    counts = {"ok": 0, "skip": 0, "FAIL": 0}
    failed = []
    for multi_pod in (False, True):
        for arch in archs:
            for shape in SHORT:
                r = dryrun.lower_pair(arch, shape, multi_pod=multi_pod,
                                      verbose=False)
                status = r["status"]
                counts[status] = counts.get(status, 0) + 1
                mesh = "2x16x16" if multi_pod else "16x16"
                line = {"arch": arch, "shape": shape, "mesh": mesh,
                        "status": status}
                if status == "FAIL":
                    err = (r.get("error") or r.get("trace") or "")
                    line["error"] = str(err).strip().splitlines()[-1:]
                    failed.append(line)
                print(json.dumps(line), flush=True)
    print(json.dumps({"torch": torch.__version__, **counts,
                      "failed": failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
