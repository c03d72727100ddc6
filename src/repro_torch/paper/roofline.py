"""Roofline table (port of ``benchmarks/roofline.py``): reads the dry run's
rows (``python -m repro_torch.launch.dryrun --all --out PATH``: every
arch x input shape counted on the meta device and put on the H100's
roofline) and prints the per-(arch x shape x mesh) roofline terms in the
reference's CSV. The rows are counts, not device times; the reference
times no step either."""
from __future__ import annotations

import json
import os

from repro_torch.paper import OUT_DIR

DEFAULT = os.path.join(OUT_DIR, "dryrun_all.json")


def run(csv=True, path=DEFAULT):
    if not os.path.exists(path):
        print(f"# roofline: {path} not found — run "
              "`python -m repro_torch.launch.dryrun --all --out "
              f"{path}` first")
        return []
    with open(path) as f:
        rows = json.load(f)
    if csv:
        print("roofline,arch,shape,mesh,status,t_compute_s,t_memory_s,"
              "t_collective_s,bottleneck,useful_fraction,temp_GB_per_dev")
    for r in rows:
        if r["status"] != "ok":
            print(f"roofline,{r['arch']},{r['shape']},{r.get('mesh','')},"
                  f"{r['status']},,,,,,")
            continue
        print(f"roofline,{r['arch']},{r['shape']},{r['mesh']},ok,"
              f"{r['t_compute_s']:.4f},{r['t_memory_s']:.4f},"
              f"{r['t_collective_s']:.4f},{r['bottleneck']},"
              f"{r['useful_fraction']:.3f},"
              f"{(r.get('temp_bytes_per_device') or 0)/1e9:.1f}")
    return rows


if __name__ == "__main__":
    run()
