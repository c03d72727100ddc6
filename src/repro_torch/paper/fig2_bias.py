"""Fig. 2: expected FedAvg output vs p2 for the 2-client scalar example
(u1=0, u2=100, p1=0.5). Analytic — validates Eq. (3) visually (port of
``benchmarks/fig2_bias.py``; closed-form numpy, nothing runs on a device)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.bias import fedavg_fixed_point, two_client_fixed_point


def run(csv=True):
    rows = []
    for p2 in np.linspace(0.05, 1.0, 20):
        closed = two_client_fixed_point(0.0, 100.0, 0.5, p2)
        series = fedavg_fixed_point(np.array([0.5, p2]),
                                    np.array([[0.0], [100.0]]))[0]
        paper = 150.0 * p2 / (p2 + 1.0)
        rows.append((p2, closed, series, paper))
        if not abs(closed - paper) < 1e-9:
            raise AssertionError((p2, closed, paper))
        # the Eq.-(3) geometric series must agree with both closed forms
        # (truncated at machine precision, hence the looser tolerance)
        if not abs(series - paper) < 1e-6:
            raise AssertionError((p2, series, paper))
    if csv:
        print("fig2_bias,p2,E_x_fedavg,E_x_series,paper_formula")
        for p2, c, s, f in rows:
            print(f"fig2_bias,{p2:.3f},{c:.4f},{s:.4f},{f:.4f}")
    return rows


if __name__ == "__main__":
    run()
