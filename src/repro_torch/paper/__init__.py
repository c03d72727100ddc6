"""The paper's tables and figures on the PyTorch port (port of the paper
suites of the reference's ``benchmarks/``): Fig. 2 (Eq.-3 FedAvg bias),
Fig. 3 (the quadratic counterexample), Table 1 (final accuracy grid),
Table 2 (rounds to target accuracy) and Fig. 8 (ablations); and the
reference's ASHA-vs-grid suite (``asha``: adaptive search against the
exhaustive lr grid, on Table 2's targets).

Each module's ``run(...)`` has the reference's signature, defaults, CSV
view and return value; the suites that run rounds also take ``device``
(``None``: the card, raising without one) and ``use_kernel`` (``None``:
the ``REPRO_USE_KERNEL`` default). Outputs default to ``build/paper/`` of
the checkout: the results store ``build/paper/sweeps`` (Table 1),
Table 2's JSON and ``asha.json``. All six from one command::

    python -m repro_torch.paper.run --list
    python -m repro_torch.paper.run --only fig2,table1 --rounds 250
"""
import os

# build/paper/ of the checkout holding this package (src/repro_torch/paper)
OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))), "build", "paper")
