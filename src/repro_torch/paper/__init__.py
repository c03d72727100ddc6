"""The reference's benchmark suites on the PyTorch port (port of
``benchmarks/``): the paper's Fig. 2 (Eq.-3 FedAvg bias), Fig. 3 (the
quadratic counterexample), Table 1 (final accuracy grid), Table 2 (rounds
to target accuracy) and Fig. 8 (ablations); ``asha`` (adaptive search
against the exhaustive lr grid, on Table 2's targets); and ``run.py``'s
other suites: ``extensions`` (FedPBC-M against FedPBC), ``kernels_bench``
(every kernel family against its plain version), ``roofline`` (the dry
run's rows), ``scale`` (the cohort + buffered ladder), ``throughput``
(per-round dispatch against the multi-round engine), ``sweep_throughput``
(the batched sweep against its baselines on four axes) and ``lm_sweep``
(the LM family on one device and a 2-D mesh). ``common`` holds the
reference's one-call protocol ``run_training``.

Each module's ``run(...)`` has the reference's signature, defaults, CSV
view, ``BENCH`` keys and return value; the suites that run rounds also take
``device`` (``None``: the card, raising without one) and ``use_kernel``
(``None``: the ``REPRO_USE_KERNEL`` default). Outputs default to
``build/paper/`` of the checkout (``OUT_DIR``): the results store
``build/paper/sweeps`` (Table 1), Table 2's JSON, ``asha.json`` and each
later suite's JSON; nothing is written under ``benchmarks/out/``. All 13
from one command::

    python -m repro_torch.paper.run --list
    python -m repro_torch.paper.run --only fig2,table1 --rounds 250
"""
import os

# build/paper/ of the checkout holding this package (src/repro_torch/paper)
OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))), "build", "paper")
