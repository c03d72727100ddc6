"""``python -m repro_torch.experiments`` — alias for the sweep CLI (avoids the
runpy double-import warning ``-m repro_torch.experiments.sweep`` prints)."""
from repro_torch.experiments.sweep import main

if __name__ == "__main__":
    main()
