"""The port's gate: tracelint (static) + sanitizers (runtime), the
counterpart of ``repro.analysis``.

Static half (stdlib-only: imports neither torch nor the reference)::

    python -m repro_torch.analysis src/repro_torch \\
        --baseline .tracelint-torch-baseline.json

Runtime half (imports torch on demand — ``from repro_torch.analysis
import HostSyncSanitizer``): runner pins and the host-sync census.
"""
from repro_torch.analysis.rules import RULES, Finding, Rule

__all__ = ["RULES", "Finding", "Rule", "lint_paths", "lint_text",
           "assert_no_new_runners", "RunnerSanitizer", "HostSyncSanitizer"]

_LINT = {"lint_paths", "lint_text", "lint_file", "main", "STEP_CONTEXTS",
         "host_sync_sites", "unmatched_sites"}
_SANITIZE = {"assert_no_new_runners", "RunnerSanitizer", "runner_count",
             "HostSyncSanitizer", "SyncEvent"}


def __getattr__(name):
    # keep `import repro_torch.analysis` torch-free; pull the halves on
    # demand
    if name in _LINT:
        from repro_torch.analysis import lint
        return getattr(lint, name)
    if name in _SANITIZE:
        from repro_torch.analysis import sanitize
        return getattr(sanitize, name)
    raise AttributeError(name)
