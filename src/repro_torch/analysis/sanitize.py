"""Runtime sanitizers: the dynamic half of the port's gate (port of
``repro.analysis.sanitize``).

``RunnerSanitizer`` / ``assert_no_new_runners`` are the counterpart of the
reference's compile pins. The port compiles no program per cell; what it
must not multiply are the objects a new hyperparameter value could build
anew: segment runners (``grid.segment_runner_for.built``), Triton
specialisations of the aggregation kernel
(``masked_agg.compiled_specializations()``, the analogue of jit's
``_cache_size``) and the CUDA libraries (the ``lru_cache``s of
``flash_attention._library``, ``rwkv6_chunk._library`` and
``_bwd_library``). Two modes, one entry point::

    # exact-total: check immediately
    assert_no_new_runners(grid.segment_runner_for, expect_total=1)

    # delta: wrap a region that must not build anything new
    with assert_no_new_runners(masked_agg.compiled_specializations):
        grid.run_sweep(spec_at_other_hparams)

A probe is an object with an int ``built``, an ``lru_cache``d function
(its ``cache_info().currsize``) or a function of no arguments returning an
int or None. Where a probe gives None (or is none of these) the check is a
no-op for it and ``has_introspection`` is false, as in the reference.

No ``DonationSanitizer``: eager PyTorch has no ``donate_argnums``; a
round makes new tensors and nothing is consumed
(``repro_torch.experiments.sweep``'s runner says the same).

``HostSyncSanitizer`` is the runtime half of R001/R002: it records each
host sync the card reports in a region, as the innermost frame of the
port's package that was running (file and line) and whether the stack
passed through a step context of ``lint.STEP_CONTEXTS``.
"""
from __future__ import annotations

import inspect
import sys
import warnings
from dataclasses import dataclass
from pathlib import Path
from types import FrameType
from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch

from repro_torch.analysis.lint import (LOOP_SUFFIX, PACKAGE_DIR, REPO_ROOT,
                                       STEP_CONTEXTS, loop_lines)

#: the message of ``torch.cuda.set_sync_debug_mode("warn")``'s warning
SYNC_MESSAGE = "called a synchronizing CUDA operation"


def runner_count(probe: Any) -> Optional[int]:
    """The count behind ``probe`` (see the module doc), or None when it
    has none."""
    built = getattr(probe, "built", None)
    if isinstance(built, int):
        return built
    info = getattr(probe, "cache_info", None)
    if callable(info):
        return info().currsize
    if callable(probe):
        try:
            params = inspect.signature(probe).parameters.values()
        except (TypeError, ValueError):
            return None
        if all(p.default is not p.empty or p.kind in (p.VAR_POSITIONAL,
                                                      p.VAR_KEYWORD)
               for p in params):
            n = probe()
            return n if isinstance(n, int) else None
    return None


class RunnerSanitizer:
    """Pins the growth of one or more runner/build counters.

    ``expect_total=N``: every probe must count exactly N at check time.
    ``expect_total=None``: at most ``max_new`` may appear between
    construction (snapshot) and check — use as a context manager around a
    region that must build nothing new.
    """

    def __init__(self, *probes: Any, expect_total: Optional[int] = None,
                 max_new: int = 0, label: str = ""):
        if not probes:
            raise ValueError("RunnerSanitizer needs at least one probe")
        self.probes = probes
        self.expect_total = expect_total
        self.max_new = max_new
        self.label = label
        self._start: List[Optional[int]] = [runner_count(p) for p in probes]

    @property
    def has_introspection(self) -> bool:
        """True when every probe gives a count."""
        return all(s is not None for s in self._start)

    def check(self) -> "RunnerSanitizer":
        tag = f" [{self.label}]" if self.label else ""
        for probe, start in zip(self.probes, self._start):
            now = runner_count(probe)
            if now is None:
                continue            # no introspection: nothing to pin
            name = getattr(probe, "__name__", repr(probe))
            if self.expect_total is not None:
                if now != self.expect_total:
                    raise AssertionError(
                        f"runner sanitizer{tag}: {name} counts {now}, "
                        f"expected exactly {self.expect_total} — a "
                        f"hyperparameter leaked into a runner key")
            else:
                grown = now - (start or 0)
                if grown > self.max_new:
                    raise AssertionError(
                        f"runner sanitizer{tag}: {name} grew by {grown} "
                        f"(allowed {self.max_new}) — the guarded region "
                        f"built a new runner or specialisation")
        return self

    def __enter__(self) -> "RunnerSanitizer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.check()


def assert_no_new_runners(*probes: Any, expect_total: Optional[int] = None,
                          max_new: int = 0,
                          label: str = "") -> RunnerSanitizer:
    """One entry point for both counter idioms (see module doc).

    With ``expect_total`` the check runs immediately; without it the
    returned sanitizer snapshots now and checks on ``with``-exit (or an
    explicit ``.check()``).
    """
    sanitizer = RunnerSanitizer(*probes, expect_total=expect_total,
                                max_new=max_new, label=label)
    if expect_total is not None:
        sanitizer.check()
    return sanitizer


# ---------------------------------------------------------------------------
# Host syncs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SyncEvent:
    """One host sync: the innermost frame of the package that was running
    (``file`` relative to the repository root, ``line``, ``function`` its
    qualified name), and whether a step context was on the stack."""

    file: str
    line: int
    function: str
    in_step: bool

    @property
    def site(self) -> str:
        return f"{self.file}:{self.line}"


def _qualname(frame: FrameType) -> str:
    code = frame.f_code
    return getattr(code, "co_qualname", code.co_name).replace(
        "<locals>.", "")


class HostSyncSanitizer:
    """Records the host syncs of a region::

        with HostSyncSanitizer() as syncs:
            run_rounds(...)
        syncs.events        # [SyncEvent]

    On entry it sets ``torch.cuda.set_sync_debug_mode("warn")`` (a mode of
    "error" stays "error": it never downgrades one) and restores the old
    mode on exit. Each warning that PyTorch then raises for a synchronizing
    CUDA operation becomes a ``SyncEvent``, taken from the Python stack at
    the moment of the warning; the warning itself is not shown. Other
    warnings pass through.

    Without CUDA it leaves the debug mode alone, and nothing on the CPU
    waits for a device, so it records nothing there; a warning carrying
    the same message is recorded all the same (the CPU tests feed it
    one). ``package_dir``, ``root`` and ``contexts`` default to the port's
    package, the repository and ``lint.STEP_CONTEXTS``.
    """

    def __init__(self, package_dir: Path = PACKAGE_DIR,
                 root: Path = REPO_ROOT,
                 contexts: Mapping[str, Sequence[str]] = STEP_CONTEXTS):
        self.package_dir = Path(package_dir).resolve()
        self.root = Path(root).resolve()
        self.contexts = {k: tuple(v) for k, v in contexts.items()}
        self.events: List[SyncEvent] = []
        self._loops: Dict[tuple, frozenset] = {}
        self._mode: Optional[int] = None
        self._catch = None
        self._show = None

    def __enter__(self) -> "HostSyncSanitizer":
        self.events = []
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.filterwarnings("always", message=SYNC_MESSAGE)
        self._show = warnings.showwarning
        warnings.showwarning = self._hook
        if torch.cuda.is_available():
            self._mode = torch.cuda.get_sync_debug_mode()
            if self._mode < 1:
                torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._mode is not None:
            torch.cuda.set_sync_debug_mode(self._mode)
            self._mode = None
        self._catch.__exit__(exc_type, exc, tb)

    def _hook(self, message, category, filename, lineno, file=None,
              line=None) -> None:
        if SYNC_MESSAGE in str(message):
            self.events.append(self.event_at(sys._getframe(1), filename,
                                             lineno))
        else:
            self._show(message, category, filename, lineno, file, line)

    def _package_file(self, frame: FrameType) -> Optional[Path]:
        path = Path(frame.f_code.co_filename).resolve()
        try:
            path.relative_to(self.package_dir)
        except ValueError:
            return None
        return path

    def _is_step(self, path: Path, qualname: str, lineno: int) -> bool:
        """Whether a frame at ``lineno`` of ``qualname`` in ``path`` runs in
        a step context (a ``name:loop`` entry: inside its loop bodies)."""
        names = self.contexts.get(
            path.relative_to(self.package_dir).as_posix(), ())
        for n in names:
            if n.endswith(LOOP_SUFFIX):
                n = n[:-len(LOOP_SUFFIX)]
                if qualname == n:
                    key = (path, n)
                    if key not in self._loops:
                        self._loops[key] = frozenset(
                            loop_lines(path.read_text(), n))
                    if lineno in self._loops[key]:
                        return True
            elif qualname == n or qualname.startswith(n + "."):
                return True
        return False

    def event_at(self, frame: Optional[FrameType], filename: str = "",
                 lineno: int = 0) -> SyncEvent:
        """The event of a sync whose warning is raised at ``frame``'s
        stack (``filename``/``lineno``: the warning's own, for a stack
        without a frame of the package)."""
        site = None
        in_step = False
        while frame is not None:
            path = self._package_file(frame)
            if path is not None:
                q = _qualname(frame)
                if site is None:
                    site = (path, frame.f_lineno, q)
                in_step = in_step or self._is_step(path, q,
                                                   frame.f_lineno)
            frame = frame.f_back
        if site is None:
            return SyncEvent(filename, lineno, "", False)
        path, line, q = site
        try:
            rel = path.relative_to(self.root).as_posix()
        except ValueError:
            rel = str(path)
        return SyncEvent(rel, line, q, in_step)

    def sites(self, in_step: Optional[bool] = None) -> Dict[str, int]:
        """``file:line`` -> events there (only those in or out of a step
        when ``in_step`` is given)."""
        out: Dict[str, int] = {}
        for e in self.events:
            if in_step is None or e.in_step == in_step:
                out[e.site] = out.get(e.site, 0) + 1
        return out
