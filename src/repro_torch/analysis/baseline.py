"""Grandfathered-findings baseline for the port's tracelint (a copy of
``repro.analysis.baseline``, which the port does not import).

The baseline lets the gate start green and *ratchet*: every entry pins
one existing finding by a line-content fingerprint (stable across line
drift) plus a mandatory justification, and any finding NOT in the baseline
fails the gate. Entries whose finding disappears are reported as stale so
the file shrinks monotonically.

Fingerprint: ``sha1(file | rule | stripped-line-text | occurrence)`` — the
occurrence index disambiguates identical lines while surviving pure
re-numbering edits above them.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, List, Sequence, Set, Tuple

from repro_torch.analysis.rules import Finding

_VERSION = 1
_DEFAULT_JUSTIFICATION = "TODO: justify or fix"


def fingerprint(finding: Finding, occurrence: int) -> str:
    raw = "|".join([finding.file, finding.rule,
                    finding.line_text.strip(), str(occurrence)])
    return hashlib.sha1(raw.encode()).hexdigest()[:16]


def attach_fingerprints(
        findings: Sequence[Finding]) -> List[Tuple[Finding, str]]:
    """Pair each finding with its fingerprint, counting duplicates of the
    same (file, rule, line text) in file order."""
    counts: Dict[Tuple[str, str, str], int] = {}
    out = []
    for f in sorted(findings, key=lambda f: (f.file, f.line, f.rule)):
        key = (f.file, f.rule, f.line_text.strip())
        occ = counts.get(key, 0)
        counts[key] = occ + 1
        out.append((f, fingerprint(f, occ)))
    return out


def load(path: Path) -> Dict[str, dict]:
    """fingerprint -> entry. Every entry must carry a justification."""
    if path is None or not Path(path).exists():
        return {}
    data = json.loads(Path(path).read_text())
    entries = {}
    for e in data.get("entries", []):
        if not str(e.get("justification", "")).strip():
            raise ValueError(
                f"baseline entry {e.get('fingerprint')} "
                f"({e.get('file')}:{e.get('rule')}) has no justification; "
                f"every grandfathered finding must say why")
        entries[e["fingerprint"]] = e
    return entries


def save(path: Path, findings: Sequence[Finding],
         old: Dict[str, dict] | None = None) -> None:
    """Write the baseline for ``findings``, keeping justifications from
    ``old`` where the fingerprint survives."""
    old = old or {}
    entries = []
    for f, fp in attach_fingerprints(findings):
        entries.append({
            "fingerprint": fp,
            "file": f.file,
            "line": f.line,
            "rule": f.rule,
            "message": f.message,
            "justification": old.get(fp, {}).get(
                "justification", _DEFAULT_JUSTIFICATION),
        })
    Path(path).write_text(json.dumps(
        {"version": _VERSION, "entries": entries}, indent=2) + "\n")


def partition(findings: Sequence[Finding], baseline: Dict[str, dict],
              ) -> Tuple[List[Finding], List[Finding], Set[str]]:
    """(new, grandfathered, stale-fingerprints)."""
    new: List[Finding] = []
    grandfathered: List[Finding] = []
    seen: Set[str] = set()
    for f, fp in attach_fingerprints(findings):
        if fp in baseline:
            grandfathered.append(f)
            seen.add(fp)
        else:
            new.append(f)
    stale = set(baseline) - seen
    return new, grandfathered, stale
