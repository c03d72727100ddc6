"""The port's tracelint rule registry (port of ``repro.analysis.rules``).

Every rule encodes one invariant the port's performance story rests on:
a round or a decoded token runs without waiting for the card (so that it
can become a CUDA graph, ROADMAP item 12), the sweep builds one runner per
structure and not per hyperparameter value, and every hand-written kernel
is routed, has a plain twin and fails loudly. The linter
(``repro_torch.analysis.lint``) walks ``src/repro_torch`` and reports
violations as ``Finding``s with these codes; the runtime half
(``repro_torch.analysis.sanitize``) checks the same invariants on the card.

The codes are the reference's, so a suppression reads the same in both
packages. R004 and R005 are listed and never reported: eager PyTorch has
no pytree boundary to register a dataclass with, and no donation.

Suppression syntax (per line, justification required)::

    risky_call()  # tracelint: disable=R002 -- host path, runs outside a round

A ``tracelint:`` comment without the ``-- justification`` tail is itself a
finding (R000), so every grandfathered line documents *why*.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class Rule:
    code: str
    name: str
    summary: str
    checked: bool = True


@dataclass(frozen=True)
class Finding:
    """One linter hit: ``file:line: code message``. ``end_line`` is the last
    line of the flagged expression or statement (0: ``line``), so that a
    runtime site inside a multi-line call still maps onto it."""

    file: str
    line: int
    rule: str
    message: str
    line_text: str = ""
    end_line: int = 0

    def render(self) -> str:
        return f"{self.file}:{self.line}: {self.rule} {self.message}"

    def to_dict(self) -> Dict[str, object]:
        return {"file": self.file, "line": self.line, "rule": self.rule,
                "message": self.message}

    def covers(self, line: int) -> bool:
        """Whether ``line`` lies within the flagged lines."""
        return self.line <= line <= max(self.line, self.end_line)


RULES: Dict[str, Rule] = {r.code: r for r in [
    Rule("R000", "suppression-hygiene",
         "a `# tracelint: disable=...` comment must carry a "
         "`-- justification` tail"),
    Rule("R001", "host-sync-branch",
         "Python if/while/assert/conditional expression on a value derived "
         "from a step context's tensor parameters: bool() of a device "
         "tensor waits for the card; select on the device (torch.where) or "
         "decide at build time"),
    Rule("R002", "host-sync-call",
         "host-synchronizing call inside a step context (a round or a "
         "decoded token): .item()/.tolist()/.cpu()/.numpy(), int()/float()/"
         "bool() of a tensor, torch.cuda.synchronize, print of a tensor, "
         "np.asarray/np.array of a tensor, torch.nonzero/argwhere/unique/"
         "masked_select, boolean-mask indexing, or torch.tensor/as_tensor "
         "of host data onto a device (a blocking copy)"),
    Rule("R003", "hparam-in-runner-cache-key",
         "swept hyperparameter (lr/lrs/gamma/alpha/sigma0/delta) reaches a "
         "runner-cache key (runner_key(...) or a *RUNNER_CACHE* dict) that "
         "grid.py promises is structure-only, or a replace() canonicalizing "
         "a key leaves alpha/sigma0/delta/gamma/period unzeroed"),
    Rule("R004", "unregistered-pytree-dataclass",
         "not checked: eager PyTorch has no jit boundary that a dataclass "
         "must be registered to cross", checked=False),
    Rule("R005", "donated-buffer-reuse",
         "not checked: eager PyTorch has no donate_argnums; a round makes "
         "new tensors", checked=False),
    Rule("R006", "kernel-hygiene",
         "Triton/CUDA kernel hygiene under kernels/: a kernel module not "
         "named in kernels/dispatch.py, a launch wrapper without a plain "
         "twin in kernels/ref.py or models/attention.py, a try/except "
         "around a launch whose handler falls back to a plain twin, a "
         "tl.dot/tl.sum without visible fp32 accumulation, or a grid "
         "floor-divided by a size without triton.cdiv or a % guard"),
]}


def render_rule_table() -> str:
    width = max(len(r.name) for r in RULES.values())
    return "\n".join(f"{r.code}  {r.name:<{width}}  {r.summary}"
                     for r in RULES.values())
