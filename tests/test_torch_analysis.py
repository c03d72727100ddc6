"""The port's analysis gate (``repro_torch.analysis``) gates itself, as
``tests/test_analysis.py`` does for the reference's.

AST-only but for the runtime half's CPU checks; about 6 s alone on the CPU.

1. Every checked rule has a fixture-proven TRUE POSITIVE and a neighbouring
   negative: R001/R002 inside a step context and outside one (shape/dtype
   access, ``len``/``isinstance``, ``x is None``, host-annotated
   parameters, the ``_is_static(algo_id)`` guard, closures of a factory,
   string keys of a dict of tensors); R003 with an unzeroed ``replace``
   and a zeroed one; R006 (a)-(e).
2. Suppressions silence exactly their rule on their line; a suppression
   without a justification is itself a finding (R000).
3. The baseline ratchets: grandfathered findings pass, new ones fail,
   stale entries surface, line drift is survived, a justification is
   required, ``--update-baseline`` keeps justifications.
4. Self-lint: ``src/repro_torch/analysis`` is clean, and the port's gate
   (``python -m repro_torch.analysis src/repro_torch --baseline
   .tracelint-torch-baseline.json``) exits 0 with every entry justified and
   matched; the rule table documents R000-R006, R004/R005 as not checked.
5. Parity: ``fingerprint``, ``partition`` and the suppression parser give
   the reference's results on the same findings and text.
6. Runtime half on the CPU: ``assert_no_new_runners`` pins
   ``segment_runner_for.built`` across two hyperparameter points and is a
   no-op without a probe; ``HostSyncSanitizer`` maps a synthetic sync
   warning raised from a fixture module to its file, line and step context.
"""
import importlib.util
import json
import warnings
from pathlib import Path

import pytest

from repro.analysis import baseline as ref_baseline
from repro.analysis import lint as ref_lint
from repro.analysis.rules import Finding as RefFinding
from repro_torch.analysis import baseline as baseline_lib
from repro_torch.analysis import lint as port_lint
from repro_torch.analysis.lint import lint_paths, lint_text, main
from repro_torch.analysis.rules import RULES, Finding

REPO = Path(__file__).resolve().parent.parent
FED = "src/repro_torch/core/federated.py"


def codes(findings):
    return [f.rule for f in findings]


def in_step(src, contexts=("make.round_fn",)):
    return lint_text(src, "m.py", step_contexts=contexts)


def lint_kernel(src, dispatch_src="masked_agg fake", plain_defs=()):
    """Lint a snippet as if it lived in kernels/ (enables R006)."""
    return lint_text(src, "src/repro_torch/kernels/fake.py",
                     dispatch_src=dispatch_src, plain_defs=set(plain_defs))


# ---------------------------------------------------------------------------
# R001 / R002 — host syncs in step contexts
# ---------------------------------------------------------------------------

BRANCH = (
    "def make(flag):\n"
    "    def round_fn(state, x):\n"
    "        if x.sum() > 0:\n"
    "            return state\n"
    "        return x\n"
    "    return round_fn\n")


def test_r001_branch_in_step_context_positive_and_outside_negative():
    found = in_step(BRANCH)
    assert codes(found) == ["R001"] and found[0].line == 3
    assert "x" in found[0].message
    assert in_step(BRANCH, contexts=()) == []


def test_step_context_table_selects_by_module_path():
    """The committed table marks ``make_round_fn.round_fn`` in
    core/federated.py; the same text elsewhere is host code."""
    src = BRANCH.replace("def make(", "def make_round_fn(")
    assert codes(lint_text(src, FED)) == ["R001"]
    assert lint_text(src, "src/repro_torch/core/other.py") == []
    table = port_lint.STEP_CONTEXTS
    for module, names in (
            ("core/federated.py", {"make_round_fn.round_fn",
                                   "make_round_step.step",
                                   "run_rounds_loop:loop"}),
            ("core/algorithms.py", {"AlgorithmSpec.aggregate",
                                    "AlgorithmSpec.client_start",
                                    "_agg_fedpbc"}),
            ("core/connectivity.py", {"bernoulli_process.sample"}),
            ("optim/optimizers.py", {"sgd.update"}),
            ("scale/buffer.py", {"buffered_aggregate"}),
            ("scale/sparse_state.py", {"_cohort_mifa.branch"}),
            ("models/model.py", {"decode_step"}),
            ("launch/serve.py", {"main.step"})):
        assert names <= set(table[module]), module


def test_r001_conditional_expression_while_and_assert():
    src = (
        "def make():\n"
        "    def round_fn(state, x):\n"
        "        y = x * 2\n"
        "        while y.max() > 1:\n"
        "            y = y / 2\n"
        "        assert y.min() >= 0\n"
        "        return y if state.flag else x\n"
        "    return round_fn\n")
    assert codes(in_step(src)) == ["R001"] * 3


def test_r001_negatives_shape_isinstance_none_annotation_guard():
    """The exemptions that keep the port quiet: shape/dtype/device access,
    isinstance, ``x is None``, host-annotated parameters, the
    ``_is_static`` guard and its else branch, a factory's closure and a
    string key of a dict of tensors."""
    src = (
        "import torch\n"
        "def _is_static(algo_id):\n"
        "    return not isinstance(algo_id, torch.Tensor)\n"
        "def make(flag):\n"
        "    def round_fn(x, p, algo_id, t, prev=None, *, n: int = 2):\n"
        "        m, k = x.shape\n"
        "        if k > 1 and x.dim() == 2 and x.device.type == 'cuda':\n"
        "            pass\n"
        "        if isinstance(x, tuple) or prev is None or n > 1 or flag:\n"
        "            pass\n"
        "        if 'moe.router' in p:\n"
        "            pass\n"
        "        idx = int(algo_id) if _is_static(algo_id) else 0\n"
        "        if isinstance(t, torch.Tensor):\n"
        "            t = t.reshape(-1)\n"
        "        else:\n"
        "            t = float(t) if t % 2 == 0 else 0.0\n"
        "        static = not isinstance(p, torch.Tensor)\n"
        "        if static:\n"
        "            q = int(p)\n"
        "        return idx, len(x)\n"
        "    return round_fn\n")
    assert in_step(src) == []


def test_r001_attribute_is_none_still_flagged():
    src = (
        "def make():\n"
        "    def round_fn(state, source):\n"
        "        if source.sample_cohort is None:\n"
        "            raise ValueError('no cohort sampler')\n"
        "        return state\n"
        "    return round_fn\n")
    assert codes(in_step(src)) == ["R001"]


def test_r002_positives():
    src = (
        "import numpy as np\n"
        "import torch\n"
        "def make():\n"
        "    def round_fn(x, mask, dev):\n"
        "        a = x.item()\n"
        "        b = x.tolist()\n"
        "        c = x.cpu()\n"
        "        d = x.detach().numpy()\n"
        "        e = int(x) + float(x) + bool(x)\n"
        "        torch.cuda.synchronize()\n"
        "        print('loss', x)\n"
        "        f = np.asarray(x)\n"
        "        g = torch.nonzero(x)\n"
        "        h = x.argwhere()\n"
        "        i = torch.unique(x)\n"
        "        j = torch.masked_select(x, mask)\n"
        "        k = x[x > 0]\n"
        "        keep = mask & (x < 1)\n"
        "        l = x[keep]\n"
        "        w = torch.tensor([1, 2], device=dev)\n"
        "        v = torch.as_tensor(3, device=x.device)\n"
        "        return a\n"
        "    return round_fn\n")
    found = in_step(src)
    assert codes(found) == ["R002"] * 18     # line 9 holds three
    assert {f.line for f in found} == set(range(5, 22)) - {18}
    assert any("int() of a tensor" in f.message for f in found)
    assert any("boolean-mask" in f.message for f in found)
    assert any("host-to-device" in f.message for f in found)


def test_r002_negatives_host_side_and_static():
    """Host code is not a step context; inside one, int(len(x)), np.asarray
    of a constant table, integer indexing, a print of constants and
    torch.tensor without a device are host work."""
    host = (
        "import numpy as np\n"
        "def bench(run, batch):\n"
        "    out = run(batch)\n"
        "    print('cells/sec', float(out), out.item())\n"
        "    return np.asarray(out.cpu())\n")
    assert lint_text(host, FED) == []
    src = (
        "import numpy as np\n"
        "import torch\n"
        "def make():\n"
        "    def round_fn(x, idx):\n"
        "        n = int(len(x))\n"
        "        table = np.asarray([1, 2, 3])\n"
        "        print('round')\n"
        "        t = torch.tensor([1.0, 2.0])\n"
        "        return x[idx] * n + table[0] + t\n"
        "    return round_fn\n")
    assert in_step(src) == []


def test_step_context_reaches_module_helpers_and_methods():
    """A function of the module that a step context calls by name (or a
    method through self) is a step context; an uncalled one is not."""
    src = (
        "def helper(x):\n"
        "    return x.item()\n"
        "def unused(x):\n"
        "    return x.item()\n"
        "class Spec:\n"
        "    def aggregate(self, x):\n"
        "        return self._inner(x) + helper(x)\n"
        "    def _inner(self, x):\n"
        "        return x.tolist()\n")
    found = lint_text(src, "m.py", step_contexts=("Spec.aggregate",))
    assert [(f.line, f.rule) for f in found] == [(2, "R002"), (9, "R002")]


def test_loop_entry_covers_only_the_loop_body():
    """``run_rounds_loop:loop``: the step built before the loop and the
    metrics stacked after it are host code; the loop body is the round."""
    src = (
        "import torch\n"
        "def make_step(source):\n"
        "    if source.sample_cohort is None:\n"
        "        raise ValueError('x')\n"
        "def run_rounds_loop(state, num_rounds: int, step=None):\n"
        "    if step is None:\n"
        "        step = make_step(state)\n"
        "    n = state.round.item()\n"
        "    for _ in range(num_rounds):\n"
        "        state = step(state)\n"
        "        state.loss.item()\n"
        "    return torch.stack(state.cpu())\n")
    found = lint_text(src, "m.py", step_contexts=("run_rounds_loop:loop",))
    assert [(f.line, f.rule) for f in found] == [(11, "R002")]
    lines = port_lint.loop_lines(src, "run_rounds_loop")
    assert lines == {10, 11}


# ---------------------------------------------------------------------------
# R003 — structure-only runner keys
# ---------------------------------------------------------------------------


def test_r003_unzeroed_replace_in_key_function_positive():
    """The port's key function must zero period too."""
    src = (
        "import dataclasses\n"
        "def runner_key(spec, fed, device):\n"
        "    canon = dataclasses.replace(fed, alpha=0.0, sigma0=0.0,\n"
        "                                delta=0.0, gamma=0.0)\n"
        "    return (canon, spec.rounds, str(device))\n")
    found = lint_text(src, "m.py")
    assert codes(found) == ["R003"] and "period" in found[0].message


def test_r003_zeroed_replace_negative():
    """grid.py's contract: every knob zeroed, the runner cached under the
    key -> quiet (a replace of the spec's structure is not a key's
    canonicalization)."""
    src = (
        "import dataclasses\n"
        "_SEGMENT_RUNNERS = {}\n"
        "def runner_key(spec, fed, device):\n"
        "    canon = dataclasses.replace(fed, alpha=0.0, sigma0=0.0,\n"
        "                                delta=0.0, gamma=0.0, period=0)\n"
        "    return (canon, spec.rounds, spec.eval_every, str(device))\n"
        "def segment_runner_for(spec, fed, rounds, dev):\n"
        "    seg = dataclasses.replace(spec, rounds=rounds)\n"
        "    key = runner_key(seg, fed, dev)\n"
        "    if key not in _SEGMENT_RUNNERS:\n"
        "        _SEGMENT_RUNNERS[key] = object()\n"
        "    return _SEGMENT_RUNNERS[key]\n")
    assert lint_text(src, "m.py") == []


def test_r003_hparam_attribute_reaches_a_key():
    """An hparam attribute in runner_key's arguments, in a key function's
    body, through a local *_key helper, or in a *RUNNER_CACHE* key."""
    src = (
        "_RUNNER_CACHE = {}\n"
        "def _task_key(spec):\n"
        "    return (spec.task, spec.gamma)\n"
        "def runner_key(spec, device):\n"
        "    return (_task_key(spec), spec.rounds)\n"
        "def runner_for(spec, grid, dev):\n"
        "    a = grid.runner_key(spec, dev, spec.lr)\n"
        "    key = (spec.task, spec.alpha)\n"
        "    return _RUNNER_CACHE.setdefault(key, a)\n")
    found = lint_text(src, "m.py")
    assert codes(found) == ["R003"] * 3
    msgs = " | ".join(f.message for f in found)
    assert ".gamma" in msgs and ".lr" in msgs and ".alpha" in msgs


# ---------------------------------------------------------------------------
# R006 — kernel hygiene (kernels/ scoped)
# ---------------------------------------------------------------------------

TRITON = (
    "import functools\n"
    "import torch\n"
    "from repro_torch.kernels.dispatch import resolve_backend\n"
    "from repro_torch.kernels.ref import fake_ref\n"
    "@functools.lru_cache(maxsize=None)\n"
    "def _kernel():\n"
    "    import triton\n"
    "    import triton.language as tl\n"
    "    @triton.jit\n"
    "    def kern(x_ptr, o_ptr, n, BLOCK: tl.constexpr):\n"
    "        x = tl.load(x_ptr + tl.arange(0, BLOCK)).to(tl.float32)\n"
    "        tl.store(o_ptr, tl.sum(x, axis=0))\n"
    "    return kern\n"
    "def fake(x):\n"
    "    if resolve_backend(x) == 'torch':\n"
    "        return fake_ref(x)\n"
    "    n = x.numel()\n"
    "    out = torch.empty(1, device=x.device)\n"
    "    {grid}\n"
    "    _kernel()[grid](x, out, n, BLOCK=128)\n"
    "    fake.launches += 1\n"
    "    return out\n"
    "fake.launches = 0\n")
GUARDED = "grid = (triton.cdiv(n, 128),)"


def test_r006_clean_triton_module_negative():
    assert lint_kernel(TRITON.format(grid=GUARDED),
                       plain_defs={"fake_ref"}) == []
    ceil = "block = 128\n    grid = (-(-n // block),)"
    assert lint_kernel(TRITON.format(grid=ceil),
                       plain_defs={"fake_ref"}) == []
    mod = "block = 128\n    assert n % block == 0\n    grid = (n // block,)"
    assert lint_kernel(TRITON.format(grid=mod),
                       plain_defs={"fake_ref"}) == []


def test_r006a_module_not_named_in_dispatch():
    found = lint_kernel(TRITON.format(grid=GUARDED),
                        dispatch_src="# nothing here\n",
                        plain_defs={"fake_ref"})
    assert codes(found) == ["R006"] and "dispatch" in found[0].message
    cuda = ("from repro_torch.kernels import build\n"
            "def _library():\n"
            "    return build.load('x.cu', {})\n")
    assert codes(lint_kernel(cuda, dispatch_src="")) == ["R006"]
    assert lint_kernel(cuda, dispatch_src="from fake import x\n") == []


def test_r006b_launch_wrapper_without_plain_twin():
    src = TRITON.format(grid=GUARDED).replace("fake_ref(x)", "x * 0")
    found = lint_kernel(src, plain_defs={"other_ref"})
    assert codes(found) == ["R006"] and "'fake'" in found[0].message
    # a twin by name in kernels/ref.py or models/attention.py satisfies it
    assert lint_kernel(src, plain_defs={"fake_plain"}) == []


def test_r006c_quiet_fallback_in_a_handler():
    src = TRITON.format(grid=GUARDED) + (
        "def safe(x):\n"
        "    try:\n"
        "        return fake(x)\n"
        "    except RuntimeError:\n"
        "        return fake_ref(x)\n")
    found = lint_kernel(src, plain_defs={"fake_ref"})
    assert codes(found) == ["R006"] and "fake_ref" in found[0].message
    loud = src.replace("return fake_ref(x)", "raise")
    assert lint_kernel(loud, plain_defs={"fake_ref"}) == []


def test_r006d_reduction_without_fp32_accumulation():
    src = TRITON.format(grid=GUARDED).replace(".to(tl.float32)", "")
    found = lint_kernel(src, plain_defs={"fake_ref"})
    assert codes(found) == ["R006"] and "fp32" in found[0].message


def test_r006e_grid_floordiv_without_guard():
    src = TRITON.format(grid="block = 128\n    grid = (n // block,)")
    found = lint_kernel(src, plain_defs={"fake_ref"})
    assert codes(found) == ["R006"] and "'block'" in found[0].message


def test_r006_only_applies_under_kernels_dir():
    src = TRITON.format(grid="block = 128\n    grid = (n // block,)")
    assert lint_text(src, "src/repro_torch/models/fake.py",
                     dispatch_src="", plain_defs=set()) == []


# ---------------------------------------------------------------------------
# Suppressions (and R000)
# ---------------------------------------------------------------------------

SUPPRESSIBLE = (
    "def make():\n"
    "    def round_fn(x):\n"
    "        if x > 0:{comment}\n"
    "            return x\n"
    "        return -x\n"
    "    return round_fn\n")


def test_suppression_with_justification_silences():
    src = SUPPRESSIBLE.format(
        comment="  # tracelint: disable=R001 -- fixture: known host value")
    assert in_step(src) == []
    # keep_suppressed still reports the site (the runtime census's map)
    kept = lint_text(src, "m.py", step_contexts=("make.round_fn",),
                     keep_suppressed=True)
    assert codes(kept) == ["R001"]


def test_suppression_wrong_code_does_not_silence():
    src = SUPPRESSIBLE.format(
        comment="  # tracelint: disable=R002 -- wrong rule")
    assert codes(in_step(src)) == ["R001"]


def test_suppression_without_justification_is_r000():
    src = SUPPRESSIBLE.format(comment="  # tracelint: disable=R001")
    assert codes(in_step(src)) == ["R000"]


# ---------------------------------------------------------------------------
# Baseline ratchet
# ---------------------------------------------------------------------------

DIRTY = (
    "def run_rounds_loop(state, n: int):\n"
    "    for _ in range(n):\n"
    "        if state.loss > 0:\n"
    "            state = state.step()\n"
    "    return state\n")


def _write_tree(tmp_path, name="federated.py", src=DIRTY):
    pkg = tmp_path / "repro_torch" / "core"
    pkg.mkdir(parents=True, exist_ok=True)
    (pkg / name).write_text(src)
    return tmp_path / "repro_torch"


def test_baseline_grandfathers_then_ratchets(tmp_path, capsys):
    pkg = _write_tree(tmp_path)
    base = tmp_path / "base.json"
    findings = lint_paths([str(pkg)])
    assert codes(findings) == ["R001"]

    baseline_lib.save(base, findings)
    assert main([str(pkg), "--baseline", str(base)]) == 0

    # a NEW finding (a sync in another step context) fails the gate
    (pkg / "core" / "federated.py").write_text(DIRTY.replace(
        "            state = state.step()\n",
        "            state = state.step()\n        y = state.item()\n"))
    assert main([str(pkg), "--baseline", str(base)]) == 1
    capsys.readouterr()
    assert main([str(pkg), "--baseline", str(base), "--json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["grandfathered"] == 1
    assert [f["rule"] for f in payload["findings"]] == ["R002"]


def test_baseline_stale_entry_surfaces_but_passes(tmp_path, capsys):
    pkg = _write_tree(tmp_path)
    base = tmp_path / "base.json"
    baseline_lib.save(base, lint_paths([str(pkg)]))
    (pkg / "core" / "federated.py").write_text("x = 1\n")
    assert main([str(pkg), "--baseline", str(base)]) == 0
    assert "stale baseline entry" in capsys.readouterr().err


def test_baseline_fingerprint_survives_line_drift(tmp_path):
    pkg = _write_tree(tmp_path)
    base = tmp_path / "base.json"
    baseline_lib.save(base, lint_paths([str(pkg)]))
    (pkg / "core" / "federated.py").write_text("# pad\n" * 40 + DIRTY)
    assert main([str(pkg), "--baseline", str(base)]) == 0


def test_baseline_requires_justification(tmp_path):
    base = tmp_path / "base.json"
    base.write_text(json.dumps({"version": 1, "entries": [
        {"fingerprint": "abc", "file": "m.py", "line": 1, "rule": "R001",
         "message": "x", "justification": "  "}]}))
    with pytest.raises(ValueError, match="justification"):
        baseline_lib.load(base)


def test_update_baseline_keeps_existing_justifications(tmp_path):
    pkg = _write_tree(tmp_path)
    base = tmp_path / "base.json"
    assert main([str(pkg), "--baseline", str(base),
                 "--update-baseline"]) == 0
    data = json.loads(base.read_text())
    data["entries"][0]["justification"] = "KEEP ME"
    base.write_text(json.dumps(data))
    assert main([str(pkg), "--baseline", str(base),
                 "--update-baseline"]) == 0
    data2 = json.loads(base.read_text())
    assert data2["entries"][0]["justification"] == "KEEP ME"


# ---------------------------------------------------------------------------
# Self-lint: the gate holds on the port
# ---------------------------------------------------------------------------


def test_self_lint_analysis_package_clean():
    findings = lint_paths([str(REPO / "src" / "repro_torch" / "analysis")])
    assert findings == [], [f.render() for f in findings]


def test_port_gate_exits_zero_against_committed_baseline(monkeypatch):
    """The gate's invocation from the repository root, and every entry of
    the committed baseline justified (no TODO) and matched."""
    baseline = REPO / ".tracelint-torch-baseline.json"
    entries = baseline_lib.load(baseline)
    assert entries
    for e in entries.values():
        assert e["justification"].strip()
        assert not e["justification"].startswith("TODO")
    monkeypatch.chdir(REPO)
    assert main(["src/repro_torch", "--baseline",
                 ".tracelint-torch-baseline.json"]) == 0
    findings = lint_paths(["src/repro_torch"])
    new, grandfathered, stale = baseline_lib.partition(findings, entries)
    assert new == [] and stale == set()
    assert len(grandfathered) == len(entries)


def test_every_rule_documented_and_r004_r005_not_checked():
    assert set(RULES) == {"R000", "R001", "R002", "R003", "R004", "R005",
                          "R006"}
    for rule in RULES.values():
        assert rule.summary and rule.name
    assert {c for c, r in RULES.items() if not r.checked} == {"R004",
                                                              "R005"}
    for c in ("R004", "R005"):
        assert RULES[c].summary.startswith("not checked")
    table = port_lint.render_rule_table()
    assert all(c in table for c in RULES)


# ---------------------------------------------------------------------------
# Parity with the reference's baseline and suppression parser
# ---------------------------------------------------------------------------

PARITY = [("a/m.py", 3, "R001", "branch", "if x > 0:"),
          ("a/m.py", 9, "R001", "branch", "if x > 0:"),
          ("a/m.py", 5, "R002", "item", "y = x.item()"),
          ("b/k.py", 1, "R006", "routing", "import torch")]


def test_fingerprint_and_partition_match_the_reference():
    ours = [Finding(f, n, r, m, t) for f, n, r, m, t in PARITY]
    theirs = [RefFinding(f, n, r, m, t) for f, n, r, m, t in PARITY]
    assert [fp for _, fp in baseline_lib.attach_fingerprints(ours)] == \
        [fp for _, fp in ref_baseline.attach_fingerprints(theirs)]
    for occ in (0, 1):
        assert baseline_lib.fingerprint(ours[0], occ) == \
            ref_baseline.fingerprint(theirs[0], occ)
    base = {fp: {"justification": "x"} for _, fp in
            ref_baseline.attach_fingerprints(theirs[:2] + theirs[3:])}
    base["stale0000000000"] = {"justification": "x"}

    def key(part):
        new, old, stale = part
        return ([(f.file, f.line, f.rule) for f in new],
                [(f.file, f.line, f.rule) for f in old], stale)

    assert key(baseline_lib.partition(ours, base)) == \
        key(ref_baseline.partition(theirs, base))


def test_suppression_parser_matches_the_reference():
    text = ("a = 1  # tracelint: disable=R001 -- why\n"
            "b = 2  # tracelint: disable=R002,R003\n"
            "c = 3  #tracelint:disable=ALL -- host path, runs outside\n"
            "d = 4  # tracelint: enable=R001\n"
            "e = 5  # a comment about tracelint\n")
    assert port_lint._suppressions(text) == ref_lint._suppressions(text)
    assert port_lint.SUPPRESS_RE.pattern == ref_lint.SUPPRESS_RE.pattern


# ---------------------------------------------------------------------------
# Runtime half on the CPU
# ---------------------------------------------------------------------------


def _tiny_spec(grid, **kw):
    return grid.SweepSpec(algorithms=("fedpbc",), schemes=("bernoulli_tv",),
                          seeds=(0,), num_clients=4, dim=4, classes=2,
                          hidden=4, n_per_class=8, n_train=16, per_client=4,
                          local_steps=1, batch_size=2, **kw)


def test_runner_sanitizer_pins_segment_runners_across_hparams():
    pytest.importorskip("torch")
    from repro_torch.analysis.sanitize import (assert_no_new_runners,
                                               runner_count)
    from repro_torch.experiments import grid
    from repro_torch.kernels import flash_attention, masked_agg, rwkv6_chunk

    a = _tiny_spec(grid, lr=0.05, gamma=0.3)
    b = _tiny_spec(grid, lr=0.2, gamma=0.7)
    before = runner_count(grid.segment_runner_for)
    with assert_no_new_runners(grid.segment_runner_for, max_new=1) as pin:
        ra = grid.segment_runner_for(a, "fedpbc", "bernoulli_tv",
                                     segment_rounds=2, device="cpu")
        rb = grid.segment_runner_for(b, "fedpbc", "bernoulli_tv",
                                     segment_rounds=2, device="cpu")
    assert pin.has_introspection and ra is rb
    assert runner_count(grid.segment_runner_for) == before + 1
    assert_no_new_runners(grid.segment_runner_for, expect_total=before + 1)
    # a structural change (the segment length) does build a runner
    with pytest.raises(AssertionError, match="grew by 1"):
        with assert_no_new_runners(grid.segment_runner_for):
            grid.segment_runner_for(a, "fedpbc", "bernoulli_tv",
                                    segment_rounds=3, device="cpu")
    with pytest.raises(AssertionError, match="expected exactly"):
        assert_no_new_runners(grid.segment_runner_for, expect_total=before)
    # the Triton specialisations and the CUDA libraries' caches count on
    # the CPU too (nothing built: no card)
    assert [runner_count(p) for p in (
        masked_agg.compiled_specializations, flash_attention._library,
        rwkv6_chunk._library, rwkv6_chunk._bwd_library)] == [0, 0, 0, 0]


def test_runner_sanitizer_noop_without_introspection():
    from repro_torch.analysis.sanitize import assert_no_new_runners

    def plain(x):
        return x

    probe = assert_no_new_runners(plain, expect_total=1)   # must not raise
    assert not probe.has_introspection
    with assert_no_new_runners(plain, lambda: None):
        plain(1)


FIXTURE = '''import warnings

MSG = "called a synchronizing CUDA operation"


def make_round_fn():
    def round_fn(x):
        warnings.warn(MSG)
        return helper(x)
    return round_fn


def helper(x):
    warnings.warn(MSG)
    return x


def run_rounds_loop(n):
    warnings.warn(MSG)
    for _ in range(n):
        warnings.warn(MSG)
'''


def test_host_sync_sanitizer_maps_warnings_to_sites(tmp_path):
    from repro_torch.analysis.sanitize import HostSyncSanitizer

    pkg = tmp_path / "src" / "repro_torch"
    (pkg / "core").mkdir(parents=True)
    path = pkg / "core" / "federated.py"
    path.write_text(FIXTURE)
    spec = importlib.util.spec_from_file_location("_sync_fixture", path)
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    contexts = {"core/federated.py": ("make_round_fn.round_fn",
                                      "run_rounds_loop:loop")}
    with HostSyncSanitizer(package_dir=pkg, root=tmp_path,
                           contexts=contexts) as syncs:
        fixture.make_round_fn()(1)
        fixture.helper(2)
        fixture.run_rounds_loop(2)
        with pytest.warns(UserWarning, match="other"):
            warnings.warn("other")              # passes through
    rel = "src/repro_torch/core/federated.py"
    got = [(e.file, e.line, e.function, e.in_step) for e in syncs.events]
    assert got == [(rel, 8, "make_round_fn.round_fn", True),
                   (rel, 14, "helper", True),      # called from round_fn
                   (rel, 14, "helper", False),     # called from the host
                   (rel, 19, "run_rounds_loop", False),
                   (rel, 21, "run_rounds_loop", True),
                   (rel, 21, "run_rounds_loop", True)]
    assert syncs.sites(in_step=True) == {f"{rel}:8": 1, f"{rel}:14": 1,
                                         f"{rel}:21": 2}
    # the census's check: each in-step site must be a static finding
    static = [Finding(rel, 8, "R002", "m", end_line=9)]
    assert port_lint.unmatched_sites([(rel, 9), (rel, 14)], static) == [
        (rel, 14)]


def test_host_sync_sanitizer_leaves_the_cpu_alone():
    """Without CUDA nothing warns and the debug mode is never touched."""
    torch = pytest.importorskip("torch")
    from repro_torch.analysis.sanitize import HostSyncSanitizer

    with HostSyncSanitizer() as syncs:
        x = torch.arange(4.0)
        x.sum().item()
        x[x > 1].tolist()
    assert syncs.events == [] and syncs._mode is None
