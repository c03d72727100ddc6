"""tracelint for the PyTorch port — AST static analysis of host syncs,
runner-cache keys and kernel hygiene (port of ``repro.analysis.lint``).

Pure-stdlib (no torch import): cheap enough to run as a first check.

Eager PyTorch has no tracer, so nothing in the source marks the code that
runs once a round or once a decoded token. ``STEP_CONTEXTS`` is that mark:
one explicit table of the functions that do, by module and qualified name.
A *step context* is a function of the table, any function lexically nested
in one, and any function of the same module that a step context calls by
name (a module-level function, or a method of the same class through
``self``). An entry ``name:loop`` takes only the bodies of the function's
``for``/``while`` loops (``run_rounds_loop`` builds its step before its
loop and stacks the metrics after it). The table is the one place to
extend when a new per-round or per-token function appears;
``sanitize.HostSyncSanitizer`` reads it too, to tell a sync inside a round
from one outside.

Inside a step context the taint sources are the context's own parameters
and those of step-context ancestors (closure reads of a factory that is
not a step context are build-time values and stay clean), minus
parameters annotated with a host type (``int``, ``bool``, ``str``, a
``*Config``/``*Spec``/``*Strategy``, ...). Values reached only through
``.shape``/``.dtype``/``.device``/``.dim()``/... or ``len``/``isinstance``
are host values and exempt, as is ``x is None`` on a bare name. A name
proved a host value by its guard is exempt inside the guarded branch:
``isinstance(x, int)``, the else branch of ``isinstance(x, torch.Tensor)``,
``not isinstance(x, torch.Tensor)``, a module function that returns such a
test of its argument (``core/algorithms.py``'s ``_is_static(algo_id)``), or
a name assigned such a test. The analysis is module-local, as the
reference's is.

CLI::

    python -m repro_torch.analysis src/repro_torch \\
        --baseline .tracelint-torch-baseline.json [--json] [--update-baseline]

Exit status is 0 iff every finding is grandfathered by the baseline (or
there are none); any *new* finding exits 1.
"""
from __future__ import annotations

import argparse
import ast
import json
import re
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis import baseline as baseline_lib
from repro_torch.analysis.rules import Finding, render_rule_table

#: the port's package directory; the repository root is two levels up
PACKAGE_DIR = Path(__file__).resolve().parents[1]
REPO_ROOT = PACKAGE_DIR.parents[1]

# ---------------------------------------------------------------------------
# Step contexts: the functions that run once a round or once a token
# ---------------------------------------------------------------------------

#: module path under ``repro_torch/`` -> qualified names (``Class.method``,
#: ``factory.closure``) of its step contexts
STEP_CONTEXTS: Dict[str, Tuple[str, ...]] = {
    # the round closures, the step, the loop that runs them, the drawer the
    # loop calls once a round
    "core/federated.py": (
        "make_round_fn.round_fn", "_local_training.train",
        "_make_scale_round_fn.commit_clients",
        "_make_scale_round_fn.round_fn", "make_round_step.step",
        "run_rounds_loop:loop", "GeneratorDraws.__call__"),
    # the aggregation branches and the spec methods a round calls
    "core/algorithms.py": (
        "_agg_fedpbc", "_agg_fedavg", "_agg_fedavg_all",
        "_agg_fedavg_known_p", "_make_agg_fedau.branch", "_agg_mifa",
        "_make_agg_f3ast.branch", "_make_agg_fedpbc_m.branch",
        "AlgorithmSpec.client_start", "AlgorithmSpec.aggregate",
        "AlgorithmSpec.aggregate_cohort"),
    # the link draw
    "core/connectivity.py": (
        "p_of_t", "bernoulli_process.sample", "markov_process.sample",
        "cyclic_process.sample"),
    # the local update (and the cohort round's fresh optimizer state)
    "optim/optimizers.py": ("sgd.update", "sgd.init", "adam.update",
                            "adam.init"),
    "scale/buffer.py": ("buffered_aggregate",),
    "scale/sparse_state.py": ("_cohort_fedau.branch", "_cohort_mifa.branch",
                              "_cohort_f3ast.branch",
                              "_cohort_fedpbc_m.branch"),
    "scale/participation.py": ("cohort_arrivals",),
    # the round's batches and loss
    "data/sources.py": (
        "classification_source.sample", "classification_source.sample_cohort",
        "traced_classification_source.sample",
        "traced_classification_source.sample_cohort",
        "traced_lm_source.sample", "traced_lm_source.sample_cohort",
        "lm_source.sample", "lm_source.sample_cohort"),
    "experiments/tasks.py": ("_flat_fns.loss_fn",),
    # the sequence split's collectives, run in every local step's forward,
    # backward and update and once a round for the losses; the carries of
    # the recurrent layers and the MoE rows' exchanges, every local step
    "sharding/pool.py": (
        "SequenceAxis.take_seq", "SequenceAxis.gather_prefix",
        "SequenceAxis.gather_all", "SequenceAxis.all_sum",
        "SequenceAxis.prev_rows", "SequenceAxis.carry_in",
        "SequenceAxis.reduce_grads", "SequenceAxis.reduce_loss",
        "SequenceAxis._mean", "SequenceAxis._tally",
        "SequenceAxis._all_gather", "SequenceAxis._all_reduce",
        "_GatherPrefix.forward", "_GatherPrefix.backward",
        "_GatherAll.forward", "_GatherAll.backward", "_AllSum.forward",
        "_AllSum.backward"),
    # one decoded token
    "models/model.py": ("decode_step",),
    "launch/serve.py": ("main.step",),
}

# ---------------------------------------------------------------------------
# Vocabulary
# ---------------------------------------------------------------------------

_FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

#: attribute accesses (and methods) that yield host values of a tensor
SHAPE_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
               "requires_grad", "size", "dim", "numel", "nelement",
               "stride", "is_contiguous", "is_floating_point", "data_ptr",
               "element_size", "names"}

#: calls whose results are host values regardless of tensor arguments
STATIC_CALLS = {"len", "isinstance", "type", "hasattr", "getattr",
                "callable", "id"}

#: annotation names of host-valued parameters (others, and none, taint)
HOST_ANNOTATIONS = {"int", "float", "bool", "str", "bytes", "None",
                    "Optional", "Tuple", "List", "Sequence", "FrozenSet",
                    "Set", "Iterable", "Callable", "dtype", "device", "torch",
                    "typing", "np", "numpy", "ndarray"}
HOST_ANNOTATION_SUFFIX = re.compile(r"(Config|Spec|Strategy)$")

#: the types whose isinstance test proves a host value
HOST_TYPES = {"int", "float", "bool", "str", "np", "numpy", "bool_",
              "integer", "floating", "Number", "numbers"}

HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
NONZERO_CALLS = {"nonzero", "argwhere", "unique", "unique_consecutive",
                 "masked_select"}
NUMPY_ALIASES = {"np", "numpy", "onp"}
BOOL_METHODS = {"bool", "logical_and", "logical_or", "logical_not",
                "logical_xor", "isnan", "isinf", "isfinite", "eq", "ne",
                "gt", "lt", "ge", "le", "any", "all"}

HPARAM_ATTRS = {"lr", "lrs", "gamma", "alpha", "sigma0", "delta"}
CANON_ZEROED = {"alpha", "sigma0", "delta", "gamma", "period"}
RUNNER_CACHE_NAME = re.compile(r"^_?[A-Z_]*RUNNER_CACHE[A-Z_]*$")
KEY_FUNCTION = "runner_key"
REDUCTION_CALLS = {"dot", "sum"}
FP32_KEYWORDS = {"out_dtype"}

LOOP_SUFFIX = ":loop"

SUPPRESS_RE = re.compile(
    r"#\s*tracelint:\s*disable=([A-Z0-9,\s]+?)\s*(?:--\s*(\S.*))?$")


def _names(expr: ast.AST) -> Set[str]:
    """All Name ids and Attribute attrs in ``expr`` (a loose identifier
    bag: ``torch.cuda.synchronize`` -> {'torch', 'cuda', 'synchronize'})."""
    out: Set[str] = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.Name):
            out.add(node.id)
        elif isinstance(node, ast.Attribute):
            out.add(node.attr)
    return out


def _call_name(call: ast.Call) -> str:
    """The last identifier of a call's callee (``torch.nonzero`` ->
    'nonzero', ``x.item`` -> 'item'), or ''."""
    func = call.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _param_names(fn: ast.AST) -> List[ast.arg]:
    args = fn.args
    out = args.posonlyargs + args.args + args.kwonlyargs
    if args.vararg:
        out = out + [args.vararg]
    if args.kwarg:
        out = out + [args.kwarg]
    return [a for a in out if a.arg not in ("self", "cls")]


def _host_annotation(ann: Optional[ast.AST]) -> bool:
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    return all(n in HOST_ANNOTATIONS or HOST_ANNOTATION_SUFFIX.search(n)
               for n in _names(ann))


def _is_ceil_div(node: ast.BinOp, parent: Optional[ast.AST]) -> bool:
    """``-(-a // b)``: the floor division of a ceiling division."""
    return isinstance(node.left, ast.UnaryOp) \
        and isinstance(node.left.op, ast.USub) \
        and isinstance(parent, ast.UnaryOp) and isinstance(parent.op, ast.USub)


class _Module:
    """Parsed module plus the maps every check needs."""

    def __init__(self, tree: ast.Module, path: str, source: str,
                 step_contexts: Optional[Iterable[str]] = None):
        self.tree = tree
        self.path = path
        self.lines = source.splitlines()
        self.parent: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parent[child] = node
        self.functions = [n for n in ast.walk(tree)
                          if isinstance(n, _FuncNode)]
        self.qualname: Dict[ast.AST, str] = {}
        self._qualify(tree, "")
        self.by_qualname: Dict[str, List[ast.AST]] = {}
        for fn, q in self.qualname.items():
            self.by_qualname.setdefault(q, []).append(fn)
        self.guard_fns = self._guard_functions()
        if step_contexts is None:
            step_contexts = STEP_CONTEXTS.get(_package_path(path), ())
        self.loop_fns = {fn for q in step_contexts if q.endswith(LOOP_SUFFIX)
                         for fn in self.by_qualname.get(
                             q[:-len(LOOP_SUFFIX)], [])}
        self.contexts = self._close_over_calls(
            {q for q in step_contexts if not q.endswith(LOOP_SUFFIX)})
        self._narrow_cache: Dict[ast.AST, Set[str]] = {}
        self._guard_vars: Dict[ast.AST, Dict[str, Tuple[Set[str],
                                                         Set[str]]]] = {}

    # -- names ----------------------------------------------------------
    def _qualify(self, node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                q = f"{prefix}{child.name}"
                if not isinstance(child, ast.ClassDef):
                    self.qualname[child] = q
                self._qualify(child, q + ".")
            elif isinstance(child, ast.Lambda):
                self.qualname[child] = f"{prefix}<lambda>"
                self._qualify(child, f"{prefix}<lambda>.")
            else:
                self._qualify(child, prefix)

    def _guard_functions(self) -> Set[str]:
        """Module-level functions whose one statement returns an isinstance
        test proving their first parameter a host value."""
        out = set()
        for fn in self.tree.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            body = [s for s in fn.body if not (
                isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant))]
            params = _param_names(fn)
            if len(body) == 1 and isinstance(body[0], ast.Return) \
                    and body[0].value is not None and params:
                proved, _ = _proofs(body[0].value, set(), {})
                if params[0].arg in proved:
                    out.add(fn.name)
        return out

    def _close_over_calls(self, roots: Set[str]) -> Set[ast.AST]:
        """The functions named in ``roots`` and every function of this
        module a step context calls by name, transitively."""
        module_fns = {fn.name: fn for fn in self.tree.body
                      if isinstance(fn, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))}
        def callees(fn: ast.AST, nodes: Iterable[ast.AST]) -> List[ast.AST]:
            cls = self.enclosing_class(fn)
            out: List[ast.AST] = []
            for node in nodes:
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Name) and f.id in module_fns:
                    out.append(module_fns[f.id])
                elif cls is not None and isinstance(f, ast.Attribute) \
                        and isinstance(f.value, ast.Name) \
                        and f.value.id == "self":
                    out += self.by_qualname.get(f"{cls}.{f.attr}", [])
            return out

        todo = [fn for q in roots for fn in self.by_qualname.get(q, [])]
        for fn in self.loop_fns:
            todo += callees(fn, (n for loop in _loops(fn)
                                 for s in loop.body for n in ast.walk(s)))
        seen: Set[ast.AST] = set()
        while todo:
            fn = todo.pop()
            if fn not in seen:
                seen.add(fn)
                todo += callees(fn, ast.walk(fn))
        return seen

    def enclosing_class(self, fn: ast.AST) -> Optional[str]:
        q = self.qualname.get(fn, "")
        head = q.rsplit(".", 1)[0] if "." in q else ""
        if head and head not in self.by_qualname:
            return head
        return None

    # -- structure --------------------------------------------------------
    def enclosing_fn(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self.parent.get(node)
        while cur is not None and not isinstance(cur, _FuncNode):
            cur = self.parent.get(cur)
        return cur

    def fn_chain(self, fn: ast.AST) -> List[ast.AST]:
        """``fn`` plus its lexically enclosing functions, innermost first."""
        chain = [fn]
        cur = self.enclosing_fn(fn)
        while cur is not None:
            chain.append(cur)
            cur = self.enclosing_fn(cur)
        return chain

    def in_context(self, fn: ast.AST) -> bool:
        return any(f in self.contexts for f in self.fn_chain(fn))

    def node_in_context(self, node: ast.AST) -> bool:
        """Whether ``node`` runs in a step context: inside a context
        function, or inside a loop body of a ``name:loop`` one."""
        fn = self.enclosing_fn(node)
        if fn is None:
            return False
        if self.in_context(fn):
            return True
        child, cur = node, self.parent.get(node)
        while cur is not None:
            if isinstance(cur, (ast.For, ast.While)) and child in cur.body \
                    and self.enclosing_fn(cur) in self.loop_fns:
                return True
            child, cur = cur, self.parent.get(cur)
        return False

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, node: ast.AST, rule: str, message: str,
                line: Optional[int] = None) -> Finding:
        """A finding spanning ``node`` (a branch: its test), or only
        ``line`` where one is given (a module, a definition)."""
        if line is not None:
            return Finding(self.path, line, rule, message,
                           self.line_text(line), line)
        span = node.test if isinstance(node, (ast.If, ast.While,
                                              ast.IfExp)) else node
        return Finding(self.path, node.lineno, rule, message,
                       self.line_text(node.lineno),
                       span.end_lineno or node.lineno)

    # -- guards -----------------------------------------------------------
    def guard_vars(self, fn: ast.AST) -> Dict[str, Tuple[Set[str],
                                                         Set[str]]]:
        """Names assigned an isinstance test in ``fn`` -> its proofs."""
        if fn not in self._guard_vars:
            out: Dict[str, Tuple[Set[str], Set[str]]] = {}
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    proofs = _proofs(node.value, self.guard_fns, out)
                    if proofs[0] or proofs[1]:
                        out[node.targets[0].id] = proofs
            self._guard_vars[fn] = out
        return self._guard_vars[fn]

    def narrowed(self, node: ast.AST) -> Set[str]:
        """Names proved host values where ``node`` runs, by the guards of
        the branches around it inside its function."""
        if node in self._narrow_cache:
            return self._narrow_cache[node]
        fn = self.enclosing_fn(node)
        gv = self.guard_vars(fn) if fn is not None else {}
        out: Set[str] = set()
        child, cur = node, self.parent.get(node)
        while cur is not None and not isinstance(cur, _FuncNode):
            if isinstance(cur, (ast.If, ast.While)):
                t, f = _proofs(cur.test, self.guard_fns, gv)
                if child in cur.body:
                    out |= t
                elif child in cur.orelse:
                    out |= f
            elif isinstance(cur, ast.IfExp):
                t, f = _proofs(cur.test, self.guard_fns, gv)
                if child is cur.body:
                    out |= t
                elif child is cur.orelse:
                    out |= f
            elif isinstance(cur, ast.BoolOp) and isinstance(cur.op, ast.And) \
                    and child in cur.values:
                for v in cur.values[:cur.values.index(child)]:
                    out |= _proofs(v, self.guard_fns, gv)[0]
            child, cur = cur, self.parent.get(cur)
        self._narrow_cache[node] = out
        return out


def _loops(fn: ast.AST) -> List[ast.AST]:
    """The ``for``/``while`` loops of ``fn`` outside its nested functions."""
    out: List[ast.AST] = []
    todo = list(ast.iter_child_nodes(fn))
    while todo:
        node = todo.pop()
        if isinstance(node, _FuncNode):
            continue
        if isinstance(node, (ast.For, ast.While)):
            out.append(node)
        todo += ast.iter_child_nodes(node)
    return out


def loop_lines(source: str, qualname: str) -> Set[int]:
    """The lines of the loop bodies of the function ``qualname`` in
    ``source`` (what a ``name:loop`` entry covers)."""
    mod = _Module(ast.parse(source), "", source, ())
    return {line for fn in mod.by_qualname.get(qualname, [])
            for loop in _loops(fn) for s in loop.body
            for line in range(s.lineno, (s.end_lineno or s.lineno) + 1)}


def _package_path(path: str) -> str:
    """``path`` below its last ``repro_torch`` directory, '/'-joined."""
    parts = Path(path).parts
    if "repro_torch" not in parts:
        return ""
    i = len(parts) - 1 - parts[::-1].index("repro_torch")
    return "/".join(parts[i + 1:])


def _proofs(test: ast.AST, guard_fns: Set[str],
            guard_vars: Dict[str, Tuple[Set[str], Set[str]]]
            ) -> Tuple[Set[str], Set[str]]:
    """(names proved host values where ``test`` is true, ... false)."""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        out: Set[str] = set()
        for v in test.values:
            out |= _proofs(v, guard_fns, guard_vars)[0]
        return out, set()
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        t, f = _proofs(test.operand, guard_fns, guard_vars)
        return f, t
    if isinstance(test, ast.Call) and isinstance(test.func, ast.Name) \
            and test.args and isinstance(test.args[0], ast.Name):
        name = test.args[0].id
        if test.func.id == "isinstance" and len(test.args) == 2:
            types = _names(test.args[1])
            if "Tensor" in types:
                return set(), {name}
            if types and types <= HOST_TYPES:
                return {name}, set()
        elif test.func.id in guard_fns:
            return {name}, set()
    if isinstance(test, ast.Name) and test.id in guard_vars:
        return guard_vars[test.id]
    return set(), set()


# ---------------------------------------------------------------------------
# Taint: values derived from a step context's tensor parameters
# ---------------------------------------------------------------------------


def _tainted_names_in(mod: _Module, expr: ast.AST,
                      tainted: Set[str]) -> Set[str]:
    """Tainted Name ids genuinely contributing to ``expr``: subtrees
    reached only through shape/dtype access, host-valued calls, the
    ``name is None`` pattern, or a name its guard proves a host value do
    not count."""
    out: Set[str] = set()

    def visit(node: ast.AST) -> None:
        if isinstance(node, ast.Attribute) and node.attr in SHAPE_ATTRS:
            return
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and (node.func.id in STATIC_CALLS
                     or node.func.id in mod.guard_fns):
            return
        if isinstance(node, ast.Compare) \
                and isinstance(node.left, ast.Constant) \
                and isinstance(node.left.value, str) \
                and all(isinstance(op, (ast.In, ast.NotIn))
                        for op in node.ops):
            return              # a key in a dict of tensors
        if isinstance(node, ast.Compare) \
                and isinstance(node.left, ast.Name) \
                and all(isinstance(op, (ast.Is, ast.IsNot))
                        for op in node.ops) \
                and all(isinstance(c, ast.Constant) and c.value is None
                        for c in node.comparators):
            return
        if isinstance(node, ast.Name) and node.id in tainted \
                and node.id not in mod.narrowed(node):
            out.add(node.id)
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(expr)
    return out


def _assign_targets(node: ast.AST) -> Set[str]:
    """Names (re)bound by an assignment-like statement."""
    out: Set[str] = set()

    def collect(t: ast.AST) -> None:
        if isinstance(t, ast.Name):
            out.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                collect(e)
        elif isinstance(t, ast.Starred):
            collect(t.value)

    if isinstance(node, ast.Assign):
        for t in node.targets:
            collect(t)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        collect(node.target)
    elif isinstance(node, ast.For):
        collect(node.target)
    return out


def _function_taint(mod: _Module, fn: ast.AST) -> Set[str]:
    """Parameter taint for ``fn``, including the parameters of step-context
    ancestors (closure reads of a factory that is not a step context are
    build-time values and stay clean), without host-annotated parameters,
    propagated through local assignments."""
    tainted: Set[str] = set()
    for f in mod.fn_chain(fn):
        if mod.in_context(f) or f in mod.loop_fns:
            tainted |= {a.arg for a in _param_names(f)
                        if not _host_annotation(a.annotation)}
    for _ in range(2):          # two passes reach chained assignments
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                value = node.value
                if value is not None \
                        and _tainted_names_in(mod, value, tainted):
                    tainted |= _assign_targets(node)
            elif isinstance(node, ast.For):
                if _tainted_names_in(mod, node.iter, tainted):
                    tainted |= _assign_targets(node)
    return tainted


# ---------------------------------------------------------------------------
# R001 / R002 — host syncs inside step contexts
# ---------------------------------------------------------------------------


def _check_step_contexts(mod: _Module, findings: List[Finding]) -> None:
    taint_cache: Dict[ast.AST, Set[str]] = {}

    def taint_for(fn: ast.AST) -> Set[str]:
        if fn not in taint_cache:
            taint_cache[fn] = _function_taint(mod, fn)
        return taint_cache[fn]

    for node in ast.walk(mod.tree):
        if not mod.node_in_context(node):
            continue
        fn = mod.enclosing_fn(node)
        if isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)):
            names = _tainted_names_in(mod, node.test, taint_for(fn))
            if names:
                kind = ("conditional expression" if isinstance(node, ast.IfExp)
                        else type(node).__name__.lower())
                findings.append(mod.finding(
                    node, "R001",
                    f"Python {kind} on tensor value(s) {sorted(names)} "
                    f"inside a step context waits for the card; select "
                    f"with torch.where or decide at build time"))
        elif isinstance(node, ast.Call):
            _check_host_sync(mod, node, taint_for(fn), findings)
        elif isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Load) \
                and _is_bool_mask(mod, node.slice, fn, taint_for(fn)):
            findings.append(mod.finding(
                node, "R002",
                "boolean-mask indexing inside a step context sizes its "
                "result on the host (a nonzero and a copy back); use "
                "torch.where or a fixed-size gather"))


def _is_bool_mask(mod: _Module, expr: ast.AST, fn: ast.AST,
                  tainted: Set[str]) -> bool:
    """Whether ``expr`` (an index) is a boolean tensor built from tainted
    values: a comparison, ``~``/``&``/``|`` of such, a boolean method, or a
    name the function binds to one."""
    if isinstance(expr, ast.Tuple):
        return any(_is_bool_mask(mod, e, fn, tainted) for e in expr.elts)
    if not _tainted_names_in(mod, expr, tainted):
        return False

    def boolish(e: ast.AST, depth: int) -> bool:
        if isinstance(e, ast.Compare):
            return True
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Invert):
            return boolish(e.operand, depth)
        if isinstance(e, ast.BinOp) and isinstance(e.op, (ast.BitAnd,
                                                          ast.BitOr,
                                                          ast.BitXor)):
            return boolish(e.left, depth) or boolish(e.right, depth)
        if isinstance(e, ast.Call) and _call_name(e) in BOOL_METHODS \
                and not (_call_name(e) in ("any", "all") and e.args):
            return True
        if isinstance(e, ast.Name) and depth > 0:
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) \
                        and e.id in _assign_targets(node) \
                        and boolish(node.value, depth - 1):
                    return True
        return False

    return boolish(expr, 1)


def _check_host_sync(mod: _Module, call: ast.Call, tainted: Set[str],
                     findings: List[Finding]) -> None:
    func = call.func
    name = _call_name(call)

    def hit(what: str) -> None:
        findings.append(mod.finding(
            call, "R002",
            f"{what} inside a step context (a round or a decoded token) "
            f"waits for the card"))

    def tainted_arg(i: int = 0) -> bool:
        return len(call.args) > i \
            and bool(_tainted_names_in(mod, call.args[i], tainted))

    if isinstance(func, ast.Attribute):
        if name in HOST_SYNC_METHODS:
            hit(f".{name}()")
            return
        if name == "to" and any(
                isinstance(a, ast.Constant) and a.value == "cpu"
                for a in list(call.args) + [k.value for k in call.keywords]):
            hit(".to('cpu')")
            return
        if name in {"asarray", "array"} \
                and isinstance(func.value, ast.Name) \
                and func.value.id in NUMPY_ALIASES and tainted_arg():
            hit(f"{func.value.id}.{name} of a tensor")
            return
        if name in {"tensor", "as_tensor"} and "torch" in _names(func) \
                and any(k.arg == "device" and not (
                    isinstance(k.value, ast.Constant)
                    and k.value.value == "cpu") for k in call.keywords):
            hit(f"torch.{name}(..., device=...) (a blocking host-to-device "
                f"copy of host data)")
            return
    if name in NONZERO_CALLS:
        hit(f"{name} (its result's size is read on the host)")
        return
    if name == "where" and len(call.args) == 1 and not call.keywords:
        hit("torch.where(cond) (a nonzero: its size is read on the host)")
        return
    if isinstance(func, ast.Name):
        if func.id == "print" and any(
                _tainted_names_in(mod, a, tainted) for a in call.args):
            hit("print of a tensor")
        elif func.id in {"int", "float", "bool"} and tainted_arg():
            hit(f"{func.id}() of a tensor")


# ---------------------------------------------------------------------------
# R003 — structure-only runner-cache keys
# ---------------------------------------------------------------------------


def _check_cache_keys(mod: _Module, findings: List[Finding]) -> None:
    cache_vars = {
        t.id
        for node in ast.walk(mod.tree)
        if isinstance(node, (ast.Assign, ast.AnnAssign))
        for t in ([t for t in node.targets if isinstance(t, ast.Name)]
                  if isinstance(node, ast.Assign)
                  else ([node.target]
                        if isinstance(node.target, ast.Name) else []))
        if RUNNER_CACHE_NAME.match(t.id)
    }
    audited: Set[ast.AST] = set()

    def key_exprs_for(fn: ast.AST) -> List[ast.AST]:
        """Key expressions used against a runner cache inside ``fn``, and
        every ``runner_key(...)`` call."""
        keys = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id in cache_vars:
                keys.append(node.slice)
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id in cache_vars \
                    and node.func.attr in {"get", "setdefault", "pop"} \
                    and node.args:
                keys.append(node.args[0])
            elif isinstance(node, ast.Compare) \
                    and any(isinstance(c, ast.Name) and c.id in cache_vars
                            for c in node.comparators) \
                    and any(isinstance(op, (ast.In, ast.NotIn))
                            for op in node.ops):
                keys.append(node.left)
            elif isinstance(node, ast.Call) \
                    and _call_name(node) == KEY_FUNCTION:
                keys.append(node)
        return keys

    for fn in mod.functions:
        if isinstance(fn, ast.Lambda):
            continue
        if fn.name == KEY_FUNCTION:
            _audit_key_function(mod, fn, findings, audited)
        for key in key_exprs_for(fn):
            exprs = [key]
            if isinstance(key, ast.Name):
                resolved = _local_assign(fn, key.id)
                exprs = [resolved] if resolved is not None else []
            for expr in exprs:
                if isinstance(expr, ast.Call) \
                        and _call_name(expr) == KEY_FUNCTION:
                    # the key function canonicalizes its own arguments
                    _audit_hparam_attrs(mod, expr, findings)
                else:
                    _audit_key_expr(mod, fn, expr, findings, audited)


def _local_assign(fn: ast.AST, name: str) -> Optional[ast.AST]:
    last = None
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) \
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in node.targets):
            last = node.value
    return last


def _audit_replace(mod: _Module, value: ast.AST,
                   findings: List[Finding]) -> None:
    """A ``replace(...)`` canonicalizing a key must zero every knob."""
    if not (isinstance(value, ast.Call) and _call_name(value) == "replace"):
        return
    zeroed = {kw.arg for kw in value.keywords
              if kw.arg and isinstance(kw.value, ast.Constant)}
    missing = CANON_ZEROED - zeroed
    if missing:
        findings.append(mod.finding(
            value, "R003",
            f"replace() canonicalizing a runner-cache key leaves "
            f"{sorted(missing)} unzeroed; cells differing only in hparams "
            f"would stop sharing one runner"))


def _audit_key_function(mod: _Module, fn: ast.AST, findings: List[Finding],
                        audited: Set[ast.AST]) -> None:
    """A key function's body: no hyperparameter attribute, every
    ``replace`` zeroed; its local ``*_key`` helpers likewise."""
    if fn in audited:
        return
    audited.add(fn)
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Attribute) and sub.attr in HPARAM_ATTRS:
            findings.append(mod.finding(
                sub, "R003",
                f"key function {fn.name}() folds hyperparameter "
                f"'.{sub.attr}' into a runner-cache key"))
        elif isinstance(sub, ast.Call):
            _audit_replace(mod, sub, findings)
            if isinstance(sub.func, ast.Name) \
                    and sub.func.id.endswith("_key"):
                for helper in mod.by_qualname.get(sub.func.id, []):
                    _audit_key_function(mod, helper, findings, audited)


def _audit_hparam_attrs(mod: _Module, expr: ast.AST,
                        findings: List[Finding]) -> None:
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and node.attr in HPARAM_ATTRS:
            findings.append(mod.finding(
                node, "R003",
                f"hyperparameter '.{node.attr}' reaches a runner-cache "
                f"key; grid.py promises runner keys are structure-only "
                f"(hparams ride the batch's columns)"))


def _audit_key_expr(mod: _Module, fn: ast.AST, expr: ast.AST,
                    findings: List[Finding], audited: Set[ast.AST]) -> None:
    _audit_hparam_attrs(mod, expr, findings)
    for node in ast.walk(expr):
        if isinstance(node, ast.Name):
            _audit_replace(mod, _local_assign(fn, node.id), findings)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id.endswith("_key"):
            for helper in mod.by_qualname.get(node.func.id, []):
                _audit_key_function(mod, helper, findings, audited)


# ---------------------------------------------------------------------------
# R006 — Triton/CUDA kernel hygiene (kernels/ only)
# ---------------------------------------------------------------------------


def _is_triton_jit(fn: ast.AST) -> bool:
    return not isinstance(fn, ast.Lambda) and any(
        "jit" in _names(d) for d in fn.decorator_list)


def _is_triton_launch(node: ast.AST) -> bool:
    """``kernel[grid](...)``: a call of a subscripted callee."""
    return isinstance(node, ast.Call) and isinstance(node.func, ast.Subscript)


def _is_plain_name(name: str, plain_defs: Set[str]) -> bool:
    return name in plain_defs or name.endswith(("_ref", "_plain"))


def _check_kernel_hygiene(mod: _Module, findings: List[Finding],
                          dispatch_src: Optional[str],
                          plain_defs: Optional[Set[str]]) -> None:
    if "kernels" not in Path(mod.path).parts:
        return
    stem = Path(mod.path).stem
    jitted = [fn for fn in mod.functions if _is_triton_jit(fn)]
    binds_cuda = any(isinstance(n, ast.Call)
                     and {"build", "load"} <= _names(n.func)
                     for n in ast.walk(mod.tree))
    is_kernel_module = bool(jitted) or binds_cuda

    # (a) routed through dispatch
    if is_kernel_module and dispatch_src is not None \
            and stem not in {"dispatch", "__init__"} \
            and stem not in dispatch_src:
        findings.append(mod.finding(
            mod.tree, "R006",
            f"kernel module '{stem}' defines a Triton kernel or binds a "
            f"CUDA source but is not named in kernels/dispatch.py (no "
            f"backend rule, no plain-version policy)", line=1))

    # (b) every launch wrapper has a plain twin
    if is_kernel_module and plain_defs is not None:
        module_fns = {fn.name: fn for fn in mod.tree.body
                      if isinstance(fn, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))}
        # the functions that pick the backend, and the owners of a
        # launch counter (``name.launches`` / ``name.launches_by_route``)
        wrappers = {name for name, fn in module_fns.items()
                    if any(isinstance(c, ast.Call)
                           and _call_name(c) == "resolve_backend"
                           for c in ast.walk(fn))}
        for node in ast.walk(mod.tree):
            targets = (node.targets if isinstance(node, ast.Assign) else
                       [node.target] if isinstance(node, ast.AugAssign)
                       else [])
            for t in targets:
                base = t.value if isinstance(t, ast.Subscript) else t
                if isinstance(base, ast.Attribute) \
                        and base.attr.startswith("launches") \
                        and isinstance(base.value, ast.Name) \
                        and base.value.id in module_fns:
                    wrappers.add(base.value.id)
        for name in sorted(wrappers):
            if name.startswith("_"):
                continue
            fn = module_fns[name]
            calls = {_call_name(c) for c in ast.walk(fn)
                     if isinstance(c, ast.Call)}
            if f"{name}_ref" in plain_defs or f"{name}_plain" in plain_defs \
                    or calls & plain_defs:
                continue
            findings.append(mod.finding(
                fn, "R006",
                f"launch wrapper '{name}' has no plain twin in "
                f"kernels/ref.py or models/attention.py ({name}_ref, "
                f"{name}_plain, or a call of one there)", line=fn.lineno))

    # (c) no quiet fallback: a handler around a launch that reaches a twin
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Try):
            continue
        body_calls = any(isinstance(n, ast.Call)
                         for s in node.body for n in ast.walk(s))
        for handler in node.handlers:
            twins = sorted({_call_name(n) for s in handler.body
                            for n in ast.walk(s)
                            if isinstance(n, ast.Call) and _is_plain_name(
                                _call_name(n), plain_defs or set())})
            if body_calls and twins:
                findings.append(mod.finding(
                    node, "R006",
                    f"try/except around a launch falls back to the plain "
                    f"version ({', '.join(twins)}) in its handler; a kernel "
                    f"that cannot launch must raise (kernels/dispatch.py)",
                    line=node.lineno))

    # (d) visible fp32 accumulation in a Triton kernel that reduces
    for fn in jitted:
        reduces = any(isinstance(n, ast.Call)
                      and _call_name(n) in REDUCTION_CALLS
                      and "tl" in _names(n.func) for n in ast.walk(fn))
        fp32 = any("float32" in _names(n) if not isinstance(n, ast.keyword)
                   else n.arg in FP32_KEYWORDS for n in ast.walk(fn))
        if reduces and not fp32:
            findings.append(mod.finding(
                fn, "R006",
                f"Triton kernel '{fn.name}' reduces (tl.dot/tl.sum) without "
                f"visible fp32 accumulation (tl.float32, .to(tl.float32) or "
                f"out_dtype); bf16 inputs lose precision", line=fn.lineno))

    # (e) grids that floor-divide by a size are guarded
    for fn in mod.functions:
        if not any(_is_triton_launch(n) for n in ast.walk(fn)):
            continue
        guarded: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
                guarded |= {n.id for n in (node.left, node.right)
                            if isinstance(n, ast.Name)}
            elif isinstance(node, ast.Call) and "cdiv" in _names(node.func):
                guarded |= _names(node)
        for node in ast.walk(fn):
            if isinstance(node, ast.BinOp) \
                    and isinstance(node.op, ast.FloorDiv) \
                    and isinstance(node.right, ast.Name) \
                    and node.right.id not in guarded \
                    and not _is_ceil_div(node, mod.parent.get(node)):
                findings.append(mod.finding(
                    node, "R006",
                    f"grid floordiv by '{node.right.id}' without "
                    f"triton.cdiv, a ceiling division or a % guard in the "
                    f"same function; the ragged edge is never launched"))


# ---------------------------------------------------------------------------
# Suppressions + driver
# ---------------------------------------------------------------------------


def _suppressions(source: str) -> Dict[int, Tuple[Set[str], bool]]:
    """line -> (codes, has_justification) for `# tracelint: disable=...`."""
    out: Dict[int, Tuple[Set[str], bool]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = SUPPRESS_RE.search(line)
        if m:
            codes = {c.strip() for c in m.group(1).split(",") if c.strip()}
            out[i] = (codes, m.group(2) is not None)
    return out


def lint_text(source: str, path: str, dispatch_src: Optional[str] = None,
              plain_defs: Optional[Set[str]] = None,
              step_contexts: Optional[Iterable[str]] = None,
              keep_suppressed: bool = False) -> List[Finding]:
    """Lint one module's source. ``path`` drives the kernels/-scoped checks
    and, below ``repro_torch/``, picks the module's ``STEP_CONTEXTS`` row
    unless ``step_contexts`` (qualified names) is given; ``dispatch_src``
    is the sibling dispatch.py source and ``plain_defs`` the function names
    of kernels/ref.py and models/attention.py, when they exist.
    ``keep_suppressed`` also returns the findings a suppression silences
    (every site the rules flag)."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Finding(path, exc.lineno or 1, "R000",
                        f"syntax error: {exc.msg}")]
    mod = _Module(tree, path, source, step_contexts)
    findings: List[Finding] = []
    _check_step_contexts(mod, findings)
    _check_cache_keys(mod, findings)
    _check_kernel_hygiene(mod, findings, dispatch_src, plain_defs)

    sup = _suppressions(source)
    kept: List[Finding] = []
    seen: Set[Tuple[int, str, str]] = set()
    for f in findings:
        codes, _ = sup.get(f.line, (set(), False))
        if (f.rule in codes or "ALL" in codes) and not keep_suppressed:
            continue
        key = (f.line, f.rule, f.message)
        if key in seen:
            continue
        seen.add(key)
        kept.append(f)
    for line, (codes, justified) in sorted(sup.items()):
        if not justified:
            kept.append(Finding(
                path, line, "R000",
                f"suppression of {sorted(codes)} lacks a justification "
                f"(`# tracelint: disable=RXXX -- why`)",
                mod.line_text(line)))
    kept.sort(key=lambda f: (f.line, f.rule))
    return kept


def _defined_functions(path: Path) -> Set[str]:
    if not path.exists():
        return set()
    return {n.name for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def lint_file(path: Path, root: Optional[Path] = None,
              keep_suppressed: bool = False) -> List[Finding]:
    rel = str(path.relative_to(root)) if root else str(path)
    dispatch = path.parent / "dispatch.py"
    dispatch_src = dispatch.read_text() \
        if (dispatch.exists() and path.name != "dispatch.py") else None
    plain_defs = None
    if path.parent.name == "kernels":
        plain_defs = (_defined_functions(path.parent / "ref.py")
                      | _defined_functions(path.parent.parent / "models"
                                           / "attention.py"))
    return lint_text(path.read_text(), rel, dispatch_src=dispatch_src,
                     plain_defs=plain_defs, keep_suppressed=keep_suppressed)


def iter_py_files(paths: Sequence[str]) -> Iterable[Path]:
    for p in paths:
        path = Path(p)
        if path.is_file() and path.suffix == ".py":
            yield path
        elif path.is_dir():
            for f in sorted(path.rglob("*.py")):
                if "__pycache__" not in f.parts \
                        and not any(part.startswith(".") for part in f.parts):
                    yield f


def lint_paths(paths: Sequence[str], root: Optional[Path] = None,
               keep_suppressed: bool = False) -> List[Finding]:
    findings: List[Finding] = []
    for f in iter_py_files(paths):
        findings.extend(lint_file(f, root=root,
                                  keep_suppressed=keep_suppressed))
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return findings


def host_sync_sites(paths: Sequence[str] = (str(PACKAGE_DIR),),
                    root: Path = REPO_ROOT) -> List[Finding]:
    """Every R001/R002 finding under ``paths``, suppressed or not, with
    repository-relative files: what a runtime sync site inside a step
    must be (``sanitize.HostSyncSanitizer``)."""
    return [f for f in lint_paths(paths, root=root, keep_suppressed=True)
            if f.rule in ("R001", "R002")]


def unmatched_sites(sites: Iterable[Tuple[str, int]],
                    findings: Sequence[Finding]) -> List[Tuple[str, int]]:
    """The ``(file, line)`` sites that no finding covers."""
    by_file: Dict[str, List[Finding]] = {}
    for f in findings:
        by_file.setdefault(f.file, []).append(f)
    return [(file, line) for file, line in sites
            if not any(f.covers(line) for f in by_file.get(file, []))]


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="tracelint for the PyTorch port: host syncs in step "
                    "contexts, runner-cache keys, kernel hygiene")
    parser.add_argument("paths", nargs="*", default=["src/repro_torch"])
    parser.add_argument("--baseline", type=Path, default=None,
                        help="grandfathered-findings file; new findings "
                             "still fail")
    parser.add_argument("--update-baseline", action="store_true",
                        help="rewrite the baseline from current findings "
                             "(keeps existing justifications)")
    parser.add_argument("--json", action="store_true", dest="as_json")
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)

    if args.list_rules:
        print(render_rule_table())
        return 0

    findings = lint_paths(args.paths or ["src/repro_torch"])

    old = baseline_lib.load(args.baseline) if args.baseline else {}
    if args.update_baseline:
        if args.baseline is None:
            parser.error("--update-baseline requires --baseline")
        baseline_lib.save(args.baseline, findings, old)
        print(f"baseline written: {len(findings)} finding(s) -> "
              f"{args.baseline}")
        return 0

    new, grandfathered, stale = baseline_lib.partition(findings, old)

    if args.as_json:
        counts: Dict[str, int] = {}
        for f in new:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        print(json.dumps({
            "findings": [f.to_dict() for f in new],
            "grandfathered": len(grandfathered),
            "stale_baseline_entries": sorted(stale),
            "counts": counts,
        }, indent=2))
    else:
        for f in new:
            print(f.render())
        if grandfathered:
            print(f"[tracelint] {len(grandfathered)} grandfathered "
                  f"finding(s) suppressed by baseline", file=sys.stderr)
        for fp in sorted(stale):
            print(f"[tracelint] stale baseline entry {fp} (finding gone — "
                  f"run --update-baseline to prune)", file=sys.stderr)
        if new:
            print(f"[tracelint] {len(new)} new finding(s)", file=sys.stderr)
        else:
            print("[tracelint] clean", file=sys.stderr)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
