"""Repo-specific AST lint for the balancing stack: the port's copy of
``repro.analysis.lint``, its paths pointed at ``repro_torch/`` and RL004
rewritten for PyTorch's compiled and captured steps.

Generic linters can't see this repo's contracts; these rules encode the ones
that have actually bitten (or nearly bitten) the balancing stack:

* **RL001 — wall clock in a virtual-clock path.**  ``time.time()`` /
  ``perf_counter()`` & friends are banned inside the deterministic
  virtual-clock modules (hybrid machine model, phase costs, topology/fleet
  simulation, ratio/plan math) and inside any ``Virtual*`` class: virtual
  time must flow through the machine model's clock, or determinism and
  replayability silently die.
* **RL002 — raw ratio-table key string.**  ``"membw/attn_proj"``-style key
  literals outside the ``kernel_key()`` / ``phase_kernel_key()``
  constructors fork the key namespace; a typo'd key trains a fresh table
  that never converges.
* **RL003 — pool ``run()`` off the join-or-propagate path.**  Discarding a
  pool ``run()`` result or swallowing its exceptions (``except: pass``)
  breaks the "every sub-task joined, every shard error propagated"
  guarantee of the worker pools.
* **RL004 — a compiled or captured step over a closure capturing mutable
  ratio state.**  ``torch.compile`` of a function, a CUDA graph capture
  (the body of ``with torch.cuda.graph(...)``, or a function handed to
  ``torch.cuda.make_graphed_callables``) or a
  :class:`~repro_torch.serving.step_graph.StepGraph` over a function that
  reads a ``RatioTable`` / ``KernelTuner`` bakes the state in at compile
  or capture time: the loop keeps learning but the replayed program never
  sees it.  Ratio state must enter such a step through the tensors it
  reads (the :class:`~repro_torch.runtime.OffsetSnapshot` contract).
* **RL005 — direct ``ema_update()`` call.**  The EMA must be applied by
  ``RatioTable.observe`` only, so the IV001/IV002 contracts and the race
  hooks see every update.
* **RL006 — raw ``print()`` in library code.**  Telemetry from the
  balancing stack must flow through a :class:`~repro_torch.runtime.
  StatsSink`, the ``repro_torch.core.events`` shim, or the
  ``repro_torch.obs`` exporters — a stray ``print`` is unsinkable (no
  trace, no metrics, no recorder) and pollutes callers' stdout.  CLI
  surfaces are exempt: anything under ``repro_torch/launch/``,
  ``__main__.py`` modules, ``main()`` functions, and ``if __name__ ==
  "__main__":`` blocks.

Escapes: ``# lint: virtual-clock-module`` anywhere in a file opts it into
the RL001 virtual set; a trailing ``# lint: allow(RL00x)`` (or bare
``# lint: allow``) suppresses findings on that line.
"""

from __future__ import annotations

import ast
import os
import re
from pathlib import Path
from typing import List, Optional

from .findings import Finding

__all__ = ["RULES", "lint_source", "lint_file", "run_pass"]

RULES = {
    "RL001": "wall-clock call in a virtual-clock path (route through the "
             "machine model's clock)",
    "RL002": "raw ratio-table key string outside kernel_key()/"
             "phase_kernel_key()",
    "RL003": "pool run() off the join-or-propagate path (result discarded "
             "or errors swallowed)",
    "RL004": "torch.compile, CUDA graph capture or StepGraph over a "
             "closure capturing mutable ratio state (pass it in tensors "
             "the step reads)",
    "RL005": "ema_update() called outside RatioTable.observe",
    "RL006": "raw print() in library code (route telemetry through a "
             "StatsSink / the events shim / repro_torch.obs)",
}

# Modules whose clocks are virtual by construction (suffix/prefix match on
# posix-normalized paths).  New modules can opt in with the marker comment.
VIRTUAL_CLOCK_FILES = (
    "repro_torch/core/hybrid_sim.py",
    "repro_torch/core/ratio.py",
    "repro_torch/runtime/table.py",
    "repro_torch/runtime/policy.py",
    "repro_torch/runtime/offsets.py",
    "repro_torch/serving/phases.py",
    "repro_torch/serving/traffic.py",
)
VIRTUAL_CLOCK_DIRS = ("repro_torch/topology/", "repro_torch/fleet/")
VIRTUAL_MARKER = "# lint: virtual-clock-module"

# The only modules allowed to spell ratio-table keys / apply the EMA.
KEY_CONSTRUCTOR_FILES = ("repro_torch/kernels/dispatch.py",
                         "repro_torch/serving/phases.py")
EMA_FILES = ("repro_torch/core/ratio.py", "repro_torch/runtime/table.py")

# RL006: CLI surfaces where print() IS the output channel.
PRINT_EXEMPT_DIRS = ("repro_torch/launch/",)
PRINT_EXEMPT_FILES = ("__main__.py",)

_RAW_KEY_RE = re.compile(r"^(membw|avx_vnni|avx2)/[A-Za-z0-9_]+$")
_WALL_ATTRS = {"time", "perf_counter", "monotonic", "process_time",
               "time_ns", "perf_counter_ns", "monotonic_ns"}
_MUTABLE_CTORS = {"RatioTable", "KernelTuner", "CPURuntime"}
_MUTABLE_NAMES = {"table", "tuner", "ratio_table"}
_MUTABLE_ATTRS = {"table", "tuner"}
_ALLOW_RE = re.compile(r"#\s*lint:\s*allow(?:\(([A-Z0-9, ]+)\))?")


def _norm(path) -> str:
    return str(path).replace(os.sep, "/")


def _matches(path: str, files, dirs=()) -> bool:
    return any(path.endswith(f) for f in files) or \
        any(d in path for d in dirs)


class _Lines:
    """Per-line suppression lookups."""

    def __init__(self, source: str):
        self.lines = source.splitlines()

    def allowed(self, lineno: int, rule: str) -> bool:
        if not 1 <= lineno <= len(self.lines):
            return False
        m = _ALLOW_RE.search(self.lines[lineno - 1])
        if not m:
            return False
        rules = m.group(1)
        return rules is None or rule in rules


def _docstring_ids(tree) -> set:
    """ids of Constant nodes that are docstrings or bare-string statements
    (both are prose, not keys)."""
    out = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if not isinstance(body, list):
            continue
        for stmt in body:
            if isinstance(stmt, ast.Expr) and \
                    isinstance(stmt.value, ast.Constant) and \
                    isinstance(stmt.value.value, str):
                out.add(id(stmt.value))
    return out


def _receiver_mentions_pool(func: ast.Attribute) -> bool:
    value = func.value
    names = []
    if isinstance(value, ast.Name):
        names.append(value.id)
    elif isinstance(value, ast.Attribute):
        names.append(value.attr)
    elif isinstance(value, ast.Call):
        f = value.func
        if isinstance(f, ast.Name):
            names.append(f.id)
        elif isinstance(f, ast.Attribute):
            names.append(f.attr)
    return any("pool" in n.lower() for n in names)


def _dotted(node) -> str:
    """``a.b.c`` of a Name/Attribute chain ('' for anything else)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    parts.append(node.id)
    return ".".join(reversed(parts))


# functions whose first argument is compiled or captured once and replayed
_CAPTURING_CALLS = ("torch.compile", "StepGraph", "make_graphed_callables")
# context managers whose body is captured
_CAPTURING_WITH = ("torch.cuda.graph", "cuda.graph")


def _is_capturing(node) -> bool:
    """``torch.compile``, ``StepGraph`` or ``make_graphed_callables`` as an
    expression (any module prefix)."""
    name = _dotted(node)
    return any(name == c or name.endswith("." + c)
               for c in _CAPTURING_CALLS)


def _is_partial_of_capture(call: ast.Call) -> bool:
    f = call.func
    is_partial = (isinstance(f, ast.Attribute) and f.attr == "partial") or \
                 (isinstance(f, ast.Name) and f.id == "partial")
    return is_partial and any(_is_capturing(a) for a in call.args)


def _collect_locals(fn) -> set:
    """Parameter and locally-bound names of a function node (approximate:
    any Name in Store context counts as local)."""
    bound = set()
    args = fn.args
    for a in (args.posonlyargs + args.args + args.kwonlyargs):
        bound.add(a.arg)
    if args.vararg:
        bound.add(args.vararg.arg)
    if args.kwarg:
        bound.add(args.kwarg.arg)
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
                bound.add(node.id)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                bound.add(node.name)
    return bound


def lint_source(source: str, path: str = "<string>", *,
                virtual: Optional[bool] = None) -> List[Finding]:
    """Lint one module's source; ``virtual`` overrides the RL001 path set."""
    norm = _norm(path)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(rule="RL000", severity="error",
                        location=f"{norm}:{e.lineno or 0}",
                        message=f"syntax error: {e.msg}")]
    lines = _Lines(source)
    if virtual is None:
        virtual = _matches(norm, VIRTUAL_CLOCK_FILES, VIRTUAL_CLOCK_DIRS) or \
            VIRTUAL_MARKER in source
    findings: List[Finding] = []

    def report(rule: str, node, message: str) -> None:
        lineno = getattr(node, "lineno", 0)
        if lines.allowed(lineno, rule):
            return
        findings.append(Finding(rule=rule, severity="error",
                                location=f"{norm}:{lineno}",
                                message=message))

    # ---------------------------------------------------- import aliases --
    time_modules = set()
    wall_names = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "time":
                    time_modules.add(alias.asname or "time")
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            for alias in node.names:
                if alias.name in _WALL_ATTRS:
                    wall_names[alias.asname or alias.name] = alias.name

    def is_wall_call(call: ast.Call) -> Optional[str]:
        f = call.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id in time_modules and f.attr in _WALL_ATTRS:
            return f"time.{f.attr}"
        if isinstance(f, ast.Name) and f.id in wall_names:
            return f"time.{wall_names[f.id]}"
        return None

    # ------------------------------------------ RL001: wall clock misuse --
    def walk_rl001(node, in_virtual_class: bool) -> None:
        if isinstance(node, ast.ClassDef):
            in_virtual_class = in_virtual_class or \
                node.name.startswith("Virtual")
        if isinstance(node, ast.Call) and (virtual or in_virtual_class):
            wall = is_wall_call(node)
            if wall is not None:
                scope = "virtual-clock module" if virtual else \
                    "Virtual* class"
                report("RL001", node,
                       f"{wall}() in a {scope}; use the machine model's "
                       f"virtual clock")
        for child in ast.iter_child_nodes(node):
            walk_rl001(child, in_virtual_class)

    walk_rl001(tree, False)

    # ------------------------------------------- RL002: raw key strings --
    if not _matches(norm, KEY_CONSTRUCTOR_FILES):
        prose = _docstring_ids(tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and id(node) not in prose \
                    and _RAW_KEY_RE.match(node.value):
                report("RL002", node,
                       f"raw ratio-table key {node.value!r}; build it with "
                       f"kernel_key()/phase_kernel_key()")

    # --------------------------------------- RL003: pool run() handling --
    for node in ast.walk(tree):
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            f = node.value.func
            if isinstance(f, ast.Attribute) and f.attr == "run" and \
                    _receiver_mentions_pool(f):
                report("RL003", node,
                       "pool run() result discarded; its per-worker times "
                       "must be joined (fed back) or the call has no "
                       "propagation path")
        elif isinstance(node, ast.Try):
            swallows = any(
                all(isinstance(s, (ast.Pass, ast.Continue)) for s in h.body)
                for h in node.handlers)
            if not swallows:
                continue
            for inner in node.body:
                for call in ast.walk(inner):
                    if isinstance(call, ast.Call) and \
                            isinstance(call.func, ast.Attribute) and \
                            call.func.attr == "run" and \
                            _receiver_mentions_pool(call.func):
                        report("RL003", call,
                               "pool run() inside a try whose handler "
                               "swallows exceptions; shard errors must "
                               "propagate")

    # ------------------ RL004: compile/capture over mutable ratio state --
    ratio_bound = set()
    fn_defs = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            ctor = node.value.func
            ctor_name = ctor.id if isinstance(ctor, ast.Name) else \
                ctor.attr if isinstance(ctor, ast.Attribute) else None
            if ctor_name in _MUTABLE_CTORS:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        ratio_bound.add(tgt.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn_defs.setdefault(node.name, node)

    def check_captured(body, bound, at) -> None:
        """Report the first load of mutable ratio state in ``body`` (free
        names not in ``bound``, or a ``.table`` / ``.tuner`` read)."""
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Name) and \
                        isinstance(node.ctx, ast.Load) and \
                        node.id not in bound and \
                        (node.id in _MUTABLE_NAMES or node.id in ratio_bound):
                    report("RL004", at,
                           f"compiled/captured step captures mutable ratio "
                           f"state {node.id!r} (line {node.lineno}); pass "
                           f"it in tensors the step reads instead")
                    return
                if isinstance(node, ast.Attribute) and \
                        isinstance(node.ctx, ast.Load) and \
                        node.attr in _MUTABLE_ATTRS:
                    report("RL004", at,
                           f"compiled/captured step reads mutable ratio "
                           f"state '.{node.attr}' (line {node.lineno}); "
                           f"pass it in tensors the step reads instead")
                    return

    def check_fn(fn, at) -> None:
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        check_captured(body, _collect_locals(fn), at)

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if _is_capturing(dec) or \
                        (isinstance(dec, ast.Call) and
                         (_is_capturing(dec.func) or
                          _is_partial_of_capture(dec))):
                    check_fn(node, node)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            if any(isinstance(item.context_expr, ast.Call) and
                   any(_dotted(item.context_expr.func) == w or
                       _dotted(item.context_expr.func).endswith("." + w)
                       for w in _CAPTURING_WITH)
                   for item in node.items):
                check_captured(node.body, set(), node)
        elif isinstance(node, ast.Call):
            target = None
            if _is_capturing(node.func) and node.args:
                target = node.args[0]
            elif isinstance(node.func, ast.Call) and \
                    _is_partial_of_capture(node.func) and node.args:
                target = node.args[0]
            if target is None:
                continue
            if isinstance(target, ast.Lambda):
                check_fn(target, node)
            else:
                # a function by name, or a method (self.step)
                name = target.id if isinstance(target, ast.Name) else \
                    target.attr if isinstance(target, ast.Attribute) \
                    else None
                if name in fn_defs:
                    check_fn(fn_defs[name], node)

    # ------------------------------------ RL006: print() in library code --
    if not _matches(norm, PRINT_EXEMPT_FILES, PRINT_EXEMPT_DIRS):
        def _is_name_main_test(test) -> bool:
            return (isinstance(test, ast.Compare)
                    and isinstance(test.left, ast.Name)
                    and test.left.id == "__name__"
                    and any(isinstance(c, ast.Constant)
                            and c.value == "__main__"
                            for c in test.comparators))

        exempt = set()
        for node in ast.walk(tree):
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.name == "main") or \
                    (isinstance(node, ast.If)
                     and _is_name_main_test(node.test)):
                for sub in ast.walk(node):
                    exempt.add(id(sub))
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id == "print" and id(node) not in exempt:
                report("RL006", node,
                       "raw print() in library code; emit through a "
                       "StatsSink, the events shim, or a repro_torch.obs "
                       "exporter (CLI surfaces: repro_torch/launch/, "
                       "__main__.py, main())")

    # --------------------------------------- RL005: stray ema_update() --
    if not _matches(norm, EMA_FILES):
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                f = node.func
                name = f.id if isinstance(f, ast.Name) else \
                    f.attr if isinstance(f, ast.Attribute) else None
                if name == "ema_update":
                    report("RL005", node,
                           "ema_update() must only be applied inside "
                           "RatioTable.observe (contracts and race hooks "
                           "instrument that call site)")

    return findings


def lint_file(path, *, virtual: Optional[bool] = None) -> List[Finding]:
    p = Path(path)
    return lint_source(p.read_text(), str(p), virtual=virtual)


def run_pass(root: str = "src/repro_torch", log=None) -> List[Finding]:
    """Lint every ``.py`` under ``root`` (or a single file)."""
    log = log or (lambda s: None)
    rootp = Path(root)
    files = [rootp] if rootp.is_file() else sorted(rootp.rglob("*.py"))
    findings: List[Finding] = []
    for f in files:
        findings.extend(lint_file(f))
    log(f"lint: {len(files)} file(s), {len(findings)} finding(s)")
    return findings
