"""Kernel-contract lint over ``src/repro_torch`` (stdlib ``ast``, no deps),
the port's copy of the JAX package's ``analysis/lint.py`` with its five
rules read for PyTorch and CUDA.

Statically enforces the cross-cutting contracts the test suite otherwise
only checks dynamically (and only on the paths a test happens to walk):

  impl-dispatch        every public op in ``kernels/ops.py`` takes ``impl``,
                       validates it (``_check``) and dispatches both the
                       "reference" and "cuda" tiers
  kernel-reachability  every kernel module's public entry is reachable from
                       ``ops.py`` over the intra-package import graph — a
                       kernel nobody dispatches is dead code with tests
  fp32-accum           accumulators start in fp32: flag float16/bfloat16
                       dtypes on initializers (``torch.zeros``/``full``/
                       ``empty``/...) inside ``kernels/``
  host-sync            no host-side Python ``if``/``while`` on a device
                       value in ``kernels/`` or ``models/``: conservative
                       heuristic — a branch test that *calls* into
                       ``torch.`` reads a tensor back to the host (a device
                       synchronize per step, and a branch a CUDA graph
                       cannot capture); JAX's ``traced-branch``
  config-field         every ``ExperimentConfig`` field referenced anywhere
                       (attribute access on a name ``exp``, constructor or
                       ``dataclasses.replace`` keyword) is declared —
                       catches dead config plumbing

Waive a finding with an inline pragma on the flagged line or the line
above, with a justification comment::

    # lint: allow(impl-dispatch)  -- plain PyTorch on every tier

Run as ``python -m repro_torch.analysis.lint src/repro_torch`` (exit 1 on
unwaived findings).
"""

from __future__ import annotations

import ast
import dataclasses
import re
import sys
from pathlib import Path
from typing import Iterable, Optional

REQUIRED_TIERS = ("reference", "cuda")
BAD_ACC_DTYPES = ("float16", "bfloat16", "half", "f16", "bf16")
ACC_INITIALIZERS = ("zeros", "ones", "full", "empty", "zeros_like",
                    "full_like", "empty_like")
WAIVER_RE = re.compile(r"#\s*lint:\s*allow\(([\w\-, ]+)\)")


@dataclasses.dataclass(frozen=True)
class LintFinding:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


# ----------------------------------------------------------------- helpers

def _attr_root(node: ast.AST) -> Optional[str]:
    """Root Name of a dotted chain: ``torch.foo.bar`` -> ``torch``."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _dotted(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _is_bad_dtype(node: ast.AST) -> bool:
    """True for ``torch.float16``/``torch.bfloat16`` (``half``) and string
    forms."""
    if isinstance(node, ast.Attribute) and node.attr in BAD_ACC_DTYPES:
        return True
    if isinstance(node, ast.Constant) and node.value in BAD_ACC_DTYPES:
        return True
    return False


def _waived(findings: Iterable[LintFinding],
            sources: dict[str, list[str]]) -> list[LintFinding]:
    """Drop findings covered by a ``# lint: allow(<rule>)`` pragma on the
    flagged line or the line directly above."""
    out = []
    for f in findings:
        lines = sources.get(f.path, [])
        allowed: set[str] = set()
        for ln in (f.line, f.line - 1):
            if 1 <= ln <= len(lines):
                m = WAIVER_RE.search(lines[ln - 1])
                if m:
                    allowed |= {s.strip() for s in m.group(1).split(",")}
        if f.rule not in allowed:
            out.append(f)
    return out


# ------------------------------------------------------------- rule passes

def _lint_impl_dispatch(path: str, tree: ast.Module) -> list[LintFinding]:
    """kernels/ops.py: public top-level ops dispatch every declared tier."""
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) or fn.name.startswith("_"):
            continue
        argnames = [a.arg for a in fn.args.args + fn.args.kwonlyargs]
        if "impl" not in argnames:
            out.append(LintFinding(
                "impl-dispatch", path, fn.lineno,
                f"public op '{fn.name}' has no 'impl' parameter — it cannot "
                "dispatch the declared tiers"))
            continue
        calls_check = any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
            and n.func.id == "_check"
            for n in ast.walk(fn))
        if not calls_check:
            out.append(LintFinding(
                "impl-dispatch", path, fn.lineno,
                f"op '{fn.name}' never validates impl via _check(impl)"))
        strings = {n.value for n in ast.walk(fn)
                   if isinstance(n, ast.Constant) and isinstance(n.value, str)}
        missing = [t for t in REQUIRED_TIERS if t not in strings]
        if missing:
            out.append(LintFinding(
                "impl-dispatch", path, fn.lineno,
                f"op '{fn.name}' does not dispatch tier(s) "
                f"{', '.join(repr(m) for m in missing)}"))
    return out


def _kernel_imports(tree: ast.Module) -> set[str]:
    """Intra-package kernel modules this module imports (any nesting)."""
    mods: set[str] = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.ImportFrom) and n.module:
            if n.module == "repro_torch.kernels":
                mods |= {a.name for a in n.names}
            elif n.module.startswith("repro_torch.kernels."):
                mods.add(n.module.split(".")[2])
        elif isinstance(n, ast.Import):
            for a in n.names:
                if a.name.startswith("repro_torch.kernels."):
                    mods.add(a.name.split(".")[2])
    return mods


def _lint_reachability(kernel_trees: dict[str, ast.Module],
                       kernel_paths: dict[str, str]) -> list[LintFinding]:
    """BFS the import graph from ops.py; unreached modules are dead."""
    if "ops" not in kernel_trees:
        return []
    reached, frontier = {"ops"}, ["ops"]
    while frontier:
        mod = frontier.pop()
        for dep in _kernel_imports(kernel_trees[mod]):
            if dep in kernel_trees and dep not in reached:
                reached.add(dep)
                frontier.append(dep)
    out = []
    for mod in sorted(set(kernel_trees) - reached):
        if mod == "__init__":
            continue
        out.append(LintFinding(
            "kernel-reachability", kernel_paths[mod], 1,
            f"kernel module '{mod}' is not reachable from kernels/ops.py — "
            "no op dispatches it"))
    return out


def _lint_fp32_accum(path: str, tree: ast.Module) -> list[LintFinding]:
    out = []
    for n in ast.walk(tree):
        if not isinstance(n, ast.Call):
            continue
        name = _dotted(n.func)
        if not (name.startswith("torch.") and name.split(".")[-1] in ACC_INITIALIZERS):
            continue
        for d in (kw.value for kw in n.keywords if kw.arg == "dtype"):
            if _is_bad_dtype(d):
                out.append(LintFinding(
                    "fp32-accum", path, n.lineno,
                    f"accumulator initialized as "
                    f"{_dotted(d) or getattr(d, 'value', '?')} — kernel "
                    "accumulators start in fp32"))
    return out


def _lint_host_sync(path: str, tree: ast.Module) -> list[LintFinding]:
    out = []
    for n in ast.walk(tree):
        if not isinstance(n, (ast.If, ast.While)):
            continue
        for sub in ast.walk(n.test):
            if isinstance(sub, ast.Call) and _attr_root(sub.func) == "torch":
                out.append(LintFinding(
                    "host-sync", path, n.lineno,
                    f"host-side branch on a device value "
                    f"({_dotted(sub.func)}(...)) in a model or kernel path — "
                    "a device synchronize; use torch.where"))
                break
    return out


def _declared_config_names(trees: dict[str, ast.Module]) -> set[str]:
    """Field + method + property names of class ExperimentConfig."""
    for tree in trees.values():
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) \
                    and node.name == "ExperimentConfig":
                names: set[str] = set()
                for stmt in node.body:
                    if isinstance(stmt, ast.AnnAssign) \
                            and isinstance(stmt.target, ast.Name):
                        names.add(stmt.target.id)
                    elif isinstance(stmt, ast.Assign):
                        names |= {t.id for t in stmt.targets
                                  if isinstance(t, ast.Name)}
                    elif isinstance(stmt, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)):
                        names.add(stmt.name)
                return names
    return set()


def _lint_config_fields(path: str, tree: ast.Module,
                        declared: set[str]) -> list[LintFinding]:
    """References to ExperimentConfig fields must be declared.  Heuristic
    scope: attribute access on a name (or trailing attribute) ``exp``, and
    keywords of ``ExperimentConfig(...)`` / ``replace(exp, ...)`` calls."""
    if not declared:
        return []
    dunder = {"__post_init__", "__init__"}
    out = []
    for n in ast.walk(tree):
        if isinstance(n, ast.Attribute):
            v = n.value
            holder = (isinstance(v, ast.Name) and v.id == "exp") or \
                     (isinstance(v, ast.Attribute) and v.attr == "exp")
            if holder and n.attr not in declared \
                    and not n.attr.startswith("__"):
                out.append(LintFinding(
                    "config-field", path, n.lineno,
                    f"'exp.{n.attr}' is not a declared ExperimentConfig "
                    "field"))
        elif isinstance(n, ast.Call):
            fname = _dotted(n.func)
            is_ctor = fname.split(".")[-1] == "ExperimentConfig"
            is_replace = fname in ("replace", "dataclasses.replace") \
                and n.args and (
                    (isinstance(n.args[0], ast.Name)
                     and n.args[0].id == "exp")
                    or (isinstance(n.args[0], ast.Attribute)
                        and n.args[0].attr == "exp"))
            if not (is_ctor or is_replace):
                continue
            for kw in n.keywords:
                if kw.arg and kw.arg not in declared | dunder:
                    out.append(LintFinding(
                        "config-field", path, kw.value.lineno,
                        f"keyword '{kw.arg}' is not a declared "
                        "ExperimentConfig field"))
    return out


# -------------------------------------------------------------- entry point

def lint_paths(roots: Iterable[str]) -> list[LintFinding]:
    """Lint every ``.py`` under ``roots`` (files or directories); returns
    unwaived findings sorted by location."""
    files: list[Path] = []
    for root in roots:
        p = Path(root)
        files += sorted(p.rglob("*.py")) if p.is_dir() else [p]

    trees: dict[str, ast.Module] = {}
    sources: dict[str, list[str]] = {}
    findings: list[LintFinding] = []
    for f in files:
        key = str(f)
        try:
            text = f.read_text()
            trees[key] = ast.parse(text, filename=key)
        except SyntaxError as e:
            findings.append(LintFinding("parse", key, e.lineno or 1,
                                        f"syntax error: {e.msg}"))
            continue
        sources[key] = text.splitlines()

    kernel_trees: dict[str, ast.Module] = {}
    kernel_paths: dict[str, str] = {}
    declared = _declared_config_names(trees)
    for key, tree in trees.items():
        parts = Path(key).parts
        in_kernels = "kernels" in parts
        if in_kernels:
            mod = Path(key).stem
            kernel_trees[mod] = tree
            kernel_paths[mod] = key
            findings += _lint_fp32_accum(key, tree)
        if in_kernels or "models" in parts:
            findings += _lint_host_sync(key, tree)
        if in_kernels and Path(key).name == "ops.py":
            findings += _lint_impl_dispatch(key, tree)
        findings += _lint_config_fields(key, tree, declared)
    findings += _lint_reachability(kernel_trees, kernel_paths)

    findings = _waived(findings, sources)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def main(argv: Optional[list[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    roots = argv or ["src/repro_torch"]
    findings = lint_paths(roots)
    for f in findings:
        print(f)
    if findings:
        print(f"\n{len(findings)} unwaived finding(s)", file=sys.stderr)
        return 1
    print(f"lint clean over {', '.join(roots)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
