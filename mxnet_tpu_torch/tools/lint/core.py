"""mxlint engine (counterpart of ``mxnet_tpu/tools/lint/core.py``): file
walking, AST contexts, suppressions, baseline.

A rule is a function ``rule(ctx) -> iterable[Violation]`` registered
under a kebab-case name via :func:`rule`.  The engine parses each file
ONCE into a :class:`FileCtx` (AST + parent links + import aliases) and
hands the same context to every rule — the tree-wide run over the
whole package is a tier-1 test, so the suite must stay linear in
source size (no per-rule re-parsing, no subprocesses).
"""
from __future__ import annotations

import ast
import json
import os
import re
import time
from typing import Callable, Dict, Iterable, List, Optional

__all__ = ["Violation", "FileCtx", "LintResult", "rule", "RULES",
           "rule_names", "lint_source", "lint_paths", "load_baseline",
           "default_baseline_path", "package_root"]

_SUPPRESS_RE = re.compile(
    r"#\s*mxlint:\s*disable=([a-zA-Z0-9_,\- ]+)")
_SUPPRESS_FILE_RE = re.compile(
    r"#\s*mxlint:\s*disable-file=([a-zA-Z0-9_,\- ]+)")


class Violation:
    """One finding: ``rule`` (kebab-case name), ``path`` (normalized,
    ``mxnet_tpu_torch/...`` when under the package), 1-based ``line``/
    ``col``, human ``message``, and ``context`` — the stripped source
    line, which is also the baseline-matching key (line numbers drift;
    code text identifies the site)."""

    __slots__ = ("rule", "path", "line", "col", "message", "context")

    def __init__(self, rule, path, line, col, message, context=""):
        self.rule = rule
        self.path = path
        self.line = int(line)
        self.col = int(col)
        self.message = message
        self.context = context

    def key(self):
        return (self.rule, self.path, self.context)

    def to_dict(self):
        return {"rule": self.rule, "path": self.path,
                "line": self.line, "col": self.col,
                "message": self.message, "context": self.context}

    def __repr__(self):
        return "%s:%d:%d: [%s] %s" % (self.path, self.line, self.col,
                                      self.rule, self.message)


class _Aliases:
    """Module-level import aliases the rules care about, resolved
    once per file: ``modules`` maps local name -> dotted module
    ("torch", "numpy", "threading", "queue", "time", "os", "random"),
    ``names`` maps local name -> (module, original name) for
    from-imports ("from torch.cuda import graph as G" -> G:
    ("torch.cuda", "graph"))."""

    def __init__(self, tree):
        self.modules: Dict[str, str] = {}
        self.names: Dict[str, tuple] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.modules[a.asname or a.name.split(".")[0]] = \
                        a.name
            elif isinstance(node, ast.ImportFrom):
                if node.module is None:
                    # relative module import: ``from . import envs``
                    # binds each name as a MODULE alias — the tree's
                    # standard intra-package idiom
                    for a in node.names:
                        self.modules[a.asname or a.name] = a.name
                else:
                    for a in node.names:
                        self.names[a.asname or a.name] = (node.module,
                                                          a.name)

    def module_is(self, name, dotted):
        """True when local ``name`` is module ``dotted`` (exact or the
        relative tail: ``from . import envs`` binds "envs")."""
        mod = self.modules.get(name)
        if mod == dotted or (mod or "").endswith("." + dotted):
            return True
        ref = self.names.get(name)
        return ref is not None and (ref[1] == dotted
                                    or ref[1].endswith("." + dotted))

    def name_is(self, name, module, orig):
        """True when local ``name`` came from ``from module import
        orig`` (module matched on its dotted tail, so relative
        imports count)."""
        ref = self.names.get(name)
        if ref is None:
            return False
        mod, bound = ref
        return bound == orig and (mod == module
                                  or mod.endswith(module)
                                  or module.endswith(mod))


class FileCtx:
    """Everything a rule needs for one file, computed once."""

    def __init__(self, path, relpath, source, tree):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.aliases = _Aliases(tree)
        # one walk for everything: rules iterate ``nodes`` instead of
        # re-walking per rule (the tree-wide run is a tier-1 test —
        # linear passes keep it inside its wall-time budget)
        self.parents: Dict[ast.AST, ast.AST] = {}
        self.nodes = [tree]
        for parent in self.nodes:
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
                self.nodes.append(child)

    # -- helpers shared by rules ------------------------------------------
    def line_text(self, lineno):
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def violation(self, rule_name, node, message):
        return Violation(rule_name, self.relpath,
                         getattr(node, "lineno", 0),
                         getattr(node, "col_offset", 0) + 1,
                         message, self.line_text(
                             getattr(node, "lineno", 0)))

    def ancestors(self, node):
        while node in self.parents:
            node = self.parents[node]
            yield node

    def enclosing_function(self, node):
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    def under_with_matching(self, node, pattern):
        """True when ``node`` sits lexically inside a ``with`` whose
        context expression's source text matches ``pattern`` (a
        compiled regex) — the "holds its lock" check."""
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.With, ast.AsyncWith)):
                for item in anc.items:
                    try:
                        txt = ast.unparse(item.context_expr)
                    except Exception:
                        txt = ""
                    if pattern.search(txt):
                        return True
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                # a lock held by a caller does not extend into a
                # nested function body that may run on another thread
                return False
        return False

    def call_name(self, call):
        """("torch", "compile") for ``torch.compile(...)`` / aliased forms;
        (None, "open") for a bare call; (None, None) when the callee
        is not a name/attribute."""
        fn = call.func
        if isinstance(fn, ast.Name):
            return None, fn.id
        if isinstance(fn, ast.Attribute) and isinstance(fn.value,
                                                        ast.Name):
            return fn.value.id, fn.attr
        return None, None


# ---------------------------------------------------------------------------
# rule registry
# ---------------------------------------------------------------------------

RULES: Dict[str, Callable] = {}
_RULE_DOCS: Dict[str, str] = {}


def rule(name, doc):
    """Register a rule under its kebab-case ``name`` with a one-line
    ``doc`` (rendered by ``--list-rules`` and the README table)."""
    def deco(fn):
        RULES[name] = fn
        _RULE_DOCS[name] = doc
        fn.rule_name = name
        fn.rule_doc = doc
        return fn
    return deco


def rule_names():
    return sorted(RULES)


def rule_docs():
    return dict(_RULE_DOCS)


# ---------------------------------------------------------------------------
# per-file run
# ---------------------------------------------------------------------------

def _normalize(path):
    """Report paths as ``mxnet_tpu_torch/...`` whenever the file lives
    under the package — baseline entries must match no matter which
    working directory or absolute prefix the lint ran from."""
    norm = os.path.normpath(path).replace(os.sep, "/")
    idx = norm.rfind("mxnet_tpu_torch/")
    return norm[idx:] if idx >= 0 else norm


def _suppressions(lines):
    per_line: Dict[int, set] = {}
    file_wide: set = set()
    for i, text in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if m:
            rules = {r.strip() for r in m.group(1).split(",")
                     if r.strip()}
            per_line.setdefault(i, set()).update(rules)
        m = _SUPPRESS_FILE_RE.search(text)
        if m and i <= 10:
            file_wide.update(r.strip() for r in m.group(1).split(",")
                             if r.strip())
    return per_line, file_wide


def lint_source(source, path="<string>", rules=None,
                count_suppressed=None):
    """Lint one source string; returns the UNSUPPRESSED violations.
    ``rules`` optionally restricts to a subset of rule names.
    ``count_suppressed`` (a list) collects suppressed findings."""
    from . import rules as _rules_mod  # noqa: F401 — registers RULES
    relpath = _normalize(path)
    try:
        tree = ast.parse(source)
    except SyntaxError as exc:
        return [Violation("parse-error", relpath, exc.lineno or 0,
                          exc.offset or 0, "cannot parse: %s" % exc)]
    ctx = FileCtx(path, relpath, source, tree)
    per_line, file_wide = _suppressions(ctx.lines)
    active = RULES if rules is None else {
        n: RULES[n] for n in rules}
    out = []
    for name, fn in active.items():
        for v in fn(ctx):
            if v.rule in file_wide or \
                    v.rule in per_line.get(v.line, ()):
                if count_suppressed is not None:
                    count_suppressed.append(v)
                continue
            out.append(v)
    out.sort(key=lambda v: (v.path, v.line, v.rule))
    return out


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

def package_root():
    """Absolute path of the ``mxnet_tpu_torch`` package directory."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def default_baseline_path():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def load_baseline(path=None):
    """The committed baseline: ``{"entries": [{"rule", "path",
    "context", "rationale"}]}``.  Every entry MUST carry a non-empty
    rationale — a grandfathered violation without a written reason is
    itself an error."""
    path = path or default_baseline_path()
    if not os.path.exists(path):
        return []
    with open(path) as f:
        data = json.load(f)
    entries = data.get("entries", [])
    for e in entries:
        if not str(e.get("rationale", "")).strip():
            raise ValueError(
                "baseline %s: entry %r has no rationale — every "
                "grandfathered violation must say why" % (path, e))
    return entries


class LintResult:
    def __init__(self, violations, baselined, suppressed, files,
                 elapsed_s, stale_baseline):
        self.violations = violations        # non-baselined findings
        self.baselined = baselined          # matched baseline entries
        self.suppressed = suppressed        # inline-suppressed count
        self.files = files
        self.elapsed_s = elapsed_s
        self.stale_baseline = stale_baseline  # entries matching nothing

    @property
    def ok(self):
        return not self.violations

    def counts(self):
        by_rule: Dict[str, int] = {}
        for v in self.violations:
            by_rule[v.rule] = by_rule.get(v.rule, 0) + 1
        return by_rule

    def to_dict(self):
        return {
            "version": 1,
            "ok": self.ok,
            "files": self.files,
            "elapsed_s": round(self.elapsed_s, 3),
            "counts": self.counts(),
            "violations": [v.to_dict() for v in self.violations],
            "baselined": [v.to_dict() for v in self.baselined],
            "suppressed": self.suppressed,
            "stale_baseline": self.stale_baseline,
        }


def _walk_py(paths):
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if d not in ("__pycache__", ".git"))
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(root, f)


def lint_paths(paths=None, rules=None, baseline=None,
               use_baseline=True):
    """Lint files/directories (default: the installed
    ``mxnet_tpu_torch`` package).  Baseline entries absorb matching findings; entries that
    match nothing are reported in ``stale_baseline`` so the file never
    accretes dead weight."""
    t0 = time.perf_counter()
    if paths is None or not list(paths):
        paths = [package_root()]
    entries = []
    if use_baseline:
        entries = baseline if isinstance(baseline, list) \
            else load_baseline(baseline)
    bl_index = {}
    for e in entries:
        bl_index.setdefault(
            (e["rule"], e["path"], e.get("context", "")), e)
    matched = set()
    violations: List[Violation] = []
    baselined: List[Violation] = []
    suppressed: List[Violation] = []
    files = 0
    seen_paths = set()
    for fname in _walk_py(paths):
        files += 1
        seen_paths.add(_normalize(fname))
        try:
            with open(fname, encoding="utf-8") as f:
                source = f.read()
        except (OSError, UnicodeDecodeError) as exc:
            violations.append(Violation(
                "parse-error", _normalize(fname), 0, 0,
                "cannot read: %s" % exc))
            continue
        for v in lint_source(source, fname, rules=rules,
                             count_suppressed=suppressed):
            key = v.key()
            if key in bl_index:
                matched.add(key)
                baselined.append(v)
            else:
                violations.append(v)
    # an entry is stale only when its file WAS linted and nothing
    # matched — linting a subtree must not flag the rest of the
    # baseline as dead
    stale = [e for k, e in bl_index.items()
             if k not in matched and e["path"] in seen_paths]
    return LintResult(violations, baselined, len(suppressed), files,
                      time.perf_counter() - t0, stale)
