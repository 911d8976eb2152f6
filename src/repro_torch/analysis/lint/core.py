"""Core machinery for repro-lint: contexts, pragmas, and the file walker.

A copy of ``repro/analysis/lint/core.py`` over the port's paths.  Pure
stdlib (``ast`` + ``re`` + ``pathlib``) so the linter runs where neither
torch nor a card is installed.  Rules live in
:mod:`repro_torch.analysis.lint.rules` and register themselves via
:func:`rule`; this module only knows how to parse files, resolve import
aliases, and apply suppressions.

Suppression has exactly two mechanisms, both of which require a reason:

* An inline pragma on the flagged line (or the line above)::

      time.sleep(wait)  # repro-lint: allow[R002] wall-clock engines nap for real

  A pragma without a reason does **not** suppress — the violation is
  reported with a note saying so.  This keeps every exemption auditable.

* A module-level entry in :data:`FILE_ALLOWLIST`, keyed by
  ``(posix-suffix, rule-id)``, for files whose entire purpose violates a
  rule (e.g. the async tool executor sleeps simulated seconds by design).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Violations and rule registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Violation:
    """One rule breach at a source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


#: rule id -> (one-line title, check function).  Populated by :func:`rule`.
RULES: Dict[str, Tuple[str, Callable[["FileContext"], Iterator[Violation]]]] = {}


def rule(rule_id: str, title: str):
    """Decorator registering a check function under ``rule_id``."""

    def register(fn):
        RULES[rule_id] = (title, fn)
        return fn

    return register


#: whole-file exemptions: (path suffix, rule id) -> reason.  The suffix is
#: matched against the file's posix path, so entries stay stable across
#: checkout locations.  Every entry must explain itself; the CLI prints the
#: allowlist so exemptions stay visible.
FILE_ALLOWLIST: Dict[Tuple[str, str], str] = {
    ("repro_torch/offload/tools.py", "R002"): (
        "the async tool executor models tool latency with REAL sleeping "
        "threads so the engine's decode/tool overlap is measured, not "
        "simulated; this is the tool-loop wall path, and it never runs "
        "under a SimClock"
    ),
}

# ``# repro-lint: allow[R002] reason`` / ``allow[R002,R004] reason``
_PRAGMA_RE = re.compile(
    r"#\s*repro-lint:\s*allow\[([A-Z0-9,\s]+)\]\s*(.*?)\s*$"
)


# ---------------------------------------------------------------------------
# Per-file context
# ---------------------------------------------------------------------------


class FileContext:
    """Parsed source plus the lookup helpers every rule needs."""

    def __init__(self, source: str, path: str = "<memory>",
                 module: Optional[str] = None) -> None:
        self.source = source
        self.path = path
        #: posix-style path used for scope/allowlist matching; callers pass
        #: the repo-relative path, fixtures can fake one (e.g.
        #: ``repro_torch/serving/fake.py``) to land inside a rule's scope.
        self.module = (module or path).replace("\\", "/")
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        self._link_parents()
        self.aliases: Dict[str, str] = {}
        self._collect_imports()
        #: pre-parsed pragmas: line -> (set of rule ids, reason)
        self.pragmas: Dict[int, Tuple[set, str]] = {}
        self._collect_pragmas()

    # -- structure -----------------------------------------------------

    def _link_parents(self) -> None:
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                child._repro_parent = parent  # type: ignore[attr-defined]

    def scopes(self, node: ast.AST) -> List[ast.AST]:
        """Enclosing function/class scopes, outermost first, excluding node."""
        chain: List[ast.AST] = []
        cur = getattr(node, "_repro_parent", None)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda, ast.ClassDef)):
                chain.append(cur)
            cur = getattr(cur, "_repro_parent", None)
        chain.reverse()
        return chain

    def enclosing_functions(self, node: ast.AST) -> List[ast.AST]:
        return [s for s in self.scopes(node)
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda))]

    # -- imports -------------------------------------------------------

    def _collect_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    name = alias.asname or alias.name.split(".")[0]
                    # ``import a.b`` binds ``a``; ``import a.b as c`` binds c->a.b
                    target = alias.name if alias.asname else alias.name.split(".")[0]
                    self.aliases[name] = target
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    bound = alias.asname or alias.name
                    self.aliases[bound] = f"{node.module}.{alias.name}"

    @property
    def imports_torch(self) -> bool:
        return any(tgt == "torch" or tgt.startswith("torch.")
                   for tgt in self.aliases.values())

    def dotted(self, node: ast.AST) -> Optional[str]:
        """Resolve a Name/Attribute chain to a dotted module path.

        ``np.asarray`` -> ``numpy.asarray`` when the file did
        ``import numpy as np``; ``sleep`` -> ``time.sleep`` after
        ``from time import sleep``.  Returns None for anything that is not
        a plain chain rooted at a known alias or bare name.
        """
        parts: List[str] = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return None
        root = self.aliases.get(cur.id, cur.id)
        parts.append(root)
        parts.reverse()
        return ".".join(parts)

    # -- pragmas -------------------------------------------------------

    def _collect_pragmas(self) -> None:
        for lineno, text in enumerate(self.lines, start=1):
            m = _PRAGMA_RE.search(text)
            if m is None:
                continue
            ids = {p.strip() for p in m.group(1).split(",") if p.strip()}
            self.pragmas[lineno] = (ids, m.group(2).strip())

    def suppressed(self, rule_id: str, line: int) -> Optional[bool]:
        """None = no pragma; True = valid suppression; False = reasonless."""
        for lineno in (line, line - 1):
            entry = self.pragmas.get(lineno)
            if entry and rule_id in entry[0]:
                return bool(entry[1])
        return None

    def allowlisted(self, rule_id: str) -> bool:
        return any(self.module.endswith(suffix) and rid == rule_id
                   for (suffix, rid) in FILE_ALLOWLIST)


# ---------------------------------------------------------------------------
# Project index (cross-file class table for R005)
# ---------------------------------------------------------------------------


@dataclass
class ClassInfo:
    name: str
    module: str
    bases: List[str] = field(default_factory=list)
    attrs: set = field(default_factory=set)
    is_protocol: bool = False


def _class_attrs(node: ast.ClassDef) -> set:
    """Names statically assigned at class level or as ``self.X`` in methods."""
    attrs: set = set()
    for stmt in node.body:
        if isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name):
                    attrs.add(tgt.id)
        elif isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
            attrs.add(stmt.target.id)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            attrs.add(stmt.name)
            for sub in ast.walk(stmt):
                tgts: List[ast.AST] = []
                if isinstance(sub, ast.Assign):
                    tgts = list(sub.targets)
                elif isinstance(sub, (ast.AnnAssign, ast.AugAssign)):
                    tgts = [sub.target]
                for tgt in tgts:
                    if (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        attrs.add(tgt.attr)
                    elif isinstance(tgt, ast.Tuple):
                        for el in tgt.elts:
                            if (isinstance(el, ast.Attribute)
                                    and isinstance(el.value, ast.Name)
                                    and el.value.id == "self"):
                                attrs.add(el.attr)
    return attrs


def _base_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Subscript):  # Protocol[...] / Generic[...]
        return _base_name(node.value)
    return None


def build_index(contexts: Iterable[FileContext]) -> Dict[str, ClassInfo]:
    """Cross-file class table so R005 can resolve inherited attributes."""
    index: Dict[str, ClassInfo] = {}
    for ctx in contexts:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            bases = [b for b in (_base_name(n) for n in node.bases) if b]
            index[node.name] = ClassInfo(
                name=node.name,
                module=ctx.module,
                bases=bases,
                attrs=_class_attrs(node),
                is_protocol="Protocol" in bases,
            )
    return index


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _apply(ctx: FileContext,
           rule_ids: Iterable[str]) -> List[Violation]:
    out: List[Violation] = []
    for rid in rule_ids:
        title, fn = RULES[rid]
        if ctx.allowlisted(rid):
            continue
        for v in fn(ctx):
            sup = ctx.suppressed(v.rule, v.line)
            if sup is True:
                continue
            if sup is False:
                v = Violation(v.rule, v.path, v.line, v.col,
                              v.message + " (pragma present but missing a "
                              "reason; suppressions must explain themselves)")
            out.append(v)
    return out


def lint_source(source: str, path: str = "<fixture>",
                module: Optional[str] = None,
                rules: Optional[Iterable[str]] = None,
                index: Optional[Dict[str, ClassInfo]] = None) -> List[Violation]:
    """Lint a source string (fixture entry point for tests)."""
    _ensure_rules()
    ctx = FileContext(source, path=path, module=module)
    ctx.index = index if index is not None else build_index([ctx])  # type: ignore[attr-defined]
    return _apply(ctx, rules or sorted(RULES))


def iter_py_files(root: Path) -> Iterator[Path]:
    for p in sorted(root.rglob("*.py")):
        if "__pycache__" in p.parts:
            continue
        yield p


def lint_paths(paths: Iterable[Path],
               rules: Optional[Iterable[str]] = None) -> List[Violation]:
    """Lint files/trees; returns violations sorted by path/line."""
    _ensure_rules()
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        files.extend(iter_py_files(p) if p.is_dir() else [p])
    contexts: List[FileContext] = []
    errors: List[Violation] = []
    for f in files:
        rel = f.as_posix()
        try:
            contexts.append(FileContext(f.read_text(), path=str(f), module=rel))
        except SyntaxError as e:  # a file the linter can't parse is a finding
            errors.append(Violation("R000", str(f), e.lineno or 0, 0,
                                    f"unparseable source: {e.msg}"))
    index = build_index(contexts)
    out = list(errors)
    for ctx in contexts:
        ctx.index = index  # type: ignore[attr-defined]
        out.extend(_apply(ctx, rules or sorted(RULES)))
    out.sort(key=lambda v: (v.path, v.line, v.rule))
    return out


def _ensure_rules() -> None:
    if not RULES:
        from repro_torch.analysis.lint import rules as _rules  # noqa: F401
