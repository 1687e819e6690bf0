"""pslint core: source loading, the repo index, suppressions, findings.

The port's copy of the reference's analysis core (ROADMAP Queue 1 item
6.5). The analysis layer (README "Static analysis") is repo-aware, not
generic:
each rule family encodes an invariant THIS codebase's data plane depends
on — blocking calls must not run under hot locks, every van message kind
needs a name and a handler, every borrowed receive buffer goes home, every
``PS_*`` knob is documented everywhere it is surfaced. Rules operate on a
:class:`RepoIndex` (parsed ASTs + comment maps for every file under the
linted roots, plus read-only *context* files that provide cross-file
evidence — e.g. ``tools/ps_top.py`` consumes STATS header keys that
``ps_tpu_torch``'s services produce).

Suppression contract: a finding is silenced ONLY by an inline comment on
the finding's line::

    risky_call()  # pslint: disable=PSL101 -- why this one is safe

The reason string after ``--`` is mandatory; a suppression without one is
itself a finding (PSL001), so the lint gate cannot be quieted without
leaving a justification in the diff. Several ids may be listed
(``disable=PSL101,PSL203``).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import time
import tokenize
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

__all__ = [
    "Finding", "SourceFile", "RepoIndex", "rule", "all_rules", "run_lint",
]

#: suppression comment shape: ``# pslint: disable=PSL101[,PSL102] -- reason``
_SUPPRESS_RE = re.compile(
    r"#\s*pslint:\s*disable=(?P<rules>[A-Z0-9,\s]+?)"
    r"(?:\s*--\s*(?P<reason>.*\S))?\s*$"
)

#: severity order, worst first (P0 = job-corrupting, P3 = hygiene)
SEVERITIES = ("P0", "P1", "P2", "P3")


@dataclasses.dataclass
class Finding:
    """One rule violation, anchored to a line so a suppression can name it."""

    rule: str
    severity: str
    path: str
    line: int
    message: str

    def format(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} [{self.severity}] "
                f"{self.message}")


class SourceFile:
    """One parsed Python file: AST + per-line suppression map."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        # line -> (set of suppressed rule ids, reason or None)
        self.suppressions: Dict[int, Tuple[Set[str], Optional[str]]] = {}
        try:
            tokens = tokenize.generate_tokens(io.StringIO(text).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _SUPPRESS_RE.search(tok.string)
                if not m:
                    continue
                ids = {r.strip() for r in m.group("rules").split(",")
                       if r.strip()}
                self.suppressions[tok.start[0]] = (ids, m.group("reason"))
        except tokenize.TokenError:
            pass  # a file the parser accepted but tokenize chokes on

    def suppressed(self, rule_id: str, line: int) -> bool:
        entry = self.suppressions.get(line)
        return entry is not None and rule_id in entry[0]


#: native sources the cross-language families (PSL5xx/PSL6xx) scan: the
#: C++ van and the CUDA kernels under ``ops/csrc/``
CPP_SUFFIXES = (".cpp", ".cc", ".cxx", ".h", ".hpp", ".cu", ".cuh")


class RepoIndex:
    """Every file a lint run can see.

    ``files`` are the linted roots (findings anchor here); ``context``
    files contribute evidence only — a consumer of a wire header key in
    ``tools/`` keeps the producing site in ``ps_tpu_torch/`` clean, but
    nothing in a context file is ever reported. ``readme`` is the prose
    side of the knob-drift family.

    ``cpp_files`` are the native sources, collected from the linted
    roots AND the context roots, and — unlike Python context — always
    linted: the producer/consumer asymmetry that context exists for is a
    Python-rule concept, while the native invariants (lock order, the
    ``wait_for`` toolchain ban, ownership annotations) bind the
    port's C++ van (``native/van.cpp``) and its CUDA kernels
    (``ops/csrc/*.cu``) alike.
    """

    def __init__(self, paths: Iterable[str],
                 context: Iterable[str] = (),
                 readme: Optional[str] = None):
        self.files: List[SourceFile] = []
        self.context: List[SourceFile] = []
        self.cpp_files: list = []  # List[cpp.CppSourceFile]
        self.readme_path = readme
        self.readme_text = ""
        self.errors: List[Finding] = []
        seen: Set[str] = set()
        for path in self._expand(paths):
            if path in seen:
                continue
            seen.add(path)
            sf = self._load(path)
            if sf is not None:
                (self.cpp_files if path.endswith(CPP_SUFFIXES)
                 else self.files).append(sf)
        for path in self._expand(context):
            if path in seen:
                continue
            seen.add(path)
            sf = self._load(path)
            if sf is not None:
                (self.cpp_files if path.endswith(CPP_SUFFIXES)
                 else self.context).append(sf)
        if readme:
            try:
                with open(readme, encoding="utf-8") as f:
                    self.readme_text = f.read()
            except OSError:
                self.readme_text = ""

    def _expand(self, paths: Iterable[str]) -> List[str]:
        exts = (".py",) + CPP_SUFFIXES
        out: List[str] = []
        for p in paths:
            if os.path.isdir(p):
                for root, dirs, names in os.walk(p):
                    dirs[:] = sorted(d for d in dirs
                                     if d not in ("__pycache__", ".git"))
                    for n in sorted(names):
                        if n.endswith(exts):
                            out.append(os.path.join(root, n))
            elif os.path.isfile(p) and p.endswith(exts):
                out.append(p)
            else:
                # a typo'd/renamed root must FAIL the gate, not silently
                # lint zero files and report clean
                self.errors.append(Finding(
                    "PSL000", "P1", p, 1,
                    "path does not exist or is not a directory/.py file — "
                    "nothing was linted for this argument"))
        return out

    def _load(self, path: str):
        try:
            with open(path, encoding="utf-8") as f:
                text = f.read()
            if path.endswith(CPP_SUFFIXES):
                from ps_tpu_torch.analysis.cpp import CppSourceFile

                return CppSourceFile(path, text)
            return SourceFile(path, text)
        except (OSError, SyntaxError) as e:
            self.errors.append(Finding(
                "PSL000", "P1", path, getattr(e, "lineno", 1) or 1,
                f"file could not be parsed: {e}"))
            return None

    @property
    def all_files(self) -> List[SourceFile]:
        return self.files + self.context


# -- rule registry -------------------------------------------------------------

RuleFn = Callable[[RepoIndex], Iterable[Finding]]
_RULES: Dict[str, Tuple[str, RuleFn]] = {}


def rule(rule_id_prefix: str, doc: str):
    """Register a rule family entry point. One function may emit several
    concrete ids sharing the prefix (PSL20x etc.); the prefix is what the
    registry lists."""

    def deco(fn: RuleFn) -> RuleFn:
        _RULES[rule_id_prefix] = (doc, fn)
        return fn

    return deco


def all_rules() -> Dict[str, Tuple[str, RuleFn]]:
    # import for side effect: each family module registers itself
    from ps_tpu_torch.analysis import (  # noqa: F401
        abi,
        knobs,
        locks,
        native,
        resources,
        wire,
    )

    return dict(_RULES)


def _suppression_findings(index: RepoIndex) -> List[Finding]:
    """PSL001: a suppression with no reason is a violation itself —
    the gate must never be quietable without a justification string.
    Applies to both languages (``# pslint:`` and ``// pslint:``)."""
    out: List[Finding] = []
    for sf in index.files + index.cpp_files:
        for line, (ids, reason) in sorted(sf.suppressions.items()):
            if not reason:
                out.append(Finding(
                    "PSL001", "P1", sf.path, line,
                    f"suppression for {','.join(sorted(ids))} carries no "
                    f"reason — use '# pslint: disable=<id> -- <why>'"))
            for rid in ids:
                if not re.fullmatch(r"PSL\d{3}[a-z]?", rid):
                    out.append(Finding(
                        "PSL002", "P2", sf.path, line,
                        f"suppression names unknown rule id {rid!r}"))
    return out


def run_lint(paths: Iterable[str], context: Iterable[str] = (),
             readme: Optional[str] = None,
             rules: Optional[Iterable[str]] = None,
             timings: Optional[Dict[str, float]] = None) -> List[Finding]:
    """Run every registered rule family over ``paths``; returns the
    surviving (unsuppressed) findings, worst severity first.

    ``rules`` entries may be family prefixes (``PSL1``) or concrete ids
    (``PSL101`` — runs the family, keeps only matching findings). An
    entry matching no registered family raises ``ValueError``: a typo'd
    selection must never yield a silent 'clean'. ``timings``, when a
    dict, receives per-family wall seconds (the CI budget probe).
    """
    registry = sorted(all_rules().items())
    selected = None
    if rules is not None:
        selected = list(rules)
        unknown = [r for r in selected
                   if not any(r.startswith(prefix) or prefix.startswith(r)
                              for prefix, _ in registry)]
        if unknown:
            raise ValueError(
                f"--rules names no registered rule family: "
                f"{', '.join(sorted(unknown))} (known: "
                f"{', '.join(p for p, _ in registry)})")
    try:
        return _run(registry, selected, paths, context, readme, timings)
    finally:
        clear_caches()


def _run(registry, selected, paths, context, readme, timings):
    index = RepoIndex(paths, context=context, readme=readme)
    findings: List[Finding] = list(index.errors)
    for prefix, (_doc, fn) in registry:
        if selected is not None and not any(
                r.startswith(prefix) or prefix.startswith(r)
                for r in selected):
            continue
        t0 = time.monotonic()
        fam = list(fn(index))
        if timings is not None:
            timings[prefix] = time.monotonic() - t0
        if selected is not None:
            # a concrete id (PSL101) keeps only its own findings out of
            # the family run; a bare prefix keeps the whole family
            fam = [f for f in fam
                   if any(f.rule.startswith(r) or r.startswith(f.rule)
                          for r in selected)]
        findings.extend(fam)
    # suppression pass: a finding whose line carries its rule id survives
    # only as nothing; the reason requirement is enforced separately
    by_path = {sf.path: sf for sf in index.files + index.cpp_files}
    kept = []
    for f in findings:
        sf = by_path.get(f.path)
        if sf is not None and sf.suppressed(f.rule, f.line):
            continue
        kept.append(f)
    kept.extend(_suppression_findings(index))
    kept.sort(key=lambda f: (SEVERITIES.index(f.severity)
                             if f.severity in SEVERITIES else 9,
                             f.path, f.line, f.rule))
    return kept


# -- shared AST helpers --------------------------------------------------------


def attr_chain(node: ast.AST) -> Optional[List[str]]:
    """``self._engine._lock`` -> ``["self", "_engine", "_lock"]``; None for
    expressions that are not plain name/attribute chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return None


def terminal_name(node: ast.AST) -> Optional[str]:
    """The final attribute (or bare name) of a call target / with-item."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def str_const(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


#: id(node) -> (node, result): the node is held, so its id stays its own
_WALKS: Dict[int, Tuple[ast.AST, list]] = {}
_FUNCTIONS: Dict[int, Tuple[ast.AST, list]] = {}


def walk(node: ast.AST) -> List[ast.AST]:
    """``list(ast.walk(node))``, in the same order, computed once per
    node while a lint runs (every family walks the same trees)."""
    hit = _WALKS.get(id(node))
    if hit is None:
        hit = _WALKS[id(node)] = (node, list(ast.walk(node)))
    return hit[1]


def clear_caches() -> None:
    _WALKS.clear()
    _FUNCTIONS.clear()


def walk_functions(tree: ast.AST):
    """``(classname_or_None, funcdef)`` for every function in a module,
    attributing methods to their (innermost) class (computed once per
    tree while a lint runs)."""
    hit = _FUNCTIONS.get(id(tree))
    if hit is not None:
        return hit[1]

    def visit(node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from visit(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield cls, child
                yield from visit(child, cls)
            else:
                yield from visit(child, cls)

    out = list(visit(tree, None))
    _FUNCTIONS[id(tree)] = (tree, out)
    return out
