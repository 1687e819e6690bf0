"""PSL2xx — wire-protocol conformance for the tensor van.

The van's protocol and its ``extra`` json header are the ONE contract
every process in a job must agree on — the port's processes and the
reference's alike — and nothing type-checks it: a kind without a
:data:`~ps_tpu_torch.control.tensor_van.KIND_NAMES` entry renders as
``kind17`` in every trace span, ps_top row, and flight event; a kind no
server dispatch ever compares against is a silent drop; a header key the
producer writes but no consumer reads is dead wire bytes (or a consumer
reading a key nobody writes is a silent ``None`` default — the worse
direction). Three rules:

- **PSL201** — every message-kind constant in the module that defines
  ``KIND_NAMES`` must have a name entry (and every name entry a
  constant).
- **PSL202** — every kind except the declared reply-only kinds
  (``OK``/``ERR``) must be *handled*: compared against a ``kind``
  variable with ``==``/``in`` somewhere in the repo (frozenset literals
  such as ``_REPLICA_KINDS`` that are themselves used in a ``kind in``
  test count as handling their members).
- **PSL203** — producer/consumer symmetry of ``extra[...]`` header keys:
  a key consumed somewhere must be produced somewhere and vice versa.
  Producers: dict-literal ``extra=`` arguments (and dicts flowing into
  encode calls through a local name), dict literals handed to a
  header-named parameter of a repo function by position or by keyword
  (the port's ``_coord_request(addr, kind, extra={...})``),
  ``extra["k"] = ...`` stores, ``extra.update({...})``, and dict
  literals built in ``*extra*`` / ``*meta*`` / ``*state*`` helper
  functions. Consumers: ``extra["k"]`` / ``extra.get("k")`` reads in the
  linted tree, plus *loose* reads (any string-key subscript/.get) in
  context files — ``tools/ps_top.py``, ``tools/ps_doctor.py`` and
  ``chip_smoke.py`` legitimately consume STATS keys through other
  variable names. ``obs.WIRE_KEY`` subscripts resolve to the literal
  ``"tc"``.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from ps_tpu_torch.analysis.core import (
    Finding,
    RepoIndex,
    SourceFile,
    rule,
    str_const,
    terminal_name,
    walk,
)

#: kinds that only ever travel as replies: nothing dispatches on them
REPLY_ONLY_KINDS = {"OK", "ERR"}

#: receiver names that BUILD a frame header dict in ps_tpu_torch code
_HEADER_NAMES = {"extra", "meta", "payload_extra", "hello_extra", "hello"}

#: receiver names that READ a decoded header ("meta" deliberately absent:
#: ``meta["tensors"]`` in the codec is frame structure, not the extra
#: header)
_CONSUMER_NAMES = {"extra", "payload_extra", "hello_extra"}

#: the symbolic header key (ps_tpu_torch.obs.WIRE_KEY) and its literal value
_WIRE_KEY_ATTR = "WIRE_KEY"
_WIRE_KEY_VALUE = "tc"

_PRODUCER_FN_RE = re.compile(r"(extra|meta|state|_stats)")

_ENCODE_FN_RE = re.compile(r"encode")


def _find_kind_module(index: RepoIndex) -> Optional[SourceFile]:
    for sf in index.all_files:
        for node in sf.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == "KIND_NAMES":
                return sf
    return None


def _kind_constants(sf: SourceFile) -> Dict[str, int]:
    """Top-level ``NAME = <int>`` assignments in the KIND_NAMES module."""
    out: Dict[str, int] = {}
    for node in sf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if name.startswith("_") or not name.isupper():
                continue
            if isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, int) \
                    and not isinstance(node.value.value, bool):
                out[name] = node.value.value
    return out


def _kind_names_entries(sf: SourceFile) -> Tuple[Set[str], int]:
    """Names referenced as keys of the KIND_NAMES dict + its line."""
    for node in sf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "KIND_NAMES" \
                and isinstance(node.value, ast.Dict):
            keys = {k.id for k in node.value.keys
                    if isinstance(k, ast.Name)}
            return keys, node.lineno
    return set(), 1


def _handled_kinds(index: RepoIndex, kind_names: Set[str]) -> Set[str]:
    """Kind constants compared against a ``kind`` variable (==, in), plus
    members of set/tuple literals that are themselves used in a
    ``kind in <name>`` test."""
    handled: Set[str] = set()
    # set-literal names used in `kind in self.X` / `kind in X`
    member_sets: Dict[str, Set[str]] = {}
    in_tests: Set[str] = set()
    for sf in index.all_files:
        for node in walk(sf.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tname = terminal_name(node.targets[0])
                value = node.value
                if isinstance(value, ast.Call) \
                        and terminal_name(value.func) == "frozenset" \
                        and value.args:
                    value = value.args[0]
                if tname and isinstance(value, (ast.Set, ast.Tuple,
                                                ast.List)):
                    names = {terminal_name(e) for e in value.elts}
                    names = {n for n in names if n in kind_names}
                    if names:
                        member_sets[tname] = names
            if not isinstance(node, ast.Compare):
                continue
            if not (isinstance(node.left, ast.Name)
                    and node.left.id == "kind"):
                continue
            for op, comp in zip(node.ops, node.comparators):
                if isinstance(op, ast.Eq):
                    t = terminal_name(comp)
                    if t in kind_names:
                        handled.add(t)
                elif isinstance(op, ast.In):
                    if isinstance(comp, (ast.Set, ast.Tuple, ast.List)):
                        for e in comp.elts:
                            t = terminal_name(e)
                            if t in kind_names:
                                handled.add(t)
                    else:
                        t = terminal_name(comp)
                        if t:
                            in_tests.add(t)
    for setname in in_tests:
        handled |= member_sets.get(setname, set())
    return handled


def _header_key(node: ast.AST) -> Optional[str]:
    """The literal header key of a dict key / subscript index expression;
    resolves the WIRE_KEY symbol to its literal."""
    s = str_const(node)
    if s is not None:
        return s
    t = terminal_name(node)
    if t == _WIRE_KEY_ATTR:
        return _WIRE_KEY_VALUE
    return None


def _dict_literal_keys(node: ast.Dict) -> List[Tuple[str, int]]:
    out = []
    for k in node.keys:
        if k is None:
            continue  # **merge
        key = _header_key(k)
        if key is not None:
            out.append((key, k.lineno))
    return out


class _KeyUse:
    def __init__(self):
        self.produced: Dict[str, Tuple[str, int]] = {}
        self.consumed: Dict[str, Tuple[str, int]] = {}
        # context-file reads: evidence that a produced key is alive, but
        # never themselves findings (tools read STATS dicts through
        # arbitrary names — "consumed but unproduced" there means nothing)
        self.loose_consumed: Set[str] = set()

    def produce(self, key: str, path: str, line: int) -> None:
        self.produced.setdefault(key, (path, line))

    def consume(self, key: str, path: str, line: int,
                loose: bool = False) -> None:
        if loose:
            self.loose_consumed.add(key)
        else:
            self.consumed.setdefault(key, (path, line))


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in walk(node) if isinstance(n, ast.Name)}


def _touches_van(sf: SourceFile) -> bool:
    """Only files that touch the van's framing (import tensor_van, define
    the kinds, or handle the trace wire key) participate in PSL203 —
    dict literals in e.g. the checkpoint meta protocol are not wire
    headers and must not pollute the symmetry sets."""
    return ("tensor_van" in sf.text or "KIND_NAMES" in sf.text
            or "WIRE_KEY" in sf.text)


def _param_index(sf: SourceFile) -> Dict[str, List[str]]:
    """function/method name -> parameter names (self stripped), for
    resolving dict literals passed to header-named parameters."""
    from ps_tpu_torch.analysis.core import walk_functions

    out: Dict[str, List[str]] = {}
    for cls, fn in walk_functions(sf.tree):
        params = [a.arg for a in fn.args.args]
        if params and params[0] in ("self", "cls"):
            params = params[1:]
        out.setdefault(fn.name, params)
    return out


def _scan_header_keys(sf: SourceFile, use: _KeyUse, loose: bool,
                      params: Optional[Dict[str, List[str]]] = None) -> None:
    """Collect produced/consumed header keys in one file. ``loose``
    relaxes the receiver-name requirement for consumers (context files
    read STATS extras through arbitrary variable names)."""
    params = params or {}
    for cls, fn in _functions_with_module(sf.tree):
        # dict literals assigned to locals that later feed an encode call
        extra_locals: Set[str] = set()
        for node in walk(fn):
            if isinstance(node, ast.Call) \
                    and _ENCODE_FN_RE.search(terminal_name(node.func) or ""):
                for kw in node.keywords:
                    if kw.arg == "extra" and isinstance(kw.value, ast.Name):
                        extra_locals.add(kw.value.id)
                for arg in node.args[3:4]:  # encode(kind, w, tensors, extra)
                    if isinstance(arg, ast.Name):
                        extra_locals.add(arg.id)
        producer_fn = bool(_PRODUCER_FN_RE.search(fn.name))
        for node in walk(fn):
            if isinstance(node, ast.Assign) and not loose \
                    and isinstance(node.value, ast.Dict) \
                    and any(isinstance(t, ast.Name)
                            and t.id in ("extra", "hello")
                            for t in node.targets):
                # `extra = {"epoch": ..., ...}` built up then sent
                for key, line in _dict_literal_keys(node.value):
                    use.produce(key, sf.path, line)
            if isinstance(node, ast.Call):
                fname = terminal_name(node.func) or ""
                if not loose and not _ENCODE_FN_RE.search(fname):
                    # dict literal handed to a header-named parameter of
                    # a repo function (e.g. _checkpoint_round's
                    # payload_extra), and kwargs of *extra* helpers
                    callee_params = params.get(fname)
                    if callee_params:
                        for pos, arg in enumerate(node.args):
                            if isinstance(arg, ast.Dict) \
                                    and pos < len(callee_params) \
                                    and callee_params[pos] in _HEADER_NAMES:
                                for key, line in _dict_literal_keys(arg):
                                    use.produce(key, sf.path, line)
                        # ... or by keyword, the port's spelling
                        # (``_coord_request(addr, kind, extra={...})``)
                        for kw in node.keywords:
                            if isinstance(kw.value, ast.Dict) \
                                    and kw.arg in _HEADER_NAMES \
                                    and kw.arg in callee_params:
                                for key, line in _dict_literal_keys(
                                        kw.value):
                                    use.produce(key, sf.path, line)
                    if _PRODUCER_FN_RE.search(fname):
                        for kw in node.keywords:
                            if kw.arg is not None:
                                use.produce(kw.arg, sf.path, node.lineno)
                if _ENCODE_FN_RE.search(fname) and not loose:
                    for kw in node.keywords:
                        if kw.arg == "extra" \
                                and isinstance(kw.value, ast.Dict):
                            for key, line in _dict_literal_keys(kw.value):
                                use.produce(key, sf.path, line)
                    for arg in node.args[3:4]:
                        if isinstance(arg, ast.Dict):
                            for key, line in _dict_literal_keys(arg):
                                use.produce(key, sf.path, line)
                if fname == "update" and not loose and node.args \
                        and isinstance(node.args[0], ast.Dict) \
                        and isinstance(node.func, ast.Attribute):
                    recv = terminal_name(node.func.value)
                    if recv in _HEADER_NAMES or recv in extra_locals \
                            or (recv == "out" and producer_fn):
                        for key, line in _dict_literal_keys(node.args[0]):
                            use.produce(key, sf.path, line)
                if fname == "get" and node.args \
                        and isinstance(node.func, ast.Attribute):
                    key = _header_key(node.args[0])
                    if key is not None:
                        recv_names = _names_in(node.func.value)
                        if loose or recv_names & _CONSUMER_NAMES:
                            use.consume(key, sf.path, node.lineno,
                                        loose=loose)
            elif isinstance(node, ast.Subscript):
                key = _header_key(node.slice)
                if key is None:
                    continue
                recv = terminal_name(node.value)
                is_header = recv in _HEADER_NAMES or recv in extra_locals
                if isinstance(node.ctx, ast.Store):
                    if not loose and (is_header
                                      or (recv == "out" and producer_fn)):
                        use.produce(key, sf.path, node.lineno)
                elif isinstance(node.ctx, ast.Load):
                    if loose or recv in _CONSUMER_NAMES:
                        use.consume(key, sf.path, node.lineno, loose=loose)
            elif isinstance(node, ast.Dict) and producer_fn and not loose:
                # helper functions building header fragments return or
                # merge dict literals (e.g. _bucket_chunks_meta's
                # {**extra, "bucket": b, ...}, replica_state()'s dict)
                has_merge = any(k is None for k in node.keys)
                if has_merge or _returned(fn, node):
                    for key, line in _dict_literal_keys(node):
                        use.produce(key, sf.path, line)


def _returned(fn: ast.AST, node: ast.Dict) -> bool:
    for r in walk(fn):
        if isinstance(r, ast.Return) and r.value is node:
            return True
        if isinstance(r, ast.Assign) and r.value is node:
            return True
    return False


def _functions_with_module(tree: ast.AST):
    """Every function plus a pseudo-entry for module-level code, so a
    header key produced/consumed at module scope (a module-level
    ``extra = {...}`` fed to an encode call, an ``extra["k"]`` read in a
    script's toplevel) still joins the symmetry sets."""
    from ps_tpu_torch.analysis.core import walk_functions

    yield from walk_functions(tree)
    top = [s for s in tree.body
           if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef))]
    if top:
        pseudo = ast.parse("def _module_(): pass").body[0]
        pseudo.name = "<module>"
        pseudo.body = top
        yield None, pseudo


@rule("PSL2", "wire protocol: kind names, handlers, header-key symmetry")
def check_wire(index: RepoIndex):
    findings: List[Finding] = []
    kind_sf = _find_kind_module(index)
    if kind_sf is not None:
        constants = _kind_constants(kind_sf)
        names, names_line = _kind_names_entries(kind_sf)
        for name in sorted(constants):
            if name not in names:
                findings.append(Finding(
                    "PSL201", "P1", kind_sf.path, names_line,
                    f"message kind {name} has no KIND_NAMES entry — it "
                    f"renders as 'kind{constants[name]}' in traces, "
                    f"ps_top, and flight events"))
        for name in sorted(names - set(constants)):
            findings.append(Finding(
                "PSL201", "P1", kind_sf.path, names_line,
                f"KIND_NAMES names {name} but no such kind constant "
                f"exists"))
        handled = _handled_kinds(index, set(constants))
        for name in sorted(constants):
            if name in REPLY_ONLY_KINDS or name in handled:
                continue
            findings.append(Finding(
                "PSL202", "P1", kind_sf.path,
                _const_line(kind_sf, name),
                f"message kind {name} is dispatched by no handler "
                f"(no 'kind == {name}' / membership test anywhere) — "
                f"frames of this kind are silently dropped"))

    use = _KeyUse()
    van_files = [sf for sf in index.files if _touches_van(sf)]
    params: Dict[str, List[str]] = {}
    for sf in van_files:
        for name, plist in _param_index(sf).items():
            params.setdefault(name, plist)
    for sf in van_files:
        _scan_header_keys(sf, use, loose=False, params=params)
    for sf in index.context:
        _scan_header_keys(sf, use, loose=True)
    for key in sorted(set(use.consumed) - set(use.produced)):
        path, line = use.consumed[key]
        findings.append(Finding(
            "PSL203", "P1", path, line,
            f"header key {key!r} is read but never produced by any "
            f"encoder — this read always sees the default"))
    alive = set(use.consumed) | use.loose_consumed
    for key in sorted(set(use.produced) - alive):
        path, line = use.produced[key]
        findings.append(Finding(
            "PSL203", "P2", path, line,
            f"header key {key!r} is produced but never consumed — dead "
            f"wire bytes, or the consumer was dropped"))
    return findings


def _const_line(sf: SourceFile, name: str) -> int:
    for node in sf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name:
            return node.lineno
    return 1
