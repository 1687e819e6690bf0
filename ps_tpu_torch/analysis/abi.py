"""PSL6xx — cross-language ABI drift: extern "C" vs the ctypes sites.

The port crosses two C ABIs by hand: the native van
(``native/van.cpp``, bound by ``control/heartbeat.py``,
``control/tensor_van.py`` and ``control/native_loop.py``) and the four
``nvcc`` kernel libraries (``ops/csrc/sparse_group.cu``,
``sparse_apply.cu``, ``flash_attention.cu``, ``lamb_apply.cu``, bound by
``ops/sparse_apply.py``, ``ops/flash_attention.py`` and
``ops/lamb_apply.py``). Nothing but
convention kept them in sync: a parameter added on the C side, a
forgotten ``restype`` (ctypes then defaults to ``c_int`` and silently
TRUNCATES a 64-bit pointer/size on the way out), a ``c_int`` where the
kernel takes ``long long`` or ``float``, or a symbol renamed in one place
only, all compile fine and fail at a distance on the card. This family
parses every ``extern "C"`` *definition* in the indexed C++ and CUDA
sources and every ``lib.<sym>.argtypes``/``.restype`` assignment plus
``lib.<sym>(...)`` call in the linted Python tree, and diffs them:

- **PSL601** — ``argtypes`` disagrees with the C signature: wrong
  arity, or a parameter whose ctypes width/kind cannot carry the C type
  (``c_int`` for a ``uint64_t``, a ``long long`` or a ``float``, a typed
  ``POINTER`` of the wrong element, an integer where C takes a pointer).
  The finding names the authoritative C signature and its location.
- **PSL602** — ``restype`` missing for a non-int return (the
  silent-truncation default; a pointer return included), or declared but
  wrong (including a restype on a ``void`` function).
- **PSL603** — Python calls an exported symbol that no linted file ever
  declared ``argtypes`` for: every argument then crosses the boundary
  un-checked.
- **PSL604** — drift: a symbol exported but neither bound nor called
  anywhere (dead ABI surface — or the binding was dropped), or Python
  binding a symbol the C side does not export (caught before the
  ``AttributeError`` at runtime, and only for symbols sharing a prefix
  family — ``tv_``/``hb_``/``nl_``/``ps_`` — with real exports, so
  bindings of unrelated libraries never false-positive).

Exports are per library: a source's library is its file stem
(``sparse_apply.cu`` -> ``sparse_apply``, ``van.cpp`` -> ``van``), and a
ctypes site's library is the one a ``load("<name>")`` call in the same
function opens (``ops/_build.load``, ``native.load``). A symbol that
several libraries define (``ps_cuda_error_string``) is an export of each,
held to the sites of its own library. A site whose library cannot be read (a
``ctypes.CDLL(path)``) is held to the first export of the symbol's name,
and counts as binding it in every library.

Width notes encoded in ``_param_ok``: ``c_void_p`` is accepted for any
pointer (the repo deliberately passes buffer pointers that way), and
``c_char_p`` only for ``char*``/``void*`` (it re-encodes, so a typed
pointer declared ``c_char_p`` is drift, not style). A ``const char*``
return may be declared ``c_char_p`` (the error-string exports). Local
aliases (``p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong``)
are resolved before the diff.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from ps_tpu_torch.analysis.core import (
    Finding,
    RepoIndex,
    rule,
    str_const,
    terminal_name,
    walk,
    walk_functions,
)

_INT_OK = {
    "int": {"c_int"},
    "uint32_t": {"c_uint32"},
    "uint64_t": {"c_uint64"},
    "int64_t": {"c_int64"},
    "int32_t": {"c_int32"},
    "long long": {"c_longlong", "c_int64"},
    "float": {"c_float"},
    "double": {"c_double"},
}

_PTR_OK = {
    "char": {"c_char_p", "c_void_p"},
    "void": {"c_void_p", "c_char_p"},
    "uint64_t": {"POINTER(c_uint64)", "c_void_p"},
    "uint32_t": {"POINTER(c_uint32)", "c_void_p"},
    "int64_t": {"POINTER(c_int64)", "c_void_p"},
    "int": {"POINTER(c_int)", "c_void_p"},
}

#: return-type acceptance; "" means "no restype declared" (ctypes
#: defaults to c_int, which is only correct for int)
_RET_OK = {
    "void": {"", "None"},
    "int": {"c_int", ""},
    "int32_t": {"c_int32", "c_int", ""},
    "uint32_t": {"c_uint32"},
    "uint64_t": {"c_uint64"},
    "int64_t": {"c_int64"},
}

#: words that qualify a C declaration without naming its type
_QUALIFIERS = ("const", "struct", "volatile", "restrict", "static",
               "inline", "constexpr")

#: words that build a multi-word builtin type
_TYPE_WORDS = {"unsigned", "signed", "long", "short", "int", "char",
               "float", "double", "void"}


class CExport:
    def __init__(self, name: str, signature: str, path: str, line: int,
                 ret: Tuple[str, int], params: List[Tuple[str, int]]):
        self.name = name
        self.signature = signature
        self.path = path
        self.line = line
        self.ret = ret          # (base type, pointer depth)
        self.params = params

    @property
    def library(self) -> str:
        """The shared library this definition lands in: its file stem."""
        return os.path.splitext(os.path.basename(self.path))[0]


def _c_type(tok: str) -> Optional[Tuple[str, int]]:
    """``"const char* bind_addr"`` -> ``("char", 1)``, ``"long long n"``
    -> ``("long long", 0)``; None = no type."""
    stars = tok.count("*")
    words = [w for w in tok.replace("*", " ").split()
             if w not in _QUALIFIERS]
    if not words:
        return None
    # a builtin type may take several words; the parameter name follows
    builtin = []
    for w in words:
        if w not in _TYPE_WORDS:
            break
        builtin.append(w)
    return (" ".join(builtin) if builtin else words[0]), stars


def _param_ok(ctype: Tuple[str, int]) -> Set[str]:
    base, stars = ctype
    if stars >= 2:
        return {"POINTER(c_void_p)", "c_void_p"}
    if stars == 1:
        return _PTR_OK.get(base, {"c_void_p"})
    return _INT_OK.get(base, set())  # unknown scalar: never flagged


def _ret_ok(ctype: Tuple[str, int]) -> Set[str]:
    base, stars = ctype
    if stars >= 1:
        # handles/buffers must come back full-width; a C string may be
        # read back as bytes
        return {"c_void_p", "c_char_p"} if (base, stars) == ("char", 1) \
            else {"c_void_p"}
    return _RET_OK.get(base, set())


def _exports(index: RepoIndex) -> Dict[Tuple[str, str], CExport]:
    """``(library, symbol) -> export``: one library may define a symbol
    once, two libraries may each define it."""
    out: Dict[Tuple[str, str], CExport] = {}
    for sf in index.cpp_files:
        for fn in sf.functions:
            if not fn.extern_c:
                continue
            ret = _c_type(fn.ret)
            if ret is None:
                continue
            raw = [p for p in fn.params.split(",")]
            params: List[Tuple[str, int]] = []
            ok = True
            for p in raw:
                p = p.strip()
                if not p or p == "void":
                    continue
                ct = _c_type(p)
                if ct is None:
                    ok = False
                    break
                params.append(ct)
            if ok:
                exp = CExport(fn.name, fn.signature, sf.path, fn.line, ret,
                              params)
                out.setdefault((exp.library, fn.name), exp)
    return out


def exports_by_library(index: RepoIndex) -> Dict[str, Dict[str, CExport]]:
    """``{library: {symbol: export}}`` of every ``extern "C"`` definition
    the index holds (what a built library's dynamic symbol table must
    show)."""
    out: Dict[str, Dict[str, CExport]] = {}
    for (library, sym), exp in _exports(index).items():
        out.setdefault(library, {})[sym] = exp
    return out


def _ctypes_name(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Canonical string for a ctypes type expression: ``c_void_p``,
    ``POINTER(c_uint64)``, ``None``; None-return = unrecognized. A bare
    name bound to a ctypes type in scope resolves through ``aliases``."""
    if isinstance(node, ast.Constant) and node.value is None:
        return "None"
    if isinstance(node, ast.Call):
        if terminal_name(node.func) == "POINTER" and len(node.args) == 1:
            inner = _ctypes_name(node.args[0], aliases)
            return f"POINTER({inner})" if inner else None
        return None
    if isinstance(node, ast.Name) and node.id in aliases:
        return aliases[node.id]
    return terminal_name(node)


def _aliases(scope: ast.AST, outer: Dict[str, str]) -> Dict[str, str]:
    """Names a scope binds to ctypes types: ``p = ctypes.c_void_p`` and
    ``p, i = ctypes.c_void_p, ctypes.c_int``."""
    out = dict(outer)
    if isinstance(scope, ast.Module):
        nodes = [n for top in scope.body
                 if not isinstance(top, (ast.FunctionDef,
                                         ast.AsyncFunctionDef, ast.ClassDef))
                 for n in _walk_own(top, False)]
    else:
        nodes = list(_walk_own(scope, True))
    for node in nodes:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt, val = node.targets[0], node.value
        pairs = []
        if isinstance(tgt, ast.Name):
            pairs = [(tgt, val)]
        elif isinstance(tgt, ast.Tuple) and isinstance(val, ast.Tuple) \
                and len(tgt.elts) == len(val.elts):
            pairs = list(zip(tgt.elts, val.elts))
        for t, v in pairs:
            if not isinstance(t, ast.Name):
                continue
            name = _ctypes_name(v, out)
            if name and (name.startswith("c_")
                         or name.startswith("POINTER(")):
                out[t.id] = name
    return out


def _library_of(fn: ast.AST) -> Optional[str]:
    """The library a function opens: ``load("<name>")`` in its body."""
    for node in walk(fn):
        if isinstance(node, ast.Call) and terminal_name(node.func) == "load" \
                and len(node.args) == 1 and not node.keywords:
            name = str_const(node.args[0])
            if name:
                return name
    return None


class _Binding:
    def __init__(self):
        # every argtypes assignment of the site, (line, types or None):
        # a site may bind two ABIs of one symbol (a parent's source)
        self.argtypes_all: List[Tuple[int, Optional[List[Optional[str]]]]] \
            = []
        self.restype: Optional[str] = None  # None = never declared
        self.restype_line = 0

    @property
    def argtypes(self) -> Optional[List[Optional[str]]]:
        return self.argtypes_all[-1][1] if self.argtypes_all else None

    @property
    def argtypes_line(self) -> int:
        return self.argtypes_all[0][0] if self.argtypes_all else 0


def _scan_python(index: RepoIndex, symbols: Set[str]):
    """Per (file, library, symbol) bindings + first call site per (file,
    symbol). A binding is any ``<recv>.<sym>.argtypes/.restype = ...``
    whose ``sym`` shares a prefix family with the exports (so bindings of
    other ctypes libraries never join this diff); its library is the one
    its function opens, or None."""
    prefixes = {s.split("_", 1)[0] + "_" for s in symbols if "_" in s}
    bindings: Dict[Tuple[str, Optional[str], str], _Binding] = {}
    calls: Dict[Tuple[str, str], int] = {}
    for sf in index.files:
        if "argtypes" not in sf.text and "restype" not in sf.text \
                and not any(sym in sf.text for sym in symbols):
            continue  # nothing of the ABI in this file
        module_aliases = _aliases(sf.tree, {})
        scopes = [(None, sf.tree, module_aliases)]
        for _cls, fn in walk_functions(sf.tree):
            scopes.append((_library_of(fn), fn,
                           _aliases(fn, module_aliases)))
        for library, scope, aliases in scopes:
            nodes = (scope.body if scope is sf.tree
                     else [scope])
            for top in nodes:
                if scope is sf.tree and isinstance(
                        top, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                    continue
                for node in _walk_own(top, scope is not sf.tree):
                    _scan_node(node, sf.path, library, aliases, symbols,
                               prefixes, bindings, calls)
    return bindings, calls


def _walk_own(node: ast.AST, is_function: bool):
    """Every node of a function's own body (nested defs are scopes of
    their own), or of one module-level statement."""
    stack = list(ast.iter_child_nodes(node)) if is_function else [node]
    while stack:
        cur = stack.pop()
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef, ast.Lambda)):
            continue
        yield cur
        stack.extend(ast.iter_child_nodes(cur))


def _scan_node(node, path, library, aliases, symbols, prefixes, bindings,
               calls) -> None:
    if isinstance(node, ast.Assign) and len(node.targets) == 1:
        tgt = node.targets[0]
        if not (isinstance(tgt, ast.Attribute)
                and tgt.attr in ("argtypes", "restype")
                and isinstance(tgt.value, ast.Attribute)):
            return
        sym = tgt.value.attr
        if sym not in symbols \
                and not any(sym.startswith(p) for p in prefixes):
            return
        b = bindings.setdefault((path, library, sym), _Binding())
        if tgt.attr == "argtypes":
            types = None
            if isinstance(node.value, (ast.List, ast.Tuple)):
                types = [_ctypes_name(e, aliases) for e in node.value.elts]
            b.argtypes_all.append((node.lineno, types))
        else:
            b.restype_line = node.lineno
            b.restype = _ctypes_name(node.value, aliases) or "?"
    elif isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in symbols:
            calls.setdefault((path, fn.attr), node.lineno)


@rule("PSL6", "cross-language ABI drift: extern \"C\" signatures vs "
              "ctypes argtypes/restype/call sites")
def check_abi(index: RepoIndex):
    findings: List[Finding] = []
    exports = _exports(index)
    if not exports:
        return findings
    first: Dict[str, CExport] = {}
    for (_lib, sym), exp in exports.items():
        first.setdefault(sym, exp)
    bindings, calls = _scan_python(index, set(first))

    declared_symbols = {sym for (_path, _lib, sym), b in bindings.items()
                        if b.argtypes is not None}
    for (path, library, sym), b in sorted(
            bindings.items(), key=lambda kv: (kv[0][0], kv[0][2],
                                              kv[0][1] or "")):
        if library is not None and (library, sym) not in exports \
                and any(lib == library for lib, _s in exports):
            exp = None  # this library exports other symbols, not this one
        elif library is not None and (library, sym) in exports:
            exp = exports[(library, sym)]
        else:
            exp = first.get(sym)
        line = b.argtypes_line or b.restype_line
        if exp is None:
            lib_note = f" (library {library!r})" if library else ""
            findings.append(Finding(
                "PSL604", "P1", path, line,
                f"ctypes binds {sym!r}{lib_note} but no extern \"C\" "
                f"definition exports it — renamed or dropped on the C "
                f"side (drift; this fails as AttributeError at runtime)"))
            continue
        where = f"{exp.path}:{exp.line}"
        for at_line, argtypes in b.argtypes_all:
            if argtypes is None:
                continue
            if len(argtypes) != len(exp.params):
                findings.append(Finding(
                    "PSL601", "P0", path, at_line,
                    f"argtypes arity {len(argtypes)} != {len(exp.params)}"
                    f" parameters of C `{exp.signature}` ({where}) — "
                    f"every call site corrupts the native stack"))
                continue
            for i, (decl, cparam) in enumerate(zip(argtypes, exp.params)):
                ok = _param_ok(cparam)
                if decl is not None and ok and decl not in ok:
                    base, stars = cparam
                    cstr = base + "*" * stars
                    findings.append(Finding(
                        "PSL601", "P0", path, at_line,
                        f"argtypes[{i}] is {decl} but parameter {i} "
                        f"of C `{exp.signature}` ({where}) is "
                        f"{cstr} — width/kind mismatch corrupts the "
                        f"value at the boundary"))
        ret_ok = _ret_ok(exp.ret)
        declared_ret = b.restype if b.restype is not None else ""
        if ret_ok and declared_ret not in ret_ok and declared_ret != "?":
            if declared_ret == "":
                findings.append(Finding(
                    "PSL602", "P0", path, line,
                    f"no restype declared for C `{exp.signature}` "
                    f"({where}) — ctypes defaults to c_int, silently "
                    f"TRUNCATING the 64-bit return on the way out"))
            else:
                findings.append(Finding(
                    "PSL602", "P0", path, b.restype_line,
                    f"restype {declared_ret} does not match the return "
                    f"of C `{exp.signature}` ({where})"))

    for (path, sym), line in sorted(calls.items()):
        if sym not in declared_symbols:
            exp = first[sym]
            findings.append(Finding(
                "PSL603", "P1", path, line,
                f"{sym}() is called but no linted file declares its "
                f"argtypes (C `{exp.signature}`, {exp.path}:{exp.line})"
                f" — arguments cross the ABI unchecked"))

    bound_anywhere = {sym for (_p, lib, sym) in bindings if lib is None} \
        | {sym for (_p, sym) in calls}
    bound_in = {(lib, sym) for (_p, lib, sym) in bindings if lib is not None}
    for (library, sym), exp in sorted(exports.items(),
                                      key=lambda kv: (kv[0][1], kv[0][0])):
        if sym not in bound_anywhere and (library, sym) not in bound_in:
            findings.append(Finding(
                "PSL604", "P2", exp.path, exp.line,
                f"extern \"C\" {sym} is exported but never bound or "
                f"called from Python — dead ABI surface, or the "
                f"binding site was dropped (drift)"))
    return findings
