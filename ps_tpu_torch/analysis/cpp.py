"""C++ and CUDA source model for the native rule families (PSL5xx/PSL6xx).

Deliberately clang-free: the native surface (``native/van.cpp``, the
kernels under ``ops/csrc/``) is small C-with-RAII plus CUDA, so a
comment/string-aware character scan plus brace matching is enough to
recover what the rules need — function bodies, struct members,
``extern "C"`` signatures, lock acquisition sites — without a compiler
frontend. This is NOT a parser; anything it cannot classify it skips,
and the rules are written so a skipped construct can only lose a
finding, never invent one.

CUDA is read as C++: ``__global__``/``__device__`` qualifiers stay in a
function's return text, a ``__launch_bounds__(...)``,
``__cluster_dims__(...)`` or ``__maxnreg__(...)`` between the return
type and the name does not hide a kernel's definition, a
``kernel<<<grid, block, smem, stream>>>(...)`` launch is a call like any
other, and ``asm volatile("..." : ... : ...)`` PTX blocks are string
literals, so braces inside PTX never reach the brace matcher.

Annotations ride ordinary ``//`` comments so the invariants live next to
the code they protect (README "Static analysis"):

- ``// pslint: lock-order: tmu -> wmu`` — declared acquisition
  hierarchy (file-level); an observed inversion is a PSL501 cycle.
- ``std::mutex tmu;  // pslint: hot-lock`` — a table-wide/hot mutex:
  blocking syscalls, unbounded memcpy, and allocation are PSL502 while
  it is held.
- ``// pslint: hot-path`` — the next (or enclosing) function must not
  allocate (PSL505).
- ``// pslint: transfers: body -- <where ownership goes>`` — buffers
  named ``body`` are transfer-tracked: ``free(...->body)`` is PSL504
  except in functions annotated ``// pslint: owns: body -- <why>``.
- ``// pslint: memcpy-bound: N`` — memcpy of a constant size <= N is
  exempt under hot locks (default 64: length-prefix copies stay legal).
- ``// pslint: disable=PSL50x -- reason`` — line suppression, same
  contract as Python (a bare suppression is PSL001).
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["CppSourceFile", "CppFunction", "CppStruct"]

_SUPPRESS_RE = re.compile(
    r"pslint:\s*disable=(?P<rules>[A-Z0-9,\s]+?)"
    r"(?:\s*--\s*(?P<reason>.*\S))?\s*$"
)
_ANNOT_RE = re.compile(r"pslint:\s*(?P<body>.*\S)\s*$")

#: annotation keys that take a value after the colon
_VALUED_KEYS = ("lock-order", "transfers", "owns", "memcpy-bound")
_BARE_KEYS = ("hot-lock", "hot-path")

_KEYWORDS = {
    "if", "for", "while", "switch", "return", "catch", "sizeof", "do",
    "else", "new", "delete", "case", "defined", "throw", "alignof",
    "static_assert", "decltype",
}

#: CUDA attributes that take arguments and may sit between a kernel's
#: return type and its name
_CUDA_ATTRS = ("__launch_bounds__", "__cluster_dims__", "__maxnreg__")
_CUDA_ATTR_RE = re.compile(
    r"\b(?:%s)\s*\((?:[^()]|\([^()]*\))*\)" % "|".join(_CUDA_ATTRS))


class CppAnnotation:
    """One parsed ``// pslint: <key>[: value][-- reason]`` directive."""

    def __init__(self, line: int, key: str, value: str,
                 reason: Optional[str]):
        self.line = line
        self.key = key
        self.value = value
        self.reason = reason


class CppFunction:
    """One function definition: name, signature text, body span."""

    def __init__(self, name: str, ret: str, params: str, line: int,
                 body_start: int, body_end: int, extern_c: bool):
        self.name = name
        self.ret = ret.strip()
        self.params = params.strip()
        self.line = line
        self.body_start = body_start  # offset of the opening '{'
        self.body_end = body_end      # offset one past the closing '}'
        self.extern_c = extern_c
        self.line_lo = 0  # body line span, filled by CppSourceFile
        self.line_hi = 0

    @property
    def signature(self) -> str:
        params = re.sub(r"\s+", " ", self.params)
        return f"{self.ret} {self.name}({params})"


class CppStruct:
    """One struct: span + declared mutex/condition members."""

    def __init__(self, name: str, start: int, end: int):
        self.name = name
        self.start = start
        self.end = end
        self.mutexes: Dict[str, int] = {}      # member -> decl line
        self.conditions: Set[str] = set()


class CppSourceFile:
    """One scanned C++ file: blanked code, comments, suppressions,
    annotations, functions, structs, extern "C" spans.

    ``code`` is the source with comment and string/char-literal CONTENTS
    replaced by spaces (same length and line structure as ``text``), so
    every regex below sees real code only but offsets/lines still map
    back to the file.
    """

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.code, self.comments = _strip(text)
        # line -> (set of suppressed rule ids, reason or None) — the same
        # shape SourceFile exposes, so core.run_lint's suppression pass
        # treats both languages identically
        self.suppressions: Dict[int, Tuple[Set[str], Optional[str]]] = {}
        self.annotations: List[CppAnnotation] = []
        self.bad_annotations: List[Tuple[int, str]] = []  # (line, text)
        for line, comment in self.comments:
            self._classify_comment(line, comment)
        # newline-offset table: line_of is a bisect, not an O(file) scan
        # (function_at runs per annotation x function — keep it cheap)
        self._line_starts = [0]
        pos = self.code.find("\n")
        while pos != -1:
            self._line_starts.append(pos + 1)
            pos = self.code.find("\n", pos + 1)
        self.extern_c_spans = _extern_c_spans(self.code)
        self.functions = _functions(self.code, self.extern_c_spans)
        self.structs = _structs(self.code)
        for fn in self.functions:
            fn.line_lo = self.line_of(fn.body_start)
            fn.line_hi = self.line_of(fn.body_end)

    def suppressed(self, rule_id: str, line: int) -> bool:
        entry = self.suppressions.get(line)
        return entry is not None and rule_id in entry[0]

    def line_of(self, offset: int) -> int:
        return bisect.bisect_right(self._line_starts, offset)

    def function_at(self, line: int) -> Optional[CppFunction]:
        """The function whose body contains ``line`` (innermost), or the
        function defined within 3 lines BELOW an annotation's line — so
        a ``// pslint: owns:`` comment can sit either inside the body or
        in the block right above the signature."""
        best = None
        for fn in self.functions:
            if fn.line_lo <= line <= fn.line_hi:
                if best is None or fn.body_start > best.body_start:
                    best = fn
        if best is not None:
            return best
        for fn in self.functions:
            if line < fn.line <= line + 3:
                return fn
        return None

    def annotations_for(self, fn: CppFunction, key: str
                        ) -> List[CppAnnotation]:
        return [a for a in self.annotations
                if a.key == key and self.function_at(a.line) is fn]

    def _classify_comment(self, line: int, comment: str) -> None:
        if "pslint" not in comment:
            return
        m = _SUPPRESS_RE.search(comment)
        if m:
            ids = {r.strip() for r in m.group("rules").split(",")
                   if r.strip()}
            self.suppressions[line] = (ids, m.group("reason"))
            return
        m = _ANNOT_RE.search(comment)
        if not m:
            self.bad_annotations.append((line, comment.strip()))
            return
        body = m.group("body")
        reason = None
        if "--" in body:
            body, reason = body.split("--", 1)
            reason = reason.strip() or None
            body = body.strip()
        for key in _VALUED_KEYS:
            if body.startswith(key):
                rest = body[len(key):].lstrip()
                if not rest.startswith(":") or not rest[1:].strip():
                    self.bad_annotations.append((line, comment.strip()))
                    return
                self.annotations.append(CppAnnotation(
                    line, key, rest[1:].strip(), reason))
                return
        if body in _BARE_KEYS:
            self.annotations.append(CppAnnotation(line, body, "", reason))
            return
        self.bad_annotations.append((line, comment.strip()))


def _strip(text: str) -> Tuple[str, List[Tuple[int, str]]]:
    """Blank comments and string/char contents; collect comments with
    their (start) line numbers. Line structure is preserved exactly."""
    out = list(text)
    comments: List[Tuple[int, str]] = []
    i, n, line = 0, len(text), 1
    while i < n:
        c = text[i]
        if c == "\n":
            line += 1
            i += 1
        elif c == "/" and i + 1 < n and text[i + 1] == "/":
            j = text.find("\n", i)
            j = n if j == -1 else j
            comments.append((line, text[i:j]))
            for k in range(i, j):
                out[k] = " "
            i = j
        elif c == "/" and i + 1 < n and text[i + 1] == "*":
            j = text.find("*/", i + 2)
            j = n if j == -1 else j + 2
            comments.append((line, text[i:j]))
            for k in range(i, j):
                if text[k] != "\n":
                    out[k] = " "
            line += text.count("\n", i, j)
            i = j
        elif c in "\"'":
            q = c
            j = i + 1
            while j < n and text[j] != q:
                j += 2 if text[j] == "\\" else 1
            for k in range(i + 1, min(j, n)):
                if text[k] != "\n":
                    out[k] = " "
            line += text.count("\n", i, min(j, n))
            i = min(j, n) + 1
        else:
            i += 1
    return "".join(out), comments


def _match_brace(code: str, open_pos: int) -> int:
    """Offset one past the brace matching ``code[open_pos] == '{'``;
    len(code) when unbalanced (truncated file)."""
    depth = 0
    for j in range(open_pos, len(code)):
        if code[j] == "{":
            depth += 1
        elif code[j] == "}":
            depth -= 1
            if depth == 0:
                return j + 1
    return len(code)


def _extern_c_spans(code: str) -> List[Tuple[int, int]]:
    spans = []
    for m in re.finditer(r'extern\s*"[^"]*"\s*\{', code):
        spans.append((m.end() - 1, _match_brace(code, m.end() - 1)))
    return spans


def _namespace_spans(code: str) -> List[Tuple[int, int]]:
    """Namespace blocks: a function inside one has internal (anonymous)
    or namespaced linkage even when the namespace sits lexically inside
    ``extern "C" { ... }`` — it is NOT part of the exported ABI."""
    spans = []
    for m in re.finditer(r"\bnamespace\s*(?:[A-Za-z_]\w*\s*)?\{", code):
        spans.append((m.end() - 1, _match_brace(code, m.end() - 1)))
    return spans


def _functions(code: str, extern_spans) -> List[CppFunction]:
    ns_spans = _namespace_spans(code)
    out: List[CppFunction] = []
    for m in re.finditer(r"([A-Za-z_]\w*)\s*\(", code):
        name = m.group(1)
        if name in _KEYWORDS or name in _CUDA_ATTRS:
            continue
        # match the parameter parens (lambda bodies inside count only
        # their parens, braces are plain chars here)
        i = m.end() - 1
        depth, j = 0, i
        while j < len(code):
            if code[j] == "(":
                depth += 1
            elif code[j] == ")":
                depth -= 1
                if depth == 0:
                    break
            j += 1
        if j >= len(code):
            continue
        k = j + 1
        while k < len(code) and code[k] in " \t\r\n":
            k += 1
        if k >= len(code) or code[k] != "{":
            continue  # a call or a prototype, not a definition
        # a definition has a return type (or qualifier) token right
        # before the name; calls sit after '=', '.', '(', ',', ...
        p = m.start() - 1
        while p >= 0 and code[p] in " \t\r\n":
            p -= 1
        p = _skip_cuda_attrs(code, p)
        if p < 0 or not (code[p].isalnum() or code[p] in "_*&>"):
            continue
        # reject control keywords that slipped through via qualified
        # names, and member-access calls (`x.fn(...) {` cannot occur)
        head_start = max(code.rfind(";", 0, m.start()),
                         code.rfind("}", 0, m.start()),
                         code.rfind("{", 0, m.start()))
        raw_ret = code[head_start + 1:m.start()]
        # single-declaration linkage form: `extern "C" int f(...) {` —
        # exported exactly like the block form (and a linkage spec
        # overrides an enclosing namespace for the symbol name)
        single_extern = re.search(r'extern\s*"[^"]*"', raw_ret) is not None
        ret = re.sub(r'extern\s*"[^"]*"\s*', " ", raw_ret)
        ret = _CUDA_ATTR_RE.sub(" ", ret)
        # the type is the head's last non-blank line: anything earlier
        # is a preceding preprocessor directive or comment residue
        ret_lines = [ln.strip() for ln in ret.split("\n") if ln.strip()]
        ret = ret_lines[-1] if ret_lines else ""
        if not ret or ret.split()[-1] in _KEYWORDS:
            continue
        body_end = _match_brace(code, k)
        line = code.count("\n", 0, m.start()) + 1
        extern_c = single_extern or (
            any(lo < m.start() < hi for lo, hi in extern_spans)
            and not any(lo < m.start() < hi for lo, hi in ns_spans))
        out.append(CppFunction(name, ret, code[i + 1:j], line, k,
                               body_end, extern_c))
    return out


def _skip_cuda_attrs(code: str, p: int) -> int:
    """Offset of the last code character before any CUDA attributes
    that end at ``code[p]`` (``__launch_bounds__(256, 1) kern(``)."""
    while p >= 0 and code[p] == ")":
        depth, q = 0, p
        while q >= 0:
            if code[q] == ")":
                depth += 1
            elif code[q] == "(":
                depth -= 1
                if depth == 0:
                    break
            q -= 1
        r = q - 1
        while r >= 0 and code[r] in " \t\r\n":
            r -= 1
        e = r + 1
        while r >= 0 and (code[r].isalnum() or code[r] == "_"):
            r -= 1
        if q < 0 or code[r + 1:e] not in _CUDA_ATTRS:
            return p
        p = r
        while p >= 0 and code[p] in " \t\r\n":
            p -= 1
    return p


def _structs(code: str) -> List[CppStruct]:
    out: List[CppStruct] = []
    for m in re.finditer(r"\bstruct\s+([A-Za-z_]\w*)\s*\{", code):
        start = m.end() - 1
        end = _match_brace(code, start)
        st = CppStruct(m.group(1), start, end)
        body = code[start:end]
        for mm in re.finditer(
                r"(?:std::)?(mutex|condition_variable(?:_any)?)"
                r"\s+([A-Za-z_]\w*)\s*[;{]", body):
            line = code.count("\n", 0, start + mm.start()) + 1
            if mm.group(1) == "mutex":
                st.mutexes[mm.group(2)] = line
            else:
                st.conditions.add(mm.group(2))
        out.append(st)
    return out
