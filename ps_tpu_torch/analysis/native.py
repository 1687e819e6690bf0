"""PSL5xx — native concurrency & ownership (C++ and CUDA, clang-free).

The data plane's riskiest layer is the native van (``native/van.cpp``,
the reference's, byte for byte): hand-rolled epoll, a table mutex
serializing accept/destroy against repliers, malloc'd frame bodies whose
ownership crosses the ctypes boundary, and a toolchain whose TSan build
cannot see ``condition_variable::wait_for``. This family makes those
invariants lints, on the same
:class:`~ps_tpu_torch.analysis.core.RepoIndex`/finding/suppression
machinery as the Python families (C++ and CUDA sources are modeled by
:mod:`ps_tpu_torch.analysis.cpp` — a tokenizer, not a compiler). The
kernels under ``ops/csrc/`` are read too: they hold no host mutex, so
they give no finding unless one ever takes a lock or allocates under an
annotation.

- **PSL501 — consistent native lock order.** ``lock_guard``/
  ``unique_lock`` sites build a per-file lock graph (identities are
  struct-qualified where member names collide); ``// pslint:
  lock-order: tmu -> wmu`` contributes the DECLARED hierarchy as edges,
  so an observed inversion against it — or any longer cycle, found by
  the same DFS as PSL102 — is a deadlock finding. ``guard.unlock()``
  ends a hold (the pin-then-write pattern in ``nl_reply_vec`` must not
  read as a wmu -> tmu edge).
- **PSL502 — no blocking work under a hot mutex.** While a mutex whose
  declaration carries ``// pslint: hot-lock`` is held: blocking
  syscalls (send/recv/write/poll/join/sleep...), allocation
  (malloc/new), calls to same-file functions that transitively block,
  and ``memcpy``/``memmove``/``memset`` above the file's
  ``memcpy-bound`` (default 64 bytes — length-prefix copies stay legal)
  are findings. A condition wait whose first argument is the guard of
  the held lock is exempt (that wait RELEASES the lock).
- **PSL503 — ``wait_for`` is forbidden; ``wait_until(system_clock)``
  only.** GCC-10 libstdc++ lowers ``condition_variable::wait_for`` (and
  steady_clock ``wait_until``) to ``pthread_cond_clockwait``, which
  this toolchain's TSan does not intercept — the wait's internal
  unlock/relock goes invisible and every later use of that mutex
  reports phantom races. Only ``wait_until(system_clock::now()+d)``
  lowers to the intercepted ``pthread_cond_timedwait``.
- **PSL504 — free obeys the ownership annotations.** A name enrolled by
  ``// pslint: transfers: body -- <where>`` is transfer-tracked:
  ``free()`` of it is legal only in functions annotated ``// pslint:
  owns: body -- <why this free cannot see a transferred buffer>``. A body
  claimed by ``nl_poll`` and freed by ``nl_stop`` (a use after free)
  thus needs a reviewable claim to pass the gate.
- **PSL505 — no allocation in ``// pslint: hot-path`` functions** (the
  GIL-free shm-ring primitives a Python spinner rides).
- **PSL500 — malformed annotation** (P2): a typo'd ``// pslint:``
  directive must fail loudly, never silently stop guarding.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Set, Tuple

from ps_tpu_torch.analysis.core import Finding, RepoIndex, rule
from ps_tpu_torch.analysis.cpp import CppFunction, CppSourceFile
from ps_tpu_torch.analysis.locks import _lock_order_cycles

#: call terminal names that block the calling native thread
BLOCKING_CALLS = {
    "send", "sendto", "sendmsg", "recv", "recvfrom", "recvmsg",
    "write", "read", "connect", "accept", "poll", "epoll_wait",
    "select", "usleep", "nanosleep", "sleep", "sleep_for",
    "sleep_until", "join", "fsync", "flock",
}

_ALLOC_CALLS = {"malloc", "calloc", "realloc"}
_COPY_CALLS = {"memcpy", "memmove", "memset"}
_WAIT_CALLS = {"wait", "wait_for", "wait_until"}

_DEFAULT_MEMCPY_BOUND = 64

_LOCK_RE = re.compile(
    r"(?:std::)?(?:lock_guard|unique_lock|scoped_lock)\s*<[^>]*>\s+"
    r"(\w+)\s*\(\s*([^();]*)\)")
_DEFERRED_TAGS = ("defer_lock", "try_to_lock")
_CALL_RE = re.compile(r"([A-Za-z_]\w*)\s*\(")
_UNLOCK_RE = re.compile(r"(\w+)\s*\.\s*(unlock|lock)\s*\(\s*\)")
_FREE_RE = re.compile(r"\bfree\s*\(([^()]*)\)")
_NEW_RE = re.compile(r"\bnew\b")
_SIZE_CONST_RE = re.compile(r"(?:0x[0-9a-fA-F]+|\d+|sizeof\s*\([^)]*\))")


def _match_paren(code: str, open_pos: int) -> int:
    depth = 0
    for j in range(open_pos, len(code)):
        if code[j] == "(":
            depth += 1
        elif code[j] == ")":
            depth -= 1
            if depth == 0:
                return j
    return len(code)


class _FileModel:
    """Per-file lock identities, annotations, and function summaries."""

    def __init__(self, sf: CppSourceFile):
        self.sf = sf
        # member -> structs declaring a mutex of that name
        owners: Dict[str, List[str]] = {}
        self.hot_members: Set[str] = set()
        self.mutex_lines: Set[int] = set()
        for st in sf.structs:
            for member, line in st.mutexes.items():
                owners.setdefault(member, []).append(st.name)
                self.mutex_lines.add(line)
                # the annotation may share the decl's line or sit on
                # the line above it (the natural standalone style)
                if any(a.key == "hot-lock" and a.line in (line, line - 1)
                       for a in sf.annotations):
                    self.hot_members.add(member)
        self.owners = owners
        self.memcpy_bound = _DEFAULT_MEMCPY_BOUND
        self.declared_order: List[Tuple[int, List[str]]] = []
        self.tracked: Dict[str, int] = {}  # transfer-tracked name -> line
        for a in sf.annotations:
            if a.key == "memcpy-bound":
                try:
                    self.memcpy_bound = int(a.value, 0)
                except ValueError:
                    sf.bad_annotations.append(
                        (a.line, f"memcpy-bound: {a.value}"))
            elif a.key == "lock-order":
                chain = [t.strip() for t in a.value.split("->")]
                if len(chain) >= 2 and all(chain):
                    self.declared_order.append((a.line, chain))
                else:
                    sf.bad_annotations.append(
                        (a.line, f"lock-order: {a.value}"))
            elif a.key == "transfers":
                self.tracked.setdefault(a.value, a.line)
        self.fn_by_name: Dict[str, CppFunction] = {}
        for fn in sf.functions:
            self.fn_by_name.setdefault(fn.name, fn)

    def identity(self, expr: str, fn: CppFunction) -> str:
        """Stable lock identity: bare member name when unique across the
        file's structs, struct- or receiver-qualified when ambiguous."""
        parts = [p.strip() for p in re.split(r"->|\.", expr.strip())]
        member = parts[-1]
        recv = ".".join(parts[:-1])
        structs = self.owners.get(member, [])
        if len(structs) <= 1:
            return member
        if recv:
            return f"{recv}.{member}"
        for st in self.sf.structs:  # bare name in a member function
            if st.start <= fn.body_start <= st.end \
                    and member in st.mutexes:
                return f"{st.name}.{member}"
        return member

    @staticmethod
    def member_of(identity: str) -> str:
        return identity.rsplit(".", 1)[-1]


class _Summary:
    def __init__(self):
        self.blocks: Optional[str] = None
        self.acquires: Set[str] = set()


def _first_arg(code: str, open_pos: int, close_pos: int) -> str:
    depth = 0
    for j in range(open_pos + 1, close_pos):
        if code[j] == "(":
            depth += 1
        elif code[j] == ")":
            depth -= 1
        elif code[j] == "," and depth == 0:
            return code[open_pos + 1:j].strip()
    return code[open_pos + 1:close_pos].strip()


def _last_arg(code: str, open_pos: int, close_pos: int) -> str:
    depth, last = 0, open_pos + 1
    for j in range(open_pos + 1, close_pos):
        if code[j] == "(":
            depth += 1
        elif code[j] == ")":
            depth -= 1
        elif code[j] == "," and depth == 0:
            last = j + 1
    return code[last:close_pos].strip()


def _scan_function(model: _FileModel, fn: CppFunction,
                   summaries: Dict[int, _Summary],
                   findings: List[Finding],
                   pairs: Dict[Tuple[str, str], Tuple[str, int]]) -> None:
    sf = model.sf
    code = sf.code
    body = code[fn.body_start:fn.body_end]
    base = fn.body_start

    events: List[Tuple[int, str, tuple]] = []
    for i, ch in enumerate(body):
        if ch == "{":
            events.append((i, "open", ()))
        elif ch == "}":
            events.append((i, "close", ()))
    for m in _LOCK_RE.finditer(body):
        args = m.group(2)
        expr = args.split(",")[0].strip()
        if not expr:
            continue
        deferred = any(tag in args for tag in _DEFERRED_TAGS)
        events.append((m.start(), "acquire", (m.group(1), expr,
                                              deferred)))
    for m in _UNLOCK_RE.finditer(body):
        events.append((m.start(), m.group(2), (m.group(1),)))
    for m in _CALL_RE.finditer(body):
        events.append((m.start(), "call", (m.group(1), m.end() - 1)))
    for m in _NEW_RE.finditer(body):
        events.append((m.start(), "new", ()))
    events.sort(key=lambda e: (e[0], e[1] != "open"))

    depth = 0
    # active locks: (identity, guard var, depth at construction, held)
    active: List[list] = []
    owns = {a.value for a in sf.annotations_for(fn, "owns")}
    hot_path = bool(sf.annotations_for(fn, "hot-path"))

    def held() -> List[str]:
        return [a[0] for a in active if a[3]]

    def hot_held() -> List[str]:
        return [ident for ident in held()
                if _FileModel.member_of(ident) in model.hot_members]

    for pos, kind, data in events:
        line = sf.line_of(base + pos)
        if kind == "open":
            depth += 1
        elif kind == "close":
            active[:] = [a for a in active if a[2] < depth]
            depth -= 1
        elif kind == "acquire":
            var, expr, deferred = data
            ident = model.identity(expr, fn)
            if not deferred:
                for outer in held():
                    if outer != ident:
                        pairs.setdefault((outer, ident), (sf.path, line))
            # a defer_lock/try_to_lock guard joins the scope UNHELD —
            # it holds nothing until its .lock() — so the scanner
            # cannot invent blocking-under-lock findings for it
            active.append([ident, var, depth, not deferred])
            summaries[id(fn)].acquires.add(ident)
        elif kind == "unlock":
            for a in active:
                if a[1] == data[0]:
                    a[3] = False
        elif kind == "lock":
            for a in active:
                if a[1] == data[0]:
                    for outer in held():
                        if outer != a[0]:
                            pairs.setdefault((outer, a[0]),
                                             (sf.path, line))
                    a[3] = True
        elif kind == "new":
            if hot_held():
                findings.append(Finding(
                    "PSL502", "P1", sf.path, line,
                    f"operator new while hot mutex "
                    f"[{', '.join(hot_held())}] is held — the allocator "
                    f"may take arbitrary time (and locks) of its own"))
            elif hot_path:
                findings.append(Finding(
                    "PSL505", "P2", sf.path, line,
                    f"operator new in '// pslint: hot-path' function "
                    f"{fn.name}() — hot-path primitives must not "
                    f"allocate"))
        elif kind == "call":
            name, open_pos = data
            close_pos = _match_paren(body, open_pos)
            prev = body[pos - 1] if pos else " "
            _check_call(model, fn, name, body, pos, open_pos, close_pos,
                        prev, line, active, held(), hot_held(), owns,
                        hot_path, summaries, findings, pairs)

    for m in _FREE_RE.finditer(body):
        arg = m.group(1)
        member = re.split(r"->|\.", arg.strip())[-1].strip()
        if member in model.tracked and member not in owns:
            line = sf.line_of(base + m.start())
            findings.append(Finding(
                "PSL504", "P1", sf.path, line,
                f"free({arg.strip()}) of transfer-tracked buffer "
                f"{member!r} (// pslint: transfers: at line "
                f"{model.tracked[member]}) in a function with no "
                f"'// pslint: owns: {member} -- <why>' annotation — "
                f"a transferred body freed here is the use-after-free "
                f"window the ownership contract exists to close"))


def _check_call(model, fn, name, body, pos, open_pos, close_pos, prev,
                line, active, held_ids, hot_ids, owns, hot_path,
                summaries, findings, pairs) -> None:
    sf = model.sf
    if name in _WAIT_CALLS and prev == ".":
        first = _first_arg(body, open_pos, close_pos)
        releases = any(a[1] == first and a[3] for a in active)
        if name == "wait_for":
            findings.append(Finding(
                "PSL503", "P1", sf.path, line,
                "condition_variable wait_for is forbidden: this "
                "toolchain's GCC-10 libstdc++ lowers it to "
                "pthread_cond_clockwait, which TSan does not intercept "
                "— every later use of the mutex reports phantom races; "
                "use wait_until(std::chrono::system_clock::now() + d)"))
        elif name == "wait_until" \
                and "steady_clock" in body[open_pos:close_pos]:
            findings.append(Finding(
                "PSL503", "P1", sf.path, line,
                "wait_until on a steady_clock deadline lowers to the "
                "same uninstrumented pthread_cond_clockwait as "
                "wait_for; use a system_clock deadline "
                "(wait_until(std::chrono::system_clock::now() + d))"))
        if releases or not hot_ids:
            return
        findings.append(Finding(
            "PSL502", "P1", sf.path, line,
            f"{name}() does not release the held hot mutex "
            f"[{', '.join(hot_ids)}] — its guard is not this wait's "
            f"lock argument, so every contender stalls for the wait"))
        return
    if not hot_ids:
        if hot_path and name in _ALLOC_CALLS:
            findings.append(Finding(
                "PSL505", "P2", sf.path, line,
                f"{name}() in '// pslint: hot-path' function "
                f"{fn.name}() — hot-path primitives must not allocate"))
        _propagate_pairs(model, name, held_ids, sf, line, summaries,
                         pairs)
        return
    lockset = ", ".join(hot_ids)
    if name in BLOCKING_CALLS:
        findings.append(Finding(
            "PSL502", "P1", sf.path, line,
            f"blocking call {name}() while hot mutex [{lockset}] is "
            f"held — every accept/destroy/replier contending that "
            f"mutex stalls behind this syscall"))
        return
    if name in _ALLOC_CALLS:
        findings.append(Finding(
            "PSL502", "P1", sf.path, line,
            f"{name}() while hot mutex [{lockset}] is held — the "
            f"allocator may take arbitrary time (and locks) of its own"))
        return
    if name in _COPY_CALLS:
        size = _last_arg(body, open_pos, close_pos)
        bounded = False
        if _SIZE_CONST_RE.fullmatch(size):
            if size.startswith("sizeof"):
                bounded = True
            else:
                try:
                    bounded = int(size, 0) <= model.memcpy_bound
                except ValueError:
                    bounded = False
        if not bounded:
            findings.append(Finding(
                "PSL502", "P1", sf.path, line,
                f"{name}({size or '...'}) of unbounded/over-bound size "
                f"while hot mutex [{lockset}] is held (bound "
                f"{model.memcpy_bound} bytes; see memcpy-bound) — a "
                f"multi-MB copy serializes the whole table, the exact "
                f"nl_reply_vec bug class"))
        return
    callee = model.fn_by_name.get(name)
    if callee is not None:
        cs = summaries.get(id(callee))
        if cs is not None and cs.blocks:
            findings.append(Finding(
                "PSL502", "P1", sf.path, line,
                f"{name}() may block (via {cs.blocks}) while hot mutex "
                f"[{lockset}] is held"))
            return
    _propagate_pairs(model, name, held_ids, sf, line, summaries, pairs)


def _propagate_pairs(model, name, held_ids, sf, line, summaries,
                     pairs) -> None:
    callee = model.fn_by_name.get(name)
    if callee is None or not held_ids:
        return
    cs = summaries.get(id(callee))
    if cs is None:
        return
    for inner in cs.acquires:
        for outer in held_ids:
            if outer != inner:
                pairs.setdefault((outer, inner), (sf.path, line))


def _seed_summaries(model: _FileModel,
                    summaries: Dict[int, _Summary]) -> None:
    for fn in model.sf.functions:
        s = summaries.setdefault(id(fn), _Summary())
        body = model.sf.code[fn.body_start:fn.body_end]
        for m in _CALL_RE.finditer(body):
            name = m.group(1)
            prev = body[m.start() - 1] if m.start() else " "
            if name in _WAIT_CALLS and prev == ".":
                continue  # condition semantics, handled at the site
            if name in BLOCKING_CALLS and s.blocks is None:
                s.blocks = f"{name}()"
        for m in _LOCK_RE.finditer(body):
            expr = m.group(2).split(",")[0].strip()
            if expr:
                s.acquires.add(model.identity(expr, fn))


def _fixed_point(model: _FileModel,
                 summaries: Dict[int, _Summary]) -> None:
    changed = True
    while changed:
        changed = False
        for fn in model.sf.functions:
            s = summaries[id(fn)]
            body = model.sf.code[fn.body_start:fn.body_end]
            for m in _CALL_RE.finditer(body):
                callee = model.fn_by_name.get(m.group(1))
                if callee is None or callee is fn:
                    continue
                cs = summaries.get(id(callee))
                if cs is None:
                    continue
                if cs.blocks and s.blocks is None:
                    s.blocks = f"{m.group(1)}() -> {cs.blocks}"
                    changed = True
                new = cs.acquires - s.acquires
                if new:
                    s.acquires |= new
                    changed = True


@rule("PSL5", "native (C++) concurrency & ownership: lock order, "
              "hot-lock blocking, wait_for ban, free-after-transfer")
def check_native(index: RepoIndex):
    findings: List[Finding] = []
    for sf in index.cpp_files:
        model = _FileModel(sf)
        for line, text in sf.bad_annotations:
            findings.append(Finding(
                "PSL500", "P2", sf.path, line,
                f"malformed pslint annotation {text!r} — a typo'd "
                f"directive silently guards nothing; see README "
                f"'Static analysis' for the C++ annotation syntax"))
        for a in sf.annotations:
            if a.key in ("owns", "transfers") and not a.reason:
                findings.append(Finding(
                    "PSL500", "P2", sf.path, a.line,
                    f"'{a.key}: {a.value}' annotation carries no "
                    f"'-- <reason>' — ownership claims must state why "
                    f"they hold, same contract as suppressions"))
            elif a.key == "hot-lock" and not any(
                    a.line in (ln, ln - 1) for ln in model.mutex_lines):
                findings.append(Finding(
                    "PSL500", "P2", sf.path, a.line,
                    "'hot-lock' attaches to no mutex declaration (put "
                    "it on the std::mutex line or the line directly "
                    "above) — a dangling annotation guards nothing and "
                    "silently disarms PSL502"))
        summaries: Dict[int, _Summary] = {}
        _seed_summaries(model, summaries)
        _fixed_point(model, summaries)
        pairs: Dict[Tuple[str, str], Tuple[str, int]] = {}
        for line, chain in model.declared_order:
            for a, b in zip(chain, chain[1:]):
                pairs.setdefault((a, b), (sf.path, line))
        for fn in sf.functions:
            _scan_function(model, fn, summaries, findings, pairs)
        findings.extend(_lock_order_cycles(pairs, rule_id="PSL501"))
    return findings
