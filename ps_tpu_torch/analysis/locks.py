"""PSL1xx — concurrency: blocking work under hot locks, lock ordering.

The data plane holds ~20 locks (engine/apply, bucket staging, channel
lists, history logs, metrics, flight ring, ...). Two invariants keep it
live:

- **PSL101 — no blocking call under a hot lock.** A socket send/recv, a
  ``Channel.request`` round trip, ``time.sleep``, a thread join, a
  replication ``publish`` against a full ack window, or a native
  ``tv_wait_u64`` wait inside a ``with <lock>:`` body stalls every other
  thread that needs that lock — on the apply lock that is the whole
  shard. The rule builds a per-function lock→call map, resolves
  ``self.method()`` / ``self.attr.method()`` / ``ClassName()`` calls
  through a repo-wide class index, and propagates "may block" summaries
  to a fixed point, so a dial buried two calls deep under the apply lock
  is still flagged at the call site that holds the lock.
  Engine applies (``push_tree``/``pull_tree``/``save``/...) are exempt
  under the engine/apply lock itself — that IS the apply lock's job —
  and flagged under any other lock. Condition ``wait()`` is exempt when
  the condition releases the held lock (the condition is the ``with``
  context, or was constructed over the held lock), because that wait is
  how the lock is *given up*, not held.
- **PSL102 — consistent lock order.** Nested acquisitions (lexical and
  through resolved calls) build a directed lock graph keyed by
  ``(owning class, attribute)``; any cycle means two code paths can
  deadlock by acquiring the same pair in opposite orders.
- **PSL103 — logging I/O under a hot lock** (P2): a ``logging`` call
  under a lock serializes every contender behind stderr/file I/O.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from ps_tpu_torch.analysis.core import (
    Finding,
    RepoIndex,
    attr_chain,
    rule,
    terminal_name,
    walk,
    walk_functions,
)

#: call terminal names that block the calling thread (network, sleeps,
#: joins, future/ack waits, native cursor waits). ``wait`` is handled
#: separately (condition-variable semantics).
BLOCKING_CALLS = {
    "sleep", "recv", "recv_into", "send", "sendall", "send_parts",
    "request", "request_parts", "accept", "connect",
    "wait_acked", "tv_wait_u64", "wait_head", "wait_tail",
    "urlopen", "gethostbyname", "getaddrinfo", "publish", "result",
}


def _is_thread_join(call: ast.Call) -> bool:
    """``t.join()`` / ``t.join(5)`` / ``t.join(timeout=...)`` — and NOT
    ``os.path.join(a, b)`` or ``sep.join(iterable)``: thread joins take
    no argument or a numeric timeout, string/path joins take iterables
    or several path parts."""
    if terminal_name(call.func) != "join":
        return False
    chain = attr_chain(call.func)
    if chain and chain[0] == "os":
        return False
    if any(kw.arg == "timeout" for kw in call.keywords):
        return True
    if len(call.args) == 0 and not call.keywords:
        return True
    if len(call.args) == 1 and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, (int, float)):
        return True
    return False

#: engine-apply entry points: legitimate under the engine/apply lock
#: (that lock exists to serialize them), a finding under any other lock
ENGINE_APPLY_CALLS = {
    "push_tree", "pull_tree", "push_rows", "pull_rows", "save", "restore",
}

#: lock terminal names under which an engine apply is legitimate
_APPLY_LOCK_NAMES = {"_lock", "_service_lock", "_pause_cond"}

_LOGGING_METHODS = {"debug", "info", "warning", "error", "exception",
                    "critical", "log"}

_LOCK_SUFFIX = re.compile(r".*(_lock|_cond|_mutex)$|^(lock|cond|mutex)$")

_LOCK_FACTORIES = {"Lock", "RLock", "Condition"}


class _ClassInfo:
    def __init__(self, name: str, module: str, bases: List[str]):
        self.name = name
        self.module = module
        self.bases = bases
        self.methods: Dict[str, ast.FunctionDef] = {}
        self.lock_attrs: Set[str] = set()
        # condition attr -> terminal name of the lock it wraps (None =
        # owns a private lock; waiting on it releases only itself)
        self.cond_assoc: Dict[str, Optional[str]] = {}
        self.attr_class: Dict[str, str] = {}  # self.x = ClassName(...)


def _build_class_index(index: RepoIndex) -> Dict[str, _ClassInfo]:
    classes: Dict[str, _ClassInfo] = {}
    for sf in index.all_files:
        for node in walk(sf.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            bases = [b for b in (terminal_name(x) for x in node.bases) if b]
            ci = classes.setdefault(node.name,
                                    _ClassInfo(node.name, sf.path, bases))
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    ci.methods.setdefault(item.name, item)
            for sub in walk(node):
                if not isinstance(sub, ast.Assign) or len(sub.targets) != 1:
                    continue
                chain = attr_chain(sub.targets[0])
                if not chain or len(chain) != 2 or chain[0] != "self":
                    continue
                attr = chain[1]
                if isinstance(sub.value, ast.Call):
                    fn = terminal_name(sub.value.func)
                    if fn in _LOCK_FACTORIES:
                        ci.lock_attrs.add(attr)
                        if fn == "Condition":
                            arg = (terminal_name(sub.value.args[0])
                                   if sub.value.args else None)
                            ci.cond_assoc[attr] = arg
                    elif fn and fn[0].isupper():
                        ci.attr_class[attr] = fn
    return classes


def _mro(classes: Dict[str, _ClassInfo], name: str,
         _seen: Optional[Set[str]] = None) -> List[_ClassInfo]:
    seen = _seen if _seen is not None else set()
    if name in seen or name not in classes:
        return []
    seen.add(name)
    ci = classes[name]
    out = [ci]
    for b in ci.bases:
        out.extend(_mro(classes, b, seen))
    return out


def _resolve_method(classes: Dict[str, _ClassInfo], cls: Optional[str],
                    meth: str) -> Optional[Tuple[_ClassInfo, ast.AST]]:
    if cls is None:
        return None
    for ci in _mro(classes, cls):
        if meth in ci.methods:
            return ci, ci.methods[meth]
    return None


def _is_lockish(expr: ast.AST) -> Optional[str]:
    """Terminal lock name when ``expr`` (a with-item context) acquires a
    lock: a known-suffix attribute chain, or a ``*_lock()`` call."""
    if isinstance(expr, ast.Call):
        t = terminal_name(expr.func)
        if t and _LOCK_SUFFIX.match(t):
            return t
        return None
    t = terminal_name(expr)
    if t and _LOCK_SUFFIX.match(t):
        return t
    return None


def _lock_identity(expr: ast.AST, cls: Optional[str],
                   classes: Dict[str, _ClassInfo]) -> str:
    """A stable identity for the acquired lock, disambiguating the many
    ``_lock`` attributes by owning class where the owner is resolvable."""
    if isinstance(expr, ast.Call):
        return f"call:{terminal_name(expr.func)}"
    chain = attr_chain(expr)
    if not chain:
        return f"?:{terminal_name(expr)}"
    if chain[0] == "self" and len(chain) == 2:
        for ci in _mro(classes, cls or ""):
            if chain[1] in ci.lock_attrs:
                return f"{ci.name}.{chain[1]}"
        return f"{cls}.{chain[1]}"
    if chain[0] == "self" and len(chain) >= 3:
        owner = None
        for ci in _mro(classes, cls or ""):
            owner = owner or ci.attr_class.get(chain[1])
        return f"{owner or '<' + chain[1] + '>'}.{chain[-1]}"
    return ".".join(chain)


def _is_logging_call(call: ast.Call) -> bool:
    if not isinstance(call.func, ast.Attribute):
        return False
    if call.func.attr not in _LOGGING_METHODS:
        return False
    for sub in walk(call.func.value):
        if isinstance(sub, ast.Name) and sub.id in ("logging", "log",
                                                    "logger", "LOG"):
            return True
        if isinstance(sub, ast.Attribute) and sub.attr == "getLogger":
            return True
        if isinstance(sub, ast.Call) \
                and terminal_name(sub.func) == "getLogger":
            return True
    return False


class _Summary:
    """Fixed-point facts per function: does it block, which locks does it
    acquire (transitively), and through which direct call it blocks."""

    def __init__(self):
        self.blocks: Optional[str] = None  # human reason, None = no
        self.acquires: Set[str] = set()


def _direct_block_reason(call: ast.Call) -> Optional[str]:
    t = terminal_name(call.func)
    if t in BLOCKING_CALLS:
        return f"{t}()"
    if _is_thread_join(call):
        return "join()"
    return None


def _callee(call: ast.Call, cls: Optional[str],
            classes: Dict[str, _ClassInfo],
            module_funcs: Dict[str, ast.AST],
            ) -> Optional[Tuple[Optional[str], str, ast.AST]]:
    """Resolve a call to ``(class name, func name, funcdef)`` within the
    repo: ``self.m()``, ``self.attr.m()`` (attr class inferred from
    ``self.attr = ClassName(...)``), ``ClassName()`` (its __init__), or a
    bare module-level function."""
    func = call.func
    if isinstance(func, ast.Name):
        if func.id in classes:
            hit = _resolve_method(classes, func.id, "__init__")
            if hit:
                return hit[0].name, "__init__", hit[1]
            return None
        if func.id in module_funcs:
            return None, func.id, module_funcs[func.id]
        return None
    chain = attr_chain(func)
    if not chain or chain[0] != "self":
        return None
    if len(chain) == 2:
        hit = _resolve_method(classes, cls, chain[1])
        if hit:
            return hit[0].name, chain[1], hit[1]
        return None
    if len(chain) == 3:
        owner = None
        for ci in _mro(classes, cls or ""):
            owner = owner or ci.attr_class.get(chain[1])
        if owner:
            hit = _resolve_method(classes, owner, chain[2])
            if hit:
                return hit[0].name, chain[2], hit[1]
    return None


def _module_functions(tree: ast.AST) -> Dict[str, ast.AST]:
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _compute_summaries(index: RepoIndex, classes: Dict[str, _ClassInfo]
                       ) -> Dict[int, _Summary]:
    """Fixed point over the resolved call graph. Keyed by id(funcdef)."""
    funcs = []  # (source file, class name, funcdef, module functions)
    for sf in index.all_files:
        mfuncs = _module_functions(sf.tree)
        for cls, fn in walk_functions(sf.tree):
            funcs.append((sf, cls, fn, mfuncs))
    summaries: Dict[int, _Summary] = {id(fn): _Summary()
                                      for _, _, fn, _ in funcs}
    # seed: direct blocking calls + direct lock acquisitions
    for sf, cls, fn, mfuncs in funcs:
        s = summaries[id(fn)]
        for node in walk(fn):
            if isinstance(node, ast.Call):
                reason = _direct_block_reason(node)
                if reason and s.blocks is None:
                    s.blocks = reason
            elif isinstance(node, ast.With):
                for item in node.items:
                    if _is_lockish(item.context_expr):
                        s.acquires.add(_lock_identity(
                            item.context_expr, cls, classes))
    # the resolved calls of each function, in walk order (resolution
    # does not change while the facts propagate)
    edges = []
    for sf, cls, fn, mfuncs in funcs:
        out = []
        for node in walk(fn):
            if not isinstance(node, ast.Call):
                continue
            hit = _callee(node, cls, classes, mfuncs)
            if hit is None:
                continue
            cs = summaries.get(id(hit[2]))
            if cs is not None:
                out.append((hit[1], cs))
        edges.append((summaries[id(fn)], out))
    # propagate to a fixed point through resolved calls
    changed = True
    while changed:
        changed = False
        for s, out in edges:
            for name, cs in out:
                if cs.blocks and s.blocks is None:
                    s.blocks = f"{name}() -> {cs.blocks}"
                    changed = True
                new = cs.acquires - s.acquires
                if new:
                    s.acquires |= new
                    changed = True
    return summaries


def _cond_wait_exempt(call: ast.Call, cls: Optional[str],
                      classes: Dict[str, _ClassInfo],
                      held_exprs: List[ast.AST]) -> bool:
    """True when a ``.wait()``/``.wait_for()`` releases the held lock:
    the receiver IS the held with-context, or is a Condition constructed
    over the innermost held lock."""
    recv_chain = attr_chain(call.func.value) \
        if isinstance(call.func, ast.Attribute) else None
    if recv_chain is None:
        return False
    for held in held_exprs:
        if attr_chain(held) == recv_chain:
            return True
    if recv_chain[0] == "self" and len(recv_chain) == 2:
        innermost = terminal_name(held_exprs[-1]) if held_exprs else None
        for ci in _mro(classes, cls or ""):
            if recv_chain[1] in ci.cond_assoc:
                assoc = ci.cond_assoc[recv_chain[1]]
                return assoc is not None and assoc == innermost
    return False


@rule("PSL1", "concurrency: blocking/logging under hot locks, lock order")
def check_locks(index: RepoIndex):
    classes = _build_class_index(index)
    summaries = _compute_summaries(index, classes)
    findings: List[Finding] = []
    # ordered lock pairs: (outer identity, inner identity) -> first site
    pairs: Dict[Tuple[str, str], Tuple[str, int]] = {}

    for sf in index.files:
        mfuncs = _module_functions(sf.tree)
        for cls, fn in walk_functions(sf.tree):
            _scan_function(sf, cls, fn, mfuncs, classes, summaries,
                           findings, pairs)

    findings.extend(_lock_order_cycles(pairs))
    return findings


def _lock_order_cycles(pairs, rule_id: str = "PSL102") -> List[Finding]:
    """PSL102 (and, via ``rule_id``, its C++ twin PSL501): ANY cycle in
    the lock-order graph is a deadlock finding — the pairwise A->B /
    B->A inversion, but also longer chains (A->B, B->C, C->A) where no
    single pair is ever reversed. The graph is tiny (a dozen lock
    identities), so a bounded DFS per start node is plenty; each cycle
    is reported once (deduped on its node set)."""
    adj: Dict[str, Dict[str, Tuple[str, int]]] = {}
    for (a, b), site in pairs.items():
        if a != b:
            adj.setdefault(a, {})[b] = site
    findings: List[Finding] = []
    reported: Set[frozenset] = set()
    for start in sorted(adj):
        stack = [(start, (start,))]
        while stack:
            node, path_nodes = stack.pop()
            for nxt in sorted(adj.get(node, {}), reverse=True):
                if nxt == start:
                    key = frozenset(path_nodes)
                    # canonical start = min node, so each rotation of the
                    # same cycle dedups to one report
                    if key in reported or start != min(path_nodes):
                        continue
                    reported.add(key)
                    path, line = adj[start][path_nodes[1]] \
                        if len(path_nodes) > 1 else adj[node][nxt]
                    if len(path_nodes) == 2:
                        a, b = path_nodes
                        rpath, rline = adj[b][a]
                        findings.append(Finding(
                            rule_id, "P1", path, line,
                            f"inconsistent lock order: {a} -> {b} here "
                            f"but {b} -> {a} at {rpath}:{rline} — "
                            f"opposite nesting can deadlock"))
                    else:
                        chain = " -> ".join(path_nodes + (start,))
                        findings.append(Finding(
                            rule_id, "P1", path, line,
                            f"lock-order cycle: {chain} — these paths "
                            f"can deadlock even though no single pair "
                            f"is ever reversed"))
                elif nxt not in path_nodes:
                    stack.append((nxt, path_nodes + (nxt,)))
    findings.sort(key=lambda f: (f.path, f.line, f.message))
    return findings


def _scan_function(sf, cls, fn, mfuncs, classes, summaries, findings,
                   pairs) -> None:
    """Walk one function tracking the lexical with-lock stack."""

    def visit(node, held: List[Tuple[str, ast.AST]]):
        if isinstance(node, ast.With):
            acquired = []
            for item in node.items:
                # the context expression itself evaluates under whatever
                # is held so far — a blocking call used AS a context
                # manager (`with connect(h, p) as c:`) blocks exactly
                # like a plain-statement call
                visit(item.context_expr, held + acquired)
                t = _is_lockish(item.context_expr)
                if t:
                    ident = _lock_identity(item.context_expr, cls, classes)
                    for outer_ident, _ in held:
                        key = (outer_ident, ident)
                        pairs.setdefault(key, (sf.path, node.lineno))
                    acquired.append((ident, item.context_expr))
            inner = held + acquired
            for child in node.body:
                visit(child, inner)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested defs run later, not under this lock
        if isinstance(node, ast.Call) and held:
            _check_call(node, held)
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    def _check_call(call: ast.Call, held) -> None:
        t = terminal_name(call.func)
        held_exprs = [e for _, e in held]
        innermost = held_exprs[-1]
        innermost_t = (terminal_name(innermost.func)
                       if isinstance(innermost, ast.Call)
                       else terminal_name(innermost))
        lockset = ", ".join(i for i, _ in held)
        if t in ("wait", "wait_for"):
            if not _cond_wait_exempt(call, cls, classes, held_exprs):
                findings.append(Finding(
                    "PSL101", "P1", sf.path, call.lineno,
                    f"{t}() on a foreign condition while holding "
                    f"[{lockset}] — the held lock is NOT released by this "
                    f"wait and every contender stalls"))
            return
        if t in BLOCKING_CALLS or _is_thread_join(call):
            findings.append(Finding(
                "PSL101", "P1", sf.path, call.lineno,
                f"blocking call {t}() under lock [{lockset}]"))
            return
        if t in ENGINE_APPLY_CALLS:
            if innermost_t not in _APPLY_LOCK_NAMES:
                findings.append(Finding(
                    "PSL101", "P1", sf.path, call.lineno,
                    f"engine apply {t}() under non-apply lock "
                    f"[{lockset}] — applies belong under the engine lock "
                    f"only"))
            return
        if _is_logging_call(call):
            findings.append(Finding(
                "PSL103", "P2", sf.path, call.lineno,
                f"logging I/O under lock [{lockset}] — format+write "
                f"outside the critical section"))
            return
        hit = _callee(call, cls, classes, mfuncs)
        if hit is not None:
            cname, name, callee_fn = hit
            cs = summaries.get(id(callee_fn))
            if cs is not None and cs.blocks:
                findings.append(Finding(
                    "PSL101", "P1", sf.path, call.lineno,
                    f"{name}() may block (via {cs.blocks}) under lock "
                    f"[{lockset}]"))
                return
            if cs is not None:
                for inner in cs.acquires:
                    for outer_ident, _ in held:
                        pairs.setdefault((outer_ident, inner),
                                         (sf.path, call.lineno))

    for stmt in fn.body:
        visit(stmt, [])
