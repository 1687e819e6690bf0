"""PSL3xx — resource safety: borrows, shm segments, spans, threads.

The transport recycles receive buffers through
:class:`~ps_tpu_torch.control.tensor_van.RecvBufferPool`, maps POSIX shm
segments that must be unlinked exactly once, opens trace spans that must
close on every exit path (a leaked span corrupts the thread's parentage
stack), and spawns threads that must either be daemonic or joined. Each
leak class gets a rule:

- **PSL301** — a function that calls ``pool.borrow(...)`` must either
  return the buffer to a pool (``.ret(...)`` / ``_release_frame(...)``)
  or hand ownership out (a value-returning ``return`` — the documented
  contract of ``Channel.recv``: the caller returns the frame).
- **PSL302** — a function creating shm segments (``_create`` /
  ``shm_open``) must unlink on its failure paths (``.unlink(`` present)
  or store the segment on ``self`` (ownership transferred to the
  object's ``close``); raw ``shm_open`` fds must be ``os.close``d.
- **PSL303** — a span factory call (``.span(`` / ``.child(``) whose
  result is neither used as a ``with`` context, assigned-and-entered,
  returned, nor passed onward is a span that never records; a manual
  ``__enter__()`` without a matching ``__exit__`` in the same class's
  ``__enter__``/``__exit__`` pair or a ``finally`` leaks the tracer's
  per-thread stack on exceptions.
- **PSL304** — ``threading.Thread(...)`` without ``daemon=True`` must be
  joined somewhere in the same class/module, or it blocks interpreter
  exit forever.
"""

from __future__ import annotations

import ast
from typing import List, Set

from ps_tpu_torch.analysis.core import (
    Finding,
    RepoIndex,
    attr_chain,
    rule,
    terminal_name,
    walk,
    walk_functions,
)

_SPAN_FACTORIES = {"span", "child"}


def _calls_with_name(fn: ast.AST, name: str) -> List[ast.Call]:
    return [n for n in walk(fn)
            if isinstance(n, ast.Call) and terminal_name(n.func) == name]


def _has_value_return(fn: ast.AST) -> bool:
    for node in walk(fn):
        if isinstance(node, ast.Return) and node.value is not None \
                and not (isinstance(node.value, ast.Constant)
                         and node.value.value is None):
            return True
    return False


@rule("PSL3", "resource safety: borrows, shm segments, spans, threads")
def check_resources(index: RepoIndex):
    findings: List[Finding] = []
    for sf in index.files:
        for cls, fn in walk_functions(sf.tree):
            _check_borrow(sf, fn, findings)
            _check_segments(sf, fn, findings)
            _check_spans(sf, cls, fn, findings)
        _check_threads(sf, findings)
    return findings


def _check_borrow(sf, fn, findings) -> None:
    borrows = _calls_with_name(fn, "borrow")
    if not borrows:
        return
    returns_buffer = bool(_calls_with_name(fn, "ret")
                          or _calls_with_name(fn, "_release_frame"))
    if returns_buffer or _has_value_return(fn):
        return
    findings.append(Finding(
        "PSL301", "P1", sf.path, borrows[0].lineno,
        f"{fn.name}() borrows from a RecvBufferPool but neither returns "
        f"the buffer (.ret()/_release_frame()) nor hands ownership out "
        f"via a value return — the borrow is stranded on every path"))


def _check_segments(sf, fn, findings) -> None:
    creates = (_calls_with_name(fn, "_create")
               + _calls_with_name(fn, "shm_open"))
    if not creates:
        return
    raw_opens = _calls_with_name(fn, "shm_open")
    if raw_opens:
        closes = [c for c in _calls_with_name(fn, "close")
                  if attr_chain(c.func) and attr_chain(c.func)[0] == "os"]
        if not closes:
            findings.append(Finding(
                "PSL302", "P2", sf.path, raw_opens[0].lineno,
                f"{fn.name}() opens a shm fd (shm_open) without an "
                f"os.close() — the fd leaks on the failure paths"))
    made = _calls_with_name(fn, "_create")
    if made:
        unlinks = _calls_with_name(fn, "unlink")
        stored_on_self = any(
            isinstance(n, ast.Assign)
            and any((attr_chain(t) or ["?"])[0] == "self"
                    for t in n.targets)
            for n in walk(fn)
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call)
            and terminal_name(n.value.func) == "_create"
        )
        if not unlinks and not stored_on_self:
            findings.append(Finding(
                "PSL302", "P2", sf.path, made[0].lineno,
                f"{fn.name}() creates shm segments but never unlink()s "
                f"them and does not transfer ownership to self — "
                f"segments leak in /dev/shm on the failure paths"))


def _with_context_calls(fn: ast.AST) -> Set[int]:
    """ids of Call nodes appearing inside a with-item context expr."""
    out: Set[int] = set()
    for node in walk(fn):
        if isinstance(node, ast.With):
            for item in node.items:
                for sub in walk(item.context_expr):
                    if isinstance(sub, ast.Call):
                        out.add(id(sub))
    return out


def _check_spans(sf, cls, fn, findings) -> None:
    span_calls = [c for name in _SPAN_FACTORIES
                  for c in _calls_with_name(fn, name)]
    if span_calls:
        in_with = _with_context_calls(fn)
        # names assigned from a span factory
        assigned: dict = {}
        consumed_names: Set[str] = set()
        for node in walk(fn):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and id(node.value) in {id(c) for c in span_calls}:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        assigned[t.id] = node.value
        for node in walk(fn):
            if isinstance(node, ast.With):
                for item in node.items:
                    for sub in walk(item.context_expr):
                        if isinstance(sub, ast.Name):
                            consumed_names.add(sub.id)
            elif isinstance(node, ast.Return) and node.value is not None:
                for sub in walk(node.value):
                    if isinstance(sub, ast.Name):
                        consumed_names.add(sub.id)
            elif isinstance(node, ast.Call):
                for arg in list(node.args) + [k.value for k in
                                              node.keywords]:
                    for sub in walk(arg):
                        if isinstance(sub, ast.Name):
                            consumed_names.add(sub.id)
        for call in span_calls:
            if id(call) in in_with:
                continue
            # returned or passed onward directly?
            used = False
            for node in walk(fn):
                if isinstance(node, ast.Return) and node.value is not None:
                    if any(sub is call for sub in walk(node.value)):
                        used = True
                if isinstance(node, ast.Call) and node is not call:
                    for arg in list(node.args) + [k.value
                                                  for k in node.keywords]:
                        if any(sub is call for sub in walk(arg)):
                            used = True
                if isinstance(node, ast.Attribute) and node.value is call:
                    used = True  # chained (.set(...) etc.)
            for name, c in assigned.items():
                if c is call and name in consumed_names:
                    used = True
            if not used:
                findings.append(Finding(
                    "PSL303", "P2", sf.path, call.lineno,
                    f"span created in {fn.name}() is never entered "
                    f"(no 'with'), returned, or passed on — it will "
                    f"never record"))
    # manual __enter__ without a paired __exit__ discipline
    enters = _calls_with_name(fn, "__enter__")
    if enters and fn.name not in ("__enter__", "__exit__"):
        exits_in_finally = False
        for node in walk(fn):
            if isinstance(node, ast.Try):
                for handler_body in [node.finalbody] + \
                        [h.body for h in node.handlers]:
                    for stmt in handler_body:
                        for sub in walk(stmt):
                            if isinstance(sub, ast.Call) and \
                                    terminal_name(sub.func) == "__exit__":
                                exits_in_finally = True
        if not exits_in_finally:
            findings.append(Finding(
                "PSL303", "P2", sf.path, enters[0].lineno,
                f"manual __enter__() in {fn.name}() without __exit__ in "
                f"a finally/except — an exception leaks the context "
                f"(for spans: corrupts the tracer's thread stack)"))


def _check_threads(sf, findings) -> None:
    """PSL304 per file: non-daemon Thread constructions need a join."""
    joined_names: Set[str] = set()
    for node in walk(sf.tree):
        if isinstance(node, ast.Call) \
                and terminal_name(node.func) == "join" \
                and isinstance(node.func, ast.Attribute):
            chain = attr_chain(node.func.value)
            if chain:
                joined_names.add(chain[-1])
    for node in walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func)
        if not chain or chain[-1] != "Thread":
            continue
        if len(chain) >= 2 and chain[-2] not in ("threading", "Thread"):
            continue
        daemon = None
        for kw in node.keywords:
            if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
                daemon = bool(kw.value.value)
        if daemon:
            continue
        # where does the thread object land? joined later by that name?
        target_names = _assign_targets_of(sf.tree, node)
        if target_names & joined_names:
            continue
        # `t.daemon = True` after construction?
        if any(_daemon_set_after(sf.tree, n) for n in target_names):
            continue
        findings.append(Finding(
            "PSL304", "P2", sf.path, node.lineno,
            "non-daemon Thread is never joined (and daemon not set) — "
            "it blocks interpreter shutdown; pass daemon=True or join it"))


def _assign_targets_of(tree: ast.AST, call: ast.Call) -> Set[str]:
    out: Set[str] = set()
    for node in walk(tree):
        if isinstance(node, ast.Assign) and node.value is call:
            for t in node.targets:
                chain = attr_chain(t)
                if chain:
                    out.add(chain[-1])
    return out


def _daemon_set_after(tree: ast.AST, name: str) -> bool:
    for node in walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            chain = attr_chain(node.targets[0])
            if chain and chain[-1] == "daemon" and len(chain) >= 2 \
                    and chain[-2] == name \
                    and isinstance(node.value, ast.Constant) \
                    and node.value.value is True:
                return True
    return False
