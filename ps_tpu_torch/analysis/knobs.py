"""PSL4xx — knob/doc drift: Config fields, PS_* env mirrors, README, docstrings.

The config surface is mirrored four ways — a ``Config`` dataclass field,
its ``PS_*`` environment variable in ``Config.from_env``, a row in the
README's knob documentation, and the config module/class docstrings —
and nothing but this rule keeps them in sync. With 100+ ``PS_*``
references in the tree, drift is the steady state without a gate: a knob
readable from env but absent from the docs is invisible to operators,
and a documented knob nothing reads is worse (operators set it and
nothing happens).

- **PSL401** — a Config field with no row in the class docstring's
  attribute list.
- **PSL402** — a Config field never settable from the environment (no
  ``PS_*`` handling in ``from_env``); deliberate non-env knobs carry a
  suppression naming why.
- **PSL403** — an env var consumed by ``from_env`` but missing from the
  config module docstring's env list.
- **PSL404** — a ``PS_*`` env var read anywhere in the linted tree but
  absent from the README.
- **PSL405** — a ``PS_*`` var documented (README or config docstring)
  that no code reads: doc rot pointing operators at a dead knob.
- **PSL406** — a raw ``os.environ``/``os.getenv`` read of a ``PS_*``
  name OUTSIDE the Config module. Config's ``from_env`` clamps and
  validates; a service-level raw read bypasses all of it (a
  ``PS_VAN_LOOP_THREADS`` read at the service would reach ``nl_start``
  unclamped and fail as an opaque nullptr). Service-level mirrors go through the validated readers
  ``config.env_flag``/``env_int``/``env_float``/``env_str`` (or Config
  itself); a deliberate raw read carries a suppression saying why.
"""

from __future__ import annotations

import ast
import inspect
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

_ENV_RE = re.compile(r"^PS_[A-Z][A-Z0-9_]*$")
#: boundary-guarded: must not match the PS_ROOT_URI inside DMLC_PS_ROOT_URI
_DOC_ENV_RE = re.compile(r"(?<![A-Z0-9_])PS_[A-Z][A-Z0-9_]*")

_ATTR_ROW_RE = re.compile(
    r"^ {1,4}([a-z_][a-z0-9_]*(?:\s*/\s*[a-z_][a-z0-9_]*)*):")

#: calls whose first string arg names an env var the code READS (the
#: validated config readers included — their reads keep knobs alive for
#: PSL404/405 exactly like raw ones)
_ENV_CALL_FNS = {"get", "getenv", "env_flag", "env_int", "env_float",
                 "env_str"}
_ENV_RECEIVERS = {"env", "environ"}

#: the sanctioned service-level readers (defined in the Config module);
#: anything else touching os.environ for a PS_* name is PSL406
_VALIDATED_READERS = {"env_flag", "env_int", "env_float", "env_str"}


def _find_config(index: RepoIndex) -> Optional[Tuple[SourceFile,
                                                     ast.ClassDef]]:
    for sf in index.all_files:
        for node in sf.tree.body:
            if isinstance(node, ast.ClassDef) and node.name == "Config":
                return sf, node
    return None


def _config_fields(cls: ast.ClassDef) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for node in cls.body:
        if isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            out[node.target.id] = node.lineno
    return out


def _docstring_attr_names(cls: ast.ClassDef) -> Set[str]:
    doc = ast.get_docstring(cls) or ""
    names: Set[str] = set()
    for line in inspect.cleandoc(doc).splitlines():
        m = _ATTR_ROW_RE.match(line)
        if m:
            for part in m.group(1).split("/"):
                names.add(part.strip())
    return names


def _from_env_map(cls: ast.ClassDef) -> Tuple[Dict[str, Set[str]],
                                              Dict[str, int]]:
    """``{field: {env names in its guard}}`` plus first line per env."""
    fn = None
    for node in cls.body:
        if isinstance(node, ast.FunctionDef) and node.name == "from_env":
            fn = node
    field_env: Dict[str, Set[str]] = {}
    env_lines: Dict[str, int] = {}
    if fn is None:
        return field_env, env_lines

    def envs_in(node: ast.AST) -> Set[str]:
        out = set()
        for sub in walk(node):
            s = str_const(sub)
            if s and _ENV_RE.match(s):
                out.add(s)
                env_lines.setdefault(s, sub.lineno)
        return out

    def visit(stmts, guard_envs: Set[str]):
        for stmt in stmts:
            if isinstance(stmt, ast.If):
                test_envs = envs_in(stmt.test)
                visit(stmt.body, guard_envs | test_envs)
                visit(stmt.orelse, guard_envs)
                continue
            for sub in walk(stmt):
                if isinstance(sub, ast.Subscript) \
                        and isinstance(sub.ctx, ast.Store) \
                        and terminal_name(sub.value) == "kwargs":
                    key = str_const(sub.slice)
                    if key:
                        all_envs = guard_envs | envs_in(stmt)
                        field_env.setdefault(key, set()).update(all_envs)

    visit(fn.body, set())
    return field_env, env_lines


def _env_reads(files) -> Dict[str, Tuple[str, int]]:
    """Every PS_* env var ``files`` actually read, with the first read
    site (precise extraction — call args / subscripts / `in` tests,
    never docstring mentions)."""
    reads: Dict[str, Tuple[str, int]] = {}

    def record(name: Optional[str], sf: SourceFile, line: int) -> None:
        if name and _ENV_RE.match(name):
            reads.setdefault(name, (sf.path, line))

    for sf in files:
        for node in walk(sf.tree):
            if isinstance(node, ast.Call) \
                    and terminal_name(node.func) in _ENV_CALL_FNS \
                    and node.args:
                record(str_const(node.args[0]), sf, node.lineno)
            elif isinstance(node, ast.Subscript):
                recv = terminal_name(node.value)
                if recv in _ENV_RECEIVERS:
                    record(str_const(node.slice), sf, node.lineno)
            elif isinstance(node, ast.Compare):
                for op, comp in zip(node.ops, node.comparators):
                    if isinstance(op, ast.In) \
                            and terminal_name(comp) in _ENV_RECEIVERS:
                        record(str_const(node.left), sf, node.lineno)
    return reads


def _raw_env_reads(files) -> List[Tuple[str, str, int]]:
    """Every RAW value read of a constant-named PS_* env var: a direct
    ``os.environ.get``/``os.environ[...]``/``os.getenv`` — precisely,
    so dict ``.get`` calls and environ WRITES never match. Reads routed
    through the validated config readers are not raw."""
    out: List[Tuple[str, str, int]] = []
    for sf in files:
        for node in walk(sf.tree):
            name = None
            if isinstance(node, ast.Call) and node.args:
                t = terminal_name(node.func)
                if t == "get" and isinstance(node.func, ast.Attribute) \
                        and terminal_name(node.func.value) == "environ":
                    name = str_const(node.args[0])
                elif t == "getenv" and isinstance(
                        node.func, (ast.Attribute, ast.Name)):
                    name = str_const(node.args[0])
            elif isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Load) \
                    and terminal_name(node.value) == "environ":
                name = str_const(node.slice)
            if name and _ENV_RE.match(name):
                out.append((name, sf.path, node.lineno))
    return out


@rule("PSL4", "knob/doc drift: Config <-> PS_* env <-> README <-> docstrings")
def check_knobs(index: RepoIndex):
    findings: List[Finding] = []
    hit = _find_config(index)
    reads = _env_reads(index.files)
    # context files (tools/, bench.py) count as readers for the doc-rot
    # rule — a knob consumed only by an operator tool is alive — but
    # PSL404 never anchors a finding in them
    context_reads = _env_reads(index.context)
    readme_envs = set(_DOC_ENV_RE.findall(index.readme_text))
    doc_envs: Set[str] = set()
    config_path = None
    if hit is not None:
        sf, cls = hit
        config_path = sf.path
        fields = _config_fields(cls)
        doc_names = _docstring_attr_names(cls)
        field_env, env_lines = _from_env_map(cls)
        module_doc = ast.get_docstring(sf.tree) or ""
        doc_envs |= set(_DOC_ENV_RE.findall(module_doc))
        class_doc = ast.get_docstring(cls) or ""
        doc_envs |= set(_DOC_ENV_RE.findall(class_doc))
        for field, line in sorted(fields.items()):
            if field not in doc_names:
                findings.append(Finding(
                    "PSL401", "P2", sf.path, line,
                    f"Config field {field!r} has no row in the class "
                    f"docstring's attribute list"))
            if not field_env.get(field):
                findings.append(Finding(
                    "PSL402", "P2", sf.path, line,
                    f"Config field {field!r} has no PS_* env mirror in "
                    f"from_env — launchers cannot set it; add one or "
                    f"suppress with the reason it must stay code-only"))
        for field, envs in sorted(field_env.items()):
            for env in sorted(envs):
                if env not in set(_DOC_ENV_RE.findall(module_doc)):
                    findings.append(Finding(
                        "PSL403", "P2", sf.path,
                        env_lines.get(env, 1),
                        f"{env} is consumed by from_env but missing from "
                        f"the config module docstring's env list"))
    if index.readme_text:
        for env, (path, line) in sorted(reads.items()):
            if env not in readme_envs:
                findings.append(Finding(
                    "PSL404", "P2", path, line,
                    f"{env} is read here but appears nowhere in the "
                    f"README — operators cannot discover it"))
        dead = (readme_envs | doc_envs) - set(reads) - set(context_reads)
        for env in sorted(dead):
            where = "README" if env in readme_envs else "config docstring"
            findings.append(Finding(
                "PSL405", "P2", config_path or index.readme_path or "?", 1,
                f"{env} is documented in the {where} but no code reads "
                f"it — doc rot (or the consumer was dropped)"))
    for env, path, line in sorted(_raw_env_reads(index.files)):
        if config_path is not None and path == config_path:
            continue  # Config IS the validated reader
        findings.append(Finding(
            "PSL406", "P2", path, line,
            f"raw os.environ read of {env} outside the Config module "
            f"bypasses Config's clamping/validation (the "
            f"PS_VAN_LOOP_THREADS lesson) — use config.env_flag/"
            f"env_int/env_float/env_str, or suppress with the reason "
            f"this read must stay raw"))
    return findings
