"""pslint for the port — repo-aware static analysis of ``ps_tpu_torch``.

Usage::

    python -m ps_tpu_torch.analysis ps_tpu_torch/            # the gate
    python -m ps_tpu_torch.analysis ps_tpu_torch/ --json     # machine-readable
    python -m ps_tpu_torch.analysis path/a.py b.cu           # spot-check files
    python -m ps_tpu_torch.analysis ps_tpu_torch/ --rules PSL5 PSL6
    python -m ps_tpu_torch.analysis ps_tpu_torch/ --native-only  # C++/CUDA + ABI
    python -m ps_tpu_torch.analysis ps_tpu_torch/ --write-baseline lint.json
    python -m ps_tpu_torch.analysis ps_tpu_torch/ --baseline lint.json
    python -m ps_tpu_torch.analysis --list-rules

Exit status: 0 = clean (every finding fixed or suppressed-with-reason;
with ``--baseline``, no finding OUTSIDE the snapshot), 1 = findings
(with ``--baseline``, NEW findings — the snapshot's are tolerated and
ones that disappeared are reported as fixed), 2 = usage error (unknown
--rules selection, missing baseline file, conflicting selectors).

By default, when run from a checkout, the repo's ``README.md`` joins as
the doc side of the knob-drift rules, and ``ps_tpu_torch/examples/``,
``chip_smoke.py``, ``tools/ps_top.py`` and ``tools/ps_doctor.py`` join as
*context*: they consume the port services' STATS and trace header keys,
and are read for evidence but never reported on (a path that is also
linted is linted). C++ and CUDA sources (``native/van.cpp``,
``ops/csrc/*.cu``) are collected from linted AND context roots and are
always linted. ``--no-default-context`` disables the auto-context,
``--context`` adds more roots, ``--readme`` points elsewhere.

``--baseline`` is a ratchet: emit a snapshot once with
``--write-baseline``, then compare against it so new code cannot add
findings while existing ones are burned down.

The rule families are in ``ps_tpu_torch/analysis/``; the README's
"Static analysis" section gives the suppression and annotation syntax.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys

from ps_tpu_torch.analysis import all_rules, run_lint

#: the checkout root: the directory that holds the ``ps_tpu_torch`` package
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the language split --native-only / --py-only select between
NATIVE_FAMILIES = ("PSL5", "PSL6")
PY_FAMILIES = ("PSL1", "PSL2", "PSL3", "PSL4")

#: read-only evidence for the port's tree, relative to the checkout
DEFAULT_CONTEXT = ("ps_tpu_torch/examples", "chip_smoke.py",
                   "tools/ps_top.py", "tools/ps_doctor.py")


def default_context(repo: str = REPO):
    """The default context roots that exist under ``repo``, and its
    README (or None)."""
    context = [os.path.join(repo, p) for p in DEFAULT_CONTEXT
               if os.path.exists(os.path.join(repo, p))]
    readme = os.path.join(repo, "README.md")
    return context, (readme if os.path.isfile(readme) else None)


def _finding_key(f) -> dict:
    # a ratchet baseline keys on (rule, path, message with location
    # digits normalized) so a refactor above a finding (or above a site
    # its message cites) does not thrash the snapshot; identical keys are
    # counted, not deduped, so a second occurrence is still new
    msg = re.sub(r"(?<=:)\d+", "_", f.message)
    msg = re.sub(r"\bline \d+", "line _", msg)
    return {"rule": f.rule, "path": f.path, "message": msg}


def _key_tuple(f):
    return tuple(sorted(_finding_key(f).items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ps_tpu_torch.analysis",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("paths", nargs="*", help="files/dirs to lint")
    ap.add_argument("--context", action="append", default=[],
                    help="extra read-only evidence roots (repeatable)")
    ap.add_argument("--readme", default=None,
                    help="README path for the knob-drift rules "
                         "(default: the checkout's README.md)")
    ap.add_argument("--no-default-context", action="store_true",
                    help="do not auto-add the default context and README")
    ap.add_argument("--rules", nargs="+", default=None, metavar="PSLn",
                    help="rule-family prefixes or concrete ids, space- "
                         "or comma-separated (e.g. --rules PSL5 PSL6)")
    ap.add_argument("--native-only", action="store_true",
                    help=f"only the native families "
                         f"{'/'.join(NATIVE_FAMILIES)} (C++/CUDA rules + "
                         f"the ctypes ABI drift gate)")
    ap.add_argument("--py-only", action="store_true",
                    help=f"only the Python families "
                         f"{'/'.join(PY_FAMILIES)}")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="compare against a findings snapshot: only "
                         "findings NOT in it fail the run (the ratchet)")
    ap.add_argument("--write-baseline", default=None, metavar="FILE",
                    help="write the current findings as a snapshot for "
                         "--baseline and exit 0")
    ap.add_argument("--timings", action="store_true",
                    help="print per-family wall time to stderr")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as a JSON array")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for prefix, (doc, _fn) in sorted(all_rules().items()):
            print(f"{prefix}xx  {doc}")
        return 0
    if not args.paths:
        ap.error("no paths given (try: python -m ps_tpu_torch.analysis "
                 "ps_tpu_torch/)")
    if sum([bool(args.rules), args.native_only, args.py_only]) > 1:
        ap.error("--rules, --native-only and --py-only are mutually "
                 "exclusive")
    if args.baseline and args.write_baseline:
        ap.error("--baseline and --write-baseline are mutually exclusive")

    context = list(args.context)
    readme = args.readme
    if not args.no_default_context:
        extra, default_readme = default_context()
        context += extra
        if readme is None:
            readme = default_readme
    rules = None
    if args.rules:
        rules = [r.strip() for tok in args.rules
                 for r in tok.split(",") if r.strip()]
    elif args.native_only:
        rules = list(NATIVE_FAMILIES)
    elif args.py_only:
        rules = list(PY_FAMILIES)

    timings = {} if args.timings else None
    try:
        findings = run_lint(args.paths, context=context, readme=readme,
                            rules=rules, timings=timings)
    except ValueError as e:
        ap.error(str(e))  # unknown --rules selection: exit 2, not 'clean'
    if timings is not None:
        for prefix, secs in sorted(timings.items()):
            print(f"pslint: {prefix}xx {secs*1e3:7.1f} ms", file=sys.stderr)

    if args.write_baseline:
        snap = {"version": 1, "findings": [_finding_key(f)
                                           for f in findings]}
        with open(args.write_baseline, "w", encoding="utf-8") as f:
            json.dump(snap, f, indent=2)
        print(f"pslint: baseline with {len(findings)} finding(s) "
              f"written to {args.write_baseline}", file=sys.stderr)
        return 0

    fixed = 0
    if args.baseline:
        try:
            with open(args.baseline, encoding="utf-8") as f:
                snap = json.load(f)
        except (OSError, ValueError) as e:
            ap.error(f"--baseline {args.baseline}: {e}")
        # multiset comparison: each key is tolerated only as many times
        # as the snapshot recorded it
        old = collections.Counter(tuple(sorted(d.items()))
                                  for d in snap.get("findings", []))
        seen: collections.Counter = collections.Counter()
        new = []
        for f in findings:
            k = _key_tuple(f)
            seen[k] += 1
            if seen[k] > old.get(k, 0):
                new.append(f)
        fixed = sum((old - seen).values())
        findings = new

    if args.as_json:
        print(json.dumps([vars(f) for f in findings], indent=2))
    else:
        for f in findings:
            print(f.format())
        sev = {}
        for f in findings:
            sev[f.severity] = sev.get(f.severity, 0) + 1
        tag = "new " if args.baseline else ""
        if findings:
            counts = ", ".join(f"{k}: {v}" for k, v in sorted(sev.items()))
            print(f"pslint: {len(findings)} {tag}finding(s) ({counts})",
                  file=sys.stderr)
        else:
            print(f"pslint: clean{' vs baseline' if args.baseline else ''}",
                  file=sys.stderr)
        if args.baseline and fixed > 0:
            print(f"pslint: {fixed} baseline finding(s) no longer fire — "
                  f"regenerate with --write-baseline to ratchet down",
                  file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
