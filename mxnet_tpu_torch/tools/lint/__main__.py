"""mxlint CLI — ``python -m mxnet_tpu_torch.tools.lint`` (counterpart of
``mxnet_tpu/tools/lint/__main__.py``).

Exit status: 0 when no non-baselined violations (and no stale
baseline entries), 1 otherwise, 2 on usage errors.
"""
from __future__ import annotations

import argparse
import json
import sys

from .core import (default_baseline_path, lint_paths, rule_docs,
                   rule_names)


def _text_report(result, verbose=False):
    out = []
    for v in result.violations:
        out.append("%s:%d:%d: [%s] %s"
                   % (v.path, v.line, v.col, v.rule, v.message))
    for e in result.stale_baseline:
        out.append("baseline: stale entry (%s, %s) — the violation "
                   "is gone; delete the entry"
                   % (e["rule"], e["path"]))
    counts = result.counts()
    summary = ("%d file(s), %d violation(s)"
               % (result.files, len(result.violations)))
    if counts:
        summary += " [" + ", ".join(
            "%s=%d" % kv for kv in sorted(counts.items())) + "]"
    if result.baselined:
        summary += ", %d baselined" % len(result.baselined)
    if result.suppressed:
        summary += ", %d suppressed" % result.suppressed
    summary += ", %.2fs" % result.elapsed_s
    out.append(summary)
    if verbose and result.baselined:
        out.append("-- baselined --")
        for v in result.baselined:
            out.append("%s:%d: [%s] (baselined)"
                       % (v.path, v.line, v.rule))
    return "\n".join(out)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.tools.lint",
        description="mxlint: the framework's invariant checks "
                    "(see mxnet_tpu_torch/tools/lint/__init__.py)")
    p.add_argument("paths", nargs="*",
                   help="files/directories to lint (default: the "
                        "mxnet_tpu_torch package)")
    p.add_argument("--format", choices=("text", "json"),
                   default="text")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="baseline file (default: the committed %s)"
                        % default_baseline_path())
    p.add_argument("--no-baseline", action="store_true",
                   help="report grandfathered sites too")
    p.add_argument("--rules", default=None, metavar="R1,R2",
                   help="run only these rules")
    p.add_argument("--list-rules", action="store_true")
    p.add_argument("--envs", action="store_true",
                   help="print the MXNET_* environment-variable "
                        "reference generated from mxnet_tpu_torch.envs")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)

    if args.envs:
        from ... import envs
        print(envs.render_reference())
        return 0
    if args.list_rules:
        from . import rules as _rules  # noqa: F401
        docs = rule_docs()
        for name in rule_names():
            print("%-16s %s" % (name, docs.get(name, "")))
        return 0

    rules = None
    if args.rules:
        from . import rules as _rules  # noqa: F401
        rules = [r.strip() for r in args.rules.split(",")
                 if r.strip()]
        unknown = [r for r in rules if r not in rule_names()]
        if unknown:
            print("unknown rule(s): %s (have: %s)"
                  % (", ".join(unknown), ", ".join(rule_names())),
                  file=sys.stderr)
            return 2
    result = lint_paths(args.paths or None, rules=rules,
                        baseline=args.baseline,
                        use_baseline=not args.no_baseline)
    if args.format == "json":
        print(json.dumps(result.to_dict(), indent=2))
    else:
        print(_text_report(result, verbose=args.verbose))
    return 0 if (result.ok and not result.stale_baseline) else 1


if __name__ == "__main__":
    sys.exit(main())
