"""Parse training logs into per-epoch tables (counterpart of
``mxnet_tpu/tools/parse_log.py``; parity:
tools/parse_log.py): extracts ``Epoch[N] Train-<metric>=V``,
``Epoch[N] Validation-<metric>=V`` and ``Epoch[N] Time cost=V`` rows —
the format emitted by ``Module.fit``'s epoch logging and the reference
trainers.
"""
from __future__ import annotations

import argparse
import re


# value pattern: plain/negative decimals AND scientific notation —
# `([.\d]+)` silently truncated `1e-07` to `1` and dropped the sign of
# negative metrics (perplexity deltas)
_NUM = r"(-?[\d.]+(?:[eE][+-]?\d+)?)"


def parse(lines, metric_names=("accuracy",)):
    """Returns {epoch: {"train-<m>": v, "val-<m>": v, "time": v}}."""
    pats = []
    for m in metric_names:
        pats.append(("train-" + m, re.compile(
            r".*Epoch\[(\d+)\] Train-" + re.escape(m) + r".*=" + _NUM)))
        pats.append(("val-" + m, re.compile(
            r".*Epoch\[(\d+)\] Validation-" + re.escape(m)
            + r".*=" + _NUM)))
    pats.append(("time", re.compile(
        r".*Epoch\[(\d+)\] Time.*=" + _NUM)))
    table = {}
    for line in lines:
        for name, pat in pats:
            m = pat.match(line)
            if m:
                epoch = int(m.group(1))
                table.setdefault(epoch, {})[name] = float(m.group(2))
    return table


def format_table(table, metric_names=("accuracy",)):
    cols = ["time"]
    for m in metric_names:
        cols += ["train-" + m, "val-" + m]
    out = ["epoch\t" + "\t".join(cols)]
    for epoch in sorted(table):
        row = table[epoch]
        out.append("\t".join([str(epoch)] + [
            ("%.6g" % row[c]) if c in row else "-" for c in cols]))
    return "\n".join(out)


def main(argv=None):
    p = argparse.ArgumentParser(description="parse mxnet training logs")
    p.add_argument("logfile")
    p.add_argument("--metric-names", nargs="+", default=["accuracy"])
    args = p.parse_args(argv)
    with open(args.logfile) as f:
        table = parse(f, tuple(args.metric_names))
    print(format_table(table, tuple(args.metric_names)))
    return table


if __name__ == "__main__":
    main()
