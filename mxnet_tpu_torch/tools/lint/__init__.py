"""mxlint — the port's own static-analysis suite (counterpart of
``mxnet_tpu/tools/lint``).

Each rule encodes one convention of the package as a named,
individually suppressible AST check over its source:

- ``atomic-write``: every durable artifact is written to a temporary
  name and ``os.replace``d;
- ``counter-lock``: every bump of an observability counter holds its
  lock;
- ``thread-hygiene``: every worker thread is daemon (or names its
  drain), every queue of a pipeline or writer module is bounded;
- ``env-registry``: every ``MXNET_*`` knob reads through the typed
  :mod:`mxnet_tpu_torch.envs` registry;
- ``graph-capture``: every CUDA graph is captured by
  ``cached_op._cuda_capture`` (its process-wide capture lock, the
  cyclic collector held off, the launch recording), the port's
  counterpart of the JAX package's ``jit-staging``;
- ``captured-purity``: a body handed to a graph holder for capture
  reads no clock, draws no host random number, mutates no global and
  reads no environment variable: each would be frozen into the graph
  at capture (the counterpart of ``traced-purity``).

Usage::

    python -m mxnet_tpu_torch.tools.lint            # lint mxnet_tpu_torch/
    python -m mxnet_tpu_torch.tools.lint path/ --format json
    python -m mxnet_tpu_torch.tools.lint --envs     # env-var reference
    python -m mxnet_tpu_torch.tools.lint --list-rules

Suppress one finding inline with a trailing comment naming the rule::

    with open(path, "w") as f:   # mxlint: disable=atomic-write -- a log

Grandfathered sites live in the committed ``baseline.json`` next to
this package; every entry carries a one-line rationale and matches on
(rule, path, source line text), so line-number drift never resurrects
it.
"""
from .core import (LintResult, Violation, lint_paths, lint_source,
                   load_baseline, RULES, rule_names)

__all__ = ["LintResult", "Violation", "lint_paths", "lint_source",
           "load_baseline", "RULES", "rule_names"]
