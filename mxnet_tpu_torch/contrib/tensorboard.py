"""TensorBoard metric logging (counterpart of
``mxnet_tpu/contrib/tensorboard.py``; reference:
python/mxnet/contrib/tensorboard.py). The writer backend is optional:
mxboard, tensorboardX and ``torch.utils.tensorboard`` are tried in that
order; with none of them, construction raises ImportError."""
from __future__ import annotations

__all__ = ["LogMetricsCallback"]


def _find_writer(logging_dir):
    try:
        from mxboard import SummaryWriter
        return SummaryWriter(logging_dir)
    except ImportError:
        pass
    try:
        from tensorboardX import SummaryWriter
        return SummaryWriter(logging_dir)
    except ImportError:
        pass
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(logging_dir)
    except ImportError:
        raise ImportError(
            "LogMetricsCallback needs a SummaryWriter backend: install "
            "mxboard, tensorboardX, or tensorboard for torch")


class LogMetricsCallback:
    """Epoch- or batch-end callback writing metric scalars to
    TensorBoard event files (reference: contrib/tensorboard.py:45).

    ``log_telemetry=True`` also writes the active telemetry run's
    samples/s, goodput and step-time p50 (``telemetry.quick_stats()``)
    as ``telemetry/*`` scalars."""

    def __init__(self, logging_dir, prefix=None, log_telemetry=False):
        self.prefix = prefix
        self.log_telemetry = log_telemetry
        self.summary_writer = _find_writer(logging_dir)
        self._step = 0

    def __call__(self, param):
        if param.eval_metric is None and not self.log_telemetry:
            return
        step = getattr(param, "epoch", None)
        if step is None:
            step = self._step
        self._step += 1
        if param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                if self.prefix is not None:
                    name = "%s-%s" % (self.prefix, name)
                self.summary_writer.add_scalar(name, value,
                                               global_step=step)
        if self.log_telemetry:
            self._write_telemetry(step)

    def _write_telemetry(self, step):
        # quick_stats, not report(): this runs at every batch end
        from .. import telemetry
        stats = telemetry.quick_stats() if telemetry.enabled() else None
        if not stats or not stats.get("steps"):
            return
        for key in ("samples_per_sec", "goodput", "step_time_ms_p50"):
            if stats.get(key) is not None:
                self.summary_writer.add_scalar(
                    "telemetry/" + key, stats[key], global_step=step)
