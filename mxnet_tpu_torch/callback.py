"""Training callbacks (counterpart of ``mxnet_tpu/callback.py``)."""
from __future__ import annotations

import logging
import math
import time

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar", "LogValidationMetricsCallback"]


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback: ``mod.save_checkpoint`` every ``period``
    epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end callback: ``model.save_checkpoint`` every ``period``
    epochs (reference: callback.py:58)."""
    from .model import save_checkpoint
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def log_train_metric(period, auto_reset=False):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class Speedometer:
    """Logs samples/sec and the metric every ``frequent`` batches
    (reference: callback.py:129). With a telemetry run active the speed
    comes from the run's step records (``telemetry.recent_rate``), so the
    log and the run's report agree; otherwise from a wall clock. With
    the compile watch on and utilization records in the window, an
    ``MFU`` column follows the speed (``compile_watch.recent_mfu``)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset

    def _speed(self):
        from . import telemetry
        speed = telemetry.recent_rate(self.frequent) \
            if telemetry.enabled() else None
        if speed is not None:
            return speed
        try:
            return self.frequent * self.batch_size / (time.time() - self.tic)
        except ZeroDivisionError:
            return float("inf")

    def _mfu(self):
        """Mean MFU over the logging window when the compile watch has
        utilization records for this run; None (no output change)
        otherwise."""
        from . import compile_watch
        if not compile_watch.enabled():
            return None
        return compile_watch.recent_mfu(self.frequent)

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if not self.init:
            self.init = True
            self.tic = time.time()
            return
        if count % self.frequent != 0:
            return
        speed = self._speed()
        mfu = self._mfu()
        mfu_part = () if mfu is None else (100.0 * mfu,)
        mfu_fmt = "" if mfu is None else "\tMFU: %.2f%%"
        if param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            if self.auto_reset:
                param.eval_metric.reset()
            logging.info("Epoch[%d] Batch [%d-%d]\tSpeed: %.2f samples/sec"
                         + mfu_fmt + "\t%s=%f" * len(name_value),
                         param.epoch, count - self.frequent, count, speed,
                         *mfu_part, *sum(name_value, ()))
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                         + mfu_fmt, param.epoch, count, speed, *mfu_part)
        self.tic = time.time()


class ProgressBar:
    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")


class LogValidationMetricsCallback:
    def __call__(self, param):
        if not param.eval_metric:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)
