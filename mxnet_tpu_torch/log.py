"""Logging helpers (counterpart of ``mxnet_tpu/log.py``; parity:
python/mxnet/log.py): a formatter with level-colored output on TTYs and
``get_logger``/``getLogger``."""
from __future__ import annotations

import logging
import sys

__all__ = ["get_logger", "getLogger", "DEBUG", "INFO", "WARNING",
           "ERROR", "CRITICAL", "NOTSET"]

DEBUG = logging.DEBUG
INFO = logging.INFO
WARNING = logging.WARNING
ERROR = logging.ERROR
CRITICAL = logging.CRITICAL
NOTSET = logging.NOTSET

PY3 = True


class _Formatter(logging.Formatter):
    """Level-aware formatter; colors on TTY streams
    (ref log.py:37)."""

    _COLORS = {logging.WARNING: "\x1b[33m", logging.ERROR: "\x1b[31m",
               logging.CRITICAL: "\x1b[35m", logging.DEBUG: "\x1b[36m"}

    def __init__(self, colored=True):
        self.colored = colored
        super().__init__(datefmt="%m%d %H:%M:%S")

    def _label(self, level):
        if level == logging.WARNING:
            return "W"
        if level == logging.ERROR:
            return "E"
        if level == logging.CRITICAL:
            return "C"
        if level == logging.DEBUG:
            return "D"
        return "I"

    def format(self, record):
        label = self._label(record.levelno)
        fmt = label + "%(asctime)s %(process)d %(pathname)s:" \
            "%(funcName)s:%(lineno)d] %(message)s"
        if self.colored and record.levelno in self._COLORS:
            fmt = self._COLORS[record.levelno] + fmt + "\x1b[0m"
        self._style._fmt = fmt
        return super().format(record)


def getLogger(name=None, filename=None, filemode=None, level=WARNING):
    """(deprecated spelling kept for parity) — see get_logger."""
    return get_logger(name, filename, filemode, level)


def get_logger(name=None, filename=None, filemode=None, level=WARNING):
    """A logger configured with the framework formatter
    (ref log.py:90)."""
    logger = logging.getLogger(name)
    if name is not None and not getattr(logger, "_init_done", False):
        logger._init_done = True
        if filename:
            mode = filemode if filemode else "a"
            hdlr = logging.FileHandler(filename, mode)
            hdlr.setFormatter(_Formatter(colored=False))
        else:
            hdlr = logging.StreamHandler()
            hdlr.setFormatter(_Formatter(
                colored=getattr(sys.stderr, "isatty", lambda: False)()))
        logger.addHandler(hdlr)
    logger.setLevel(level)
    return logger
