"""Monitor: per-array statistics while training (counterpart of
``mxnet_tpu/monitor.py``; reference: python/mxnet/monitor.py), over the
executor's ``set_monitor_callback``.

Installed on an executor (``install``, or ``Module.install_monitor``),
it taps each forward's outputs, or with ``monitor_all`` every op's
output (the plan then runs op by op, and a Module's step falls back from
the fused step to the eager one, counted in ``fused_step_fallbacks``);
``toc`` adds the arguments. A control-flow node is one op here: its
outputs are tapped, not its subgraph's."""
from __future__ import annotations

import logging
import re
from math import sqrt

from .ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    def __init__(self, interval, stat_func=None, pattern='.*', sort=False,
                 monitor_all=False):
        self._monitor_all = monitor_all
        if stat_func is None:
            def asum_stat(x):
                return x.norm() / sqrt(x.size)
            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

        def stat_helper(name, arr):
            if not self.activated or not self.re_prog.match(name):
                return
            self.queue.append((self.step, name, self.stat_func(arr)))
        self.stat_helper = stat_helper

    def install(self, exe, monitor_all=None):
        """Attach to an executor; with ``monitor_all`` (here or on the
        constructor) every op's output is tapped."""
        if monitor_all is None:
            monitor_all = self._monitor_all
        exe.set_monitor_callback(self.stat_helper, monitor_all)
        self.exes.append(exe)

    def tic(self):
        if self.step % self.interval == 0:
            for exe in self.exes:
                for array in exe.arg_arrays:
                    array.wait_to_read()
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        if not self.activated:
            return []
        for exe in self.exes:
            for array in exe.arg_arrays:
                array.wait_to_read()
        for exe in self.exes:
            for name, array in zip(exe.arg_names, exe.arg_arrays):
                if self.re_prog.match(name):
                    self.queue.append((self.step, name,
                                       self.stat_func(array)))
        self.activated = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        for n, k, v_list in self.queue:
            if isinstance(v_list, NDArray):
                v_list = [v_list]
            assert isinstance(v_list, list)
            s = ''
            for v in v_list:
                assert isinstance(v, NDArray)
                if v.shape == (1,) or v.shape == ():
                    s += str(v.asscalar()) + '\t'
                else:
                    s += str(v.asnumpy()) + '\t'
            res.append((n, k, s))
        self.queue = []
        return res

    def toc_print(self):
        res = self.toc()
        for n, k, v in res:
            logging.info('Batch: {:7d} {:30s} {:s}'.format(n, k, v))
