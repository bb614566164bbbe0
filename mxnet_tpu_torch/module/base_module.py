"""BaseModule — the canonical training loop (counterpart of
``mxnet_tpu/module/base_module.py``; the reference's ``fit`` is
base_module.py:409).

``fit`` consumes ``train_data`` through the async input pipeline
(``io/pipeline.py``) unless ``MXNET_DATA_PIPELINE=0``: a
``MXNET_DATA_WORKERS``-wide decode pool and a placer that copies each
batch to the bound executor's device on its own stream ahead of the
step, so decode and the host-to-device copy overlap the step and
``data_wait`` counts only stalls; the pipeline fit made is closed in
its ``finally``. ``checkpoint_prefix`` saves an epoch checkpoint every
``checkpoint_period`` epochs through ``checkpoint.CheckpointManager``
(the background writer unless ``MXNET_ASYNC_CHECKPOINT=0``), optimizer
state included; ``resume_from_checkpoint=True`` (or a prefix) scans the
prefix for the newest epoch whose files check out, loads its parameters
and optimizer state and continues from the next epoch, rolling past a
torn or corrupt epoch (``fault.note_resume``). The steps the
non-finite guard skipped are reported at the end.
"""
from __future__ import annotations

import logging
import time

import numpy as np

from .. import metric as _metric
from .. import ndarray as nd
from ..model import BatchEndParam
from ..initializer import Uniform

__all__ = ["BaseModule"]


def _check_input_names(symbol, names, typename, throw):
    args = symbol.list_arguments()
    for name in names:
        if name not in args:
            msg = "You created Module with Module(..., %s_names=%s) but " \
                "input with name '%s' is not found in " \
                "symbol.list_arguments()" % (typename, str(names), name)
            if throw:
                raise ValueError(msg)
            logging.warning(msg)


def _parse_data_desc(data_names, label_names, data_shapes, label_shapes):
    from ..io import DataDesc
    data_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                   for x in data_shapes]
    if label_shapes is not None:
        label_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                        for x in label_shapes]
    return data_shapes, label_shapes


def _output_pad(eval_batch, out, pad):
    """Rows to slice off one output for the batch's ``pad`` padded
    samples: ``pad`` for one row a sample, ``pad`` times the rows a
    sample when the output's leading dim is a multiple of the batch's
    (an LM head reshaped to ``(batch*positions, C)``); none on a
    time-major layout or an output not aligned to the batch's rows."""
    if not pad:
        return 0
    data = getattr(eval_batch, "data", None)
    if not data:
        return pad
    provide = getattr(eval_batch, "provide_data", None)
    layout = getattr(provide[0], "layout", None) if provide else None
    if layout and layout.find("N") > 0:
        return 0
    rows = data[0].shape[0]
    if out.shape[0] == rows:
        return pad
    if rows and out.shape[0] % rows == 0:
        return pad * (out.shape[0] // rows)
    return 0


def _as_list(obj):
    return obj if isinstance(obj, (list, tuple)) else [obj]


class BaseModule:
    """Base of all modules (reference: base_module.py:64)."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- high level API --------------------------------------------------
    def forward_backward(self, data_batch):
        """One training forward and its backward (reference:
        base_module.py:193)."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        """``eval_metric`` over ``eval_data`` in predict mode, as
        ``[(name, value)]``."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for callback in _as_list(batch_end_callback):
                    callback(params)
            actual_num_batch += 1
        if score_end_callback:
            params = BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                   eval_metric=eval_metric, locals=locals())
            for callback in _as_list(score_end_callback):
                callback(params)
        return eval_metric.get_name_value()

    def _batch_outputs(self, eval_batch, copy):
        """This batch's outputs without the rows of its padded samples."""
        pad = eval_batch.pad or 0
        outs = []
        for out in self.get_outputs():
            out = out[0:out.shape[0] - _output_pad(eval_batch, out, pad)]
            outs.append(out.copy() if copy else out)
        return outs

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield ``(outputs, nbatch, batch)`` for each batch."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            yield (self._batch_outputs(eval_batch, False), nbatch,
                   eval_batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False,
                sparse_row_id_fn=None):
        """The outputs over ``eval_data`` (an iterator, or an array as
        one batch), concatenated over the batches unless
        ``merge_batches`` is False."""
        assert self.binded and self.params_initialized
        from ..io import NDArrayIter
        if isinstance(eval_data, (nd.NDArray, np.ndarray)):
            if isinstance(eval_data, np.ndarray):
                eval_data = nd.array(eval_data)
            eval_data = NDArrayIter(eval_data,
                                    batch_size=eval_data.shape[0])
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            output_list.append(self._batch_outputs(eval_batch, True))
        if not output_list or not merge_batches:
            return output_list
        num_outputs = len(output_list[0])
        for out in output_list:
            assert len(out) == num_outputs, \
                "Cannot merge batches, as num of outputs is not the same " \
                "in mini-batches. Maybe bucketing is used?"
        merged = [nd.concatenate([out[i] for out in output_list])
                  for i in range(num_outputs)]
        if num_outputs == 1 and not always_output_list:
            return merged[0]
        return merged

    def _resume_point(self, resume_from_checkpoint, checkpoint_prefix):
        """fit's resume: the newest epoch under the prefix whose files
        load cleanly (torn or corrupt ones are skipped with a warning),
        as ``(next_epoch, arg_params, aux_params)``; None when nothing
        usable exists."""
        from ..model import latest_checkpoint_scan
        from .. import fault
        prefix = resume_from_checkpoint \
            if isinstance(resume_from_checkpoint, str) else checkpoint_prefix
        if not prefix:
            raise ValueError(
                'resume_from_checkpoint needs a prefix: pass '
                'checkpoint_prefix=... or resume_from_checkpoint="<prefix>"')
        found = latest_checkpoint_scan(prefix)
        if found is None:
            self.logger.info("fit: no usable checkpoint under %s; starting "
                             "fresh", prefix)
            return None
        epoch, args, auxs, skipped = found
        self._stage_resume_opt_states("%s-%04d.states" % (prefix, epoch))
        fault.note_resume(epoch, skipped_epochs=skipped)
        if skipped:
            self.logger.warning("fit: rolled back past %d corrupt newer "
                                "epoch(s); their steps are lost work "
                                "(fault.stats())", skipped)
        self.logger.info("fit: resuming from checkpoint %s-%04d.params at "
                         "epoch %d", prefix, epoch, epoch + 1)
        return (epoch + 1, args, auxs)

    def _stage_resume_opt_states(self, states_file):
        """Stage the epoch's optimizer-state file for ``init_optimizer``;
        a missing or corrupt file downgrades to a params-only resume,
        with a warning."""
        import os
        from ..optimizer._pickle import loads
        if not hasattr(self, "_preload_opt_states") \
                or not os.path.isfile(states_file):
            return
        try:
            with open(states_file, "rb") as src:
                loads(src.read())
        except Exception as exc:                   # noqa: BLE001
            self.logger.warning("fit: optimizer states %s are corrupt "
                                "(%s: %s); resuming with params only",
                                states_file, type(exc).__name__, exc)
            return
        self._preload_opt_states = states_file

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None, checkpoint_prefix=None,
            resume_from_checkpoint=False, checkpoint_period=1):
        """The canonical training loop (reference: base_module.py:409):
        bind, initialize, then per batch ``forward_backward``,
        ``update``, ``update_metric`` and the callbacks; per epoch the
        metric's log, the epoch-end callbacks and ``score`` on
        ``eval_data``. With a telemetry run (``MXNET_TELEMETRY``/
        ``MXNET_TELEMETRY_FILE``, or one already started) each batch is
        a step record with its data_wait, compute and optimizer
        phases. ``checkpoint_prefix``/``resume_from_checkpoint``/
        ``checkpoint_period``: see the module docstring."""
        from .. import fault, telemetry
        assert num_epoch is not None, "please specify number of epochs"
        owns_telemetry = telemetry.maybe_start(
            meta={"source": "Module.fit", "begin_epoch": begin_epoch,
                  "num_epoch": num_epoch})
        # stats are process-global: report only this fit's guard skips
        skipped_at_entry = fault.stats()["skipped_steps"] \
            if fault.is_enabled() else 0
        batch_samples = getattr(train_data, "batch_size", None) or None
        ckpt_mgr = None
        owned_pipeline = None
        try:
            if resume_from_checkpoint:
                resumed = self._resume_point(resume_from_checkpoint,
                                             checkpoint_prefix)
                if resumed is not None:
                    resume_epoch, arg_params, aux_params = resumed
                    begin_epoch = max(begin_epoch, resume_epoch)
                    force_init = True
            self.bind(data_shapes=train_data.provide_data,
                      label_shapes=train_data.provide_label,
                      for_training=True, force_rebind=force_rebind)
            if monitor is not None:
                self.install_monitor(monitor)
            self.init_params(initializer=initializer, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init)
            self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                optimizer_params=optimizer_params)
            if validation_metric is None:
                validation_metric = eval_metric
            if not isinstance(eval_metric, _metric.EvalMetric):
                eval_metric = _metric.create(eval_metric)
            fit_data, owned_pipeline = self._wrap_train_data(train_data)

            from ..parallel import multihost
            for epoch in range(begin_epoch, num_epoch):
                tic = time.time()
                eval_metric.reset()
                nbatch = 0
                data_iter = iter(fit_data)
                end_of_batch = False
                with telemetry.span("data_wait"):
                    next_data_batch = next(data_iter)
                while not end_of_batch:
                    data_batch = next_data_batch
                    # the proc_exit fault site and the surfacing of a
                    # peer loss (no-op single-process without a plan)
                    multihost.step_boundary()
                    telemetry.step_begin()
                    if monitor is not None:
                        monitor.tic()
                    with telemetry.span("compute"):
                        self.forward_backward(data_batch)
                    self.update()          # spans "optimizer" itself
                    self.update_metric(eval_metric, data_batch.label)
                    try:
                        with telemetry.span("data_wait"):
                            next_data_batch = next(data_iter)
                        self.prepare(next_data_batch,
                                     sparse_row_id_fn=sparse_row_id_fn)
                    except StopIteration:
                        end_of_batch = True
                    if monitor is not None:
                        monitor.toc_print()
                    if end_of_batch:
                        eval_name_vals = eval_metric.get_name_value()
                    # close the step before the callbacks, so the
                    # Speedometer reads a ring that holds this batch
                    telemetry.step_end(samples=batch_samples)
                    if batch_end_callback is not None:
                        params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                               eval_metric=eval_metric,
                                               locals=locals())
                        for callback in _as_list(batch_end_callback):
                            callback(params)
                    nbatch += 1

                for name, val in eval_name_vals:
                    self.logger.info("Epoch[%d] Train-%s=%f", epoch, name,
                                     val)
                self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                                 time.time() - tic)
                arg_params, aux_params = self.get_params()
                self.set_params(arg_params, aux_params)
                if checkpoint_prefix is not None and \
                        (epoch + 1) % max(checkpoint_period, 1) == 0:
                    if ckpt_mgr is None:
                        from ..checkpoint import CheckpointManager
                        ckpt_mgr = CheckpointManager(
                            checkpoint_prefix, symbol=self.symbol,
                            logger=self.logger)
                    to_bytes = getattr(self, "_optimizer_state_bytes", None)
                    states = to_bytes() if to_bytes is not None else None
                    ckpt_mgr.save(epoch, arg_params, aux_params,
                                  states_bytes=states)
                if epoch_end_callback is not None:
                    for callback in _as_list(epoch_end_callback):
                        callback(epoch, self.symbol, arg_params, aux_params)
                if eval_data is not None:
                    with telemetry.span("eval"):
                        res = self.score(
                            eval_data, validation_metric,
                            score_end_callback=eval_end_callback,
                            batch_end_callback=eval_batch_end_callback,
                            epoch=epoch)
                    for name, val in res:
                        self.logger.info("Epoch[%d] Validation-%s=%f",
                                         epoch, name, val)
                fit_data.reset()
            if fault.is_enabled():
                skipped = fault.stats()["skipped_steps"] - skipped_at_entry
                if skipped:
                    self.logger.warning(
                        "fit: %d optimizer step(s) skipped by the "
                        "non-finite gradient guard (fault.stats())",
                        skipped)
        finally:
            if ckpt_mgr is not None:
                # drain in-flight saves: a resume scan right after fit()
                # sees the final epoch
                ckpt_mgr.close()
            if owned_pipeline is not None:
                owned_pipeline.close()
            if owns_telemetry:
                telemetry.stop()

    def _wrap_train_data(self, train_data):
        """``(iterator, owned pipeline)``: ``train_data`` wrapped in the
        async input pipeline, placing batches as the bound executor's
        arrays lie (``placement_for_module``); fit closes a pipeline it
        made. An iterator that is already a pipeline adopts that
        placement; anything that is not a ``DataIter``, and every
        iterator under ``MXNET_DATA_PIPELINE=0``, passes through."""
        from ..io.io import DataIter, PrefetchingIter
        from ..io.pipeline import (AsyncInputPipeline, pipeline_enabled,
                                   placement_for_module)
        if not pipeline_enabled():
            return train_data, None
        if isinstance(train_data, (AsyncInputPipeline, PrefetchingIter)):
            placement = placement_for_module(self)
            if placement is not None:
                train_data.set_placement(placement)
            return train_data, None
        if not isinstance(train_data, DataIter):
            return train_data, None
        pipeline = AsyncInputPipeline(
            train_data, placement=placement_for_module(self))
        return pipeline, pipeline

    # -- symbol / params -------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        raise NotImplementedError()

    @property
    def output_names(self):
        raise NotImplementedError()

    @property
    def data_shapes(self):
        raise NotImplementedError()

    @property
    def label_shapes(self):
        raise NotImplementedError()

    @property
    def output_shapes(self):
        raise NotImplementedError()

    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def save_params(self, fname):
        """``arg:``/``aux:`` entries in one ``nd.save`` file."""
        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
        nd.save(fname, save_dict)

    def load_params(self, fname):
        arg_params, aux_params = {}, {}
        for k, value in nd.load(fname).items():
            arg_type, name = k.split(":", 1)
            if arg_type == "arg":
                arg_params[name] = value
            elif arg_type == "aux":
                aux_params[name] = value
            else:
                raise ValueError("Invalid param file " + fname)
        self.set_params(arg_params, aux_params)

    def install_monitor(self, mon):
        raise NotImplementedError()

    def prepare(self, data_batch, sparse_row_id_fn=None):
        pass

    # -- computation interface -------------------------------------------
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()
