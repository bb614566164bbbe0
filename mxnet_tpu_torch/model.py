"""Model helpers: checkpoints and the optimizer wiring of ``Module``
(counterpart of ``mxnet_tpu/model.py``).

A single-file checkpoint is ``prefix-symbol.json`` plus
``prefix-%04d.params`` (``nd.save`` of ``arg:``/``aux:`` keys, written
to a temporary file and renamed). An epoch with a manifest
(``checkpoint.py``, the sharded format) loads through it, every file
checked against its SHA-256, so a torn write raises instead of loading.
Either package reads what the other writes.

On one device with ``kvstore='local'`` there is no kvstore, as in the
JAX package: the optimizer updates each parameter in place. Any store
that would be created raises (ROADMAP queue A item 12).
"""
from __future__ import annotations

import logging
import os
import re
from collections import namedtuple

from .base import MXNetError
from . import ndarray as nd
from . import symbol as sym

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "load_params", "list_checkpoint_epochs",
           "load_latest_valid_checkpoint", "latest_checkpoint_scan"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """``(kvstore, update_on_kvstore)``: ``(None, False)`` for no store,
    or ``'local'`` on one device (reference: model.py:82)."""
    if kvstore is None or (isinstance(kvstore, str) and num_device == 1
                           and "dist" not in kvstore):
        return None, False
    raise NotImplementedError(
        "kvstore %r over %d device(s) needs kvstore.py, not ported yet "
        "(ROADMAP queue A item 12)" % (kvstore, num_device))


def _update_params(param_arrays, grad_arrays, updater, num_device=1,
                   kvstore=None, param_names=None):
    """``updater(index, grad, weight)`` for each parameter with a
    gradient, in order (the per-parameter loop)."""
    if kvstore is not None:
        raise NotImplementedError("kvstore updates are not ported yet "
                                  "(ROADMAP queue A item 12)")
    for index, (weight, grad) in enumerate(zip(param_arrays, grad_arrays)):
        if grad is not None:
            updater(index, grad, weight)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Write ``prefix-symbol.json`` and ``prefix-%04d.params``
    (reference: model.py:394)."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    nd.save("%s-%04d.params" % (prefix, epoch), save_dict)


def load_params(prefix, epoch):
    """``(arg_params, aux_params)`` of one epoch: from its manifest when
    it has one (checksummed; a torn file raises), else from the single
    file."""
    from . import checkpoint as ckpt
    if ckpt.load_manifest(prefix, epoch) is not None:
        save_dict = ckpt.load_arrays(prefix, epoch)
    else:
        save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
        if any(ckpt._PIECE_SEP in k for k in save_dict):
            # a sharded save whose manifest never landed: loading shard
            # 0 alone would silently drop parameters
            raise MXNetError(
                "checkpoint %s-%04d.params holds shard pieces but no "
                "manifest (torn sharded save)" % (prefix, epoch))
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` (reference: model.py:424)."""
    symbol = sym.load("%s-symbol.json" % prefix)
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params


def list_checkpoint_epochs(prefix):
    """Epochs with a ``prefix-%04d.params`` file on disk, ascending."""
    directory = os.path.dirname(prefix) or "."
    pat = re.compile(re.escape(os.path.basename(prefix)) + r"-(\d+)\.params$")
    if not os.path.isdir(directory):
        return []
    return sorted({int(m.group(1)) for f in os.listdir(directory)
                   for m in [pat.match(f)] if m})


def _validate_sibling_states(prefix, epoch):
    """A corrupt optimizer-state sibling rejects its epoch (resuming with
    fresh optimizer state is a different trajectory, not a resume). A
    missing one is fine. A manifest epoch checksums its states file in
    the load itself; a single-file epoch's is parsed here."""
    from . import checkpoint as ckpt
    from .optimizer._pickle import loads
    if ckpt.load_manifest(prefix, epoch) is not None:
        return
    states_file = "%s-%04d.states" % (prefix, epoch)
    if not os.path.isfile(states_file):
        return
    with open(states_file, "rb") as src:
        loads(src.read())


def latest_checkpoint_scan(prefix):
    """``(epoch, arg_params, aux_params, skipped_epochs)`` of the newest
    epoch under ``prefix`` that loads cleanly; ``skipped_epochs`` counts
    the newer epochs rejected as torn or corrupt (their steps are lost
    work). None when nothing usable exists."""
    epochs = list_checkpoint_epochs(prefix)
    for pos, epoch in enumerate(reversed(epochs)):
        try:
            _validate_sibling_states(prefix, epoch)
            arg_params, aux_params = load_params(prefix, epoch)
            return (epoch, arg_params, aux_params, pos)
        except Exception as exc:                   # noqa: BLE001
            logging.warning("skipping corrupt/partial checkpoint %s-%04d "
                            "(%s: %s)", prefix, epoch, type(exc).__name__,
                            exc)
    return None


def load_latest_valid_checkpoint(prefix):
    """``(epoch, arg_params, aux_params)`` of the newest epoch under
    ``prefix`` that loads cleanly, its optimizer-state sibling included;
    a torn or partial epoch is skipped with a warning. None when nothing
    usable exists."""
    found = latest_checkpoint_scan(prefix)
    return None if found is None else found[:3]
