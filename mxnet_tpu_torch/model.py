"""Model helpers: checkpoints and the optimizer wiring of ``Module``
(counterpart of ``mxnet_tpu/model.py``).

A single-file checkpoint is ``prefix-symbol.json`` plus
``prefix-%04d.params`` (``nd.save`` of ``arg:``/``aux:`` keys, written
to a temporary file and renamed). An epoch with a manifest
(``checkpoint.py``, the sharded format) loads through it, every file
checked against its SHA-256, so a torn write raises instead of loading.
Either package reads what the other writes.

The kvstore wiring of ``Module`` (reference: model.py:82-160):
:func:`_create_kvstore` decides the store and ``update_on_kvstore`` as
the JAX package does (no store for ``local`` on one device; a
``local`` store over more than 16M-element parameters updates on the
worker; ``MXNET_UPDATE_ON_KVSTORE`` overrides), and the update helpers
exchange gradients per key, or in size-capped buckets with
``MXNET_GRAD_OVERLAP=1`` (:func:`_bucketed_exchange`).
"""
from __future__ import annotations

import logging
import os
import re
from collections import namedtuple

import numpy as np

from .base import MXNetError
from . import ndarray as nd
from . import symbol as sym

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "load_params", "list_checkpoint_epochs",
           "load_latest_valid_checkpoint", "latest_checkpoint_scan"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """``(kvstore, update_on_kvstore)`` (reference: model.py:82)."""
    from . import envs
    from . import kvstore as kvs
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore \
                and "tpu" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(int(np.prod(arr.shape))
                               for arr in arg_params.values())
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        return None, False
    return kv, envs.get_bool("MXNET_UPDATE_ON_KVSTORE",
                             bool(update_on_kvstore))


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Each parameter's value into the store; with ``update_on_kvstore``
    the store's value back into the bound arrays (reference:
    model.py:121)."""
    for idx, param_on_devs in enumerate(param_arrays):
        name = param_names[idx]
        kvstore.init(name, arg_params[name])
        if update_on_kvstore:
            kvstore.pull(name, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore,
                              param_names):
    """Push each gradient (the store's optimizer updates its value) and
    pull the new weight back in place."""
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list is None or (isinstance(grad_list, list)
                                 and grad_list[0] is None):
            continue
        name = param_names[index]
        kvstore.push(name, grad_list, priority=-index)
        kvstore.pull(name, arg_list, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device=1,
                   kvstore=None, param_names=None):
    """``updater(index, grad, weight)`` for each parameter with a
    gradient, in order; with a kvstore the gradients are summed through
    it first (per key, or bucketed: :func:`_bucketed_exchange`)."""
    updates = [[] for _ in range(num_device)]
    bucketed = _bucketed_exchange(grad_arrays, kvstore)
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if not isinstance(arg_list, list):
            arg_list, grad_list = [arg_list], [grad_list]
        if grad_list[0] is None:
            continue
        if kvstore and not bucketed:
            name = param_names[index]
            kvstore.push(name, grad_list, priority=-index)
            kvstore.pull(name, grad_list, priority=-index)
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updates[k].append((index * num_device + k, g, w))
    for dev_updates in updates:
        for i, g, w in dev_updates:
            updater(i, g, w)


def _bucketed_exchange(grad_arrays, kvstore):
    """The ``MXNET_GRAD_OVERLAP=1`` gradient exchange: single-copy
    gradients go through the kvstore as size-capped concat buckets
    (``parallel.grad_sync.bucketed_kvstore_sync``: one push/pull a bucket
    instead of a key, exact because concatenation and the store's
    elementwise sum commute). True when the exchange ran; a roster of
    per-context copies returns False and keeps the per-key loop."""
    if not kvstore:
        return False
    from .parallel import grad_sync
    if not grad_sync.overlap_enabled():
        return False
    items = []
    for i, grad_list in enumerate(grad_arrays):
        if not isinstance(grad_list, list):
            grad_list = [grad_list]
        if grad_list[0] is None:
            continue
        if len(grad_list) != 1:
            return False
        items.append((i, grad_list[0]))
    return grad_sync.bucketed_kvstore_sync(kvstore, items)


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
