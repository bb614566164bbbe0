"""Pretrained model store (counterpart of
``mxnet_tpu/gluon/model_zoo/model_store.py``): serves only the
``.params`` files already under ``root`` and raises otherwise; nothing
is downloaded."""
from __future__ import annotations

import os

from ...base import MXNetError

__all__ = ["get_model_file", "purge"]


def get_model_file(name, root=os.path.join("~", ".mxnet", "models")):
    """The first ``<name>*.params`` file under ``root`` (sorted)."""
    root = os.path.expanduser(root)
    for fname in sorted(os.listdir(root)) if os.path.isdir(root) else []:
        if fname.startswith(name) and fname.endswith(".params"):
            return os.path.join(root, fname)
    raise MXNetError(
        "no pretrained weights for %r under %s, and nothing is downloaded: "
        "place the .params file there, or initialize the net and load "
        "weights with gluon.convert.params_from_numpy" % (name, root))


def purge(root=os.path.join("~", ".mxnet", "models")):
    """Remove the ``.params`` files under ``root``."""
    root = os.path.expanduser(root)
    if os.path.isdir(root):
        for fname in os.listdir(root):
            if fname.endswith(".params"):
                os.remove(os.path.join(root, fname))
