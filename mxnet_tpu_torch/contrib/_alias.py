"""The shared installer of the stripped ``_contrib_*`` op namespaces
(``mx.nd.contrib.box_nms`` is ``_contrib_box_nms``), as the reference's
generated contrib namespaces (counterpart of
``mxnet_tpu/contrib/_alias.py``). ``nd.contrib`` and ``sym.contrib``
install through it."""
from __future__ import annotations

from ..ndarray.contrib import install_contrib_ops

__all__ = ["install_contrib_ops"]
