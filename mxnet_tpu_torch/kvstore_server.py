"""KVStore server bootstrap, a retired role (counterpart of
``mxnet_tpu/kvstore_server.py``).

The reference's ``dist_*`` stores ran ps-lite server processes, which
this module started when ``DMLC_ROLE=server``. The port's dist stores
sum across workers with ``torch.distributed.all_reduce`` (``kvstore``),
so every process is a worker and there is nothing to serve. The module
keeps the API so reference launch scripts (``-s/--num-servers``,
``DMLC_ROLE=server``) run unchanged: a server role logs and returns.
"""
from __future__ import annotations

import logging
import os

__all__ = ["KVStoreServer"]


class KVStoreServer:
    """API-compatible server object (reference: kvstore_server.py:28)."""

    def __init__(self, kvstore):
        self.kvstore = kvstore

    def run(self):
        """The reference blocks here serving push/pull requests; with an
        all-reduce there is nothing to serve."""
        logging.info(
            "kvstore_server: dist stores sum with torch.distributed."
            "all_reduce; no server loop to run (the role is a no-op, "
            "workers carry the optimizer)")


def _init_kvstore_server_module():
    """What importing the package does under ``DMLC_ROLE=server``: log
    and return instead of blocking. A plain ``local`` store stands in
    for the server's: creating a dist one would join the workers'
    process group."""
    if os.environ.get("DMLC_ROLE", "") == "server":
        from .kvstore import create
        KVStoreServer(create("local")).run()


_init_kvstore_server_module()
