"""The launcher's worker contract (counterpart of ``worker_contract`` in
``mxnet_tpu/tools/launch.py``). Spawning and supervising a worker set
waits for the port's ``torch.distributed`` slice (``ROADMAP.md`` queue
A item 12)."""
from __future__ import annotations

import os

__all__ = ["worker_contract"]


def worker_contract():
    """This process's launcher worker contract, or ``None`` outside a
    launched worker set: ``{"rank", "world", "uri", "port"}`` read
    from the DMLC_* environment the launcher sets. Serving workers use
    it to name their router replica ``replica-<rank>``."""
    if os.environ.get("DMLC_ROLE") != "worker":
        return None
    try:
        return {"rank": int(os.environ["DMLC_WORKER_ID"]),
                "world": int(os.environ["DMLC_NUM_WORKER"]),
                "uri": os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1"),
                "port": int(os.environ.get("DMLC_PS_ROOT_PORT", 0))}
    except (KeyError, ValueError):
        return None
