"""Runtime feature detection (counterpart of ``mxnet_tpu/runtime.py``;
reference: python/mxnet/runtime.py and src/libinfo.cc). The features
are the JAX package's keys, valued for this build: torch's CUDA, cuDNN
and NCCL, no TPU, XLA or Pallas."""
from __future__ import annotations

__all__ = ["Features", "feature_list"]


class Feature:
    def __init__(self, name, enabled):
        self.name = name
        self.enabled = enabled

    def __repr__(self):
        return "%s %s" % ("✔" if self.enabled else "✖", self.name)


def _detect():
    import torch
    import torch.distributed as dist
    feats = {
        "TPU": False,
        "XLA": False,
        "PALLAS": False,
        "CUDA": torch.version.cuda is not None,
        "CUDNN": bool(torch.backends.cudnn.is_available()),
        "NCCL": bool(dist.is_available() and dist.is_nccl_available()),
        "TENSORRT": False,
        "MKLDNN": bool(torch.backends.mkldnn.is_available()),
        "OPENCV": _has("cv2"),
        "DIST_KVSTORE": bool(dist.is_available()),
        "INT64_TENSOR_SIZE": True,
        "SIGNAL_HANDLER": True,
        "F16C": True,
        "JAX_DISTRIBUTED": False,
    }
    return {k: Feature(k, v) for k, v in feats.items()}


def _has(mod):
    try:
        __import__(mod)
        return True
    except ImportError:
        return False


class Features(dict):
    def __init__(self):
        super().__init__(_detect())

    def is_enabled(self, name):
        return self[name.upper()].enabled


def feature_list():
    return list(Features().values())
