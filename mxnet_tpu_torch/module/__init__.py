"""Module API (counterpart of ``mxnet_tpu/module``). ``BucketingModule``,
``SequentialModule`` and ``PythonModule`` are not ported yet (ROADMAP
queue A item 10)."""
from .base_module import BaseModule
from .module import Module
