"""Module API (counterpart of ``mxnet_tpu/module``). ``BucketingModule``
is not ported yet (ROADMAP queue A item 10)."""
from .base_module import BaseModule
from .module import Module
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule
