"""Contrib namespace (counterpart of ``mxnet_tpu/contrib``; reference:
python/mxnet/contrib/). Ported: :mod:`.quantization`, the int8 flow
behind ``deploy.export_compiled(quantize=True)``, and :mod:`.autograd`,
the legacy autograd shims. The JAX package's other contrib modules
(``text``, ``svrg_optimization``, ``onnx``, ``io``, ``tensorboard``)
wait for ROADMAP queue A's order step 8."""
from . import quantization  # noqa: F401
from . import autograd      # noqa: F401
