"""Contrib namespace (counterpart of ``mxnet_tpu/contrib``; reference:
python/mxnet/contrib/): the int8 flow behind
``deploy.export_compiled(quantize=True)`` (:mod:`.quantization`), text
vocabularies and embeddings (:mod:`.text`), SVRG (:mod:`.svrg_optimization`),
ONNX graph interop (:mod:`.onnx`), a DataLoader as a DataIter
(:mod:`.io`), the legacy autograd shims (:mod:`.autograd`) and
TensorBoard logging (:mod:`.tensorboard`)."""
from . import quantization       # noqa: F401
from . import text               # noqa: F401
from . import svrg_optimization  # noqa: F401
from . import onnx               # noqa: F401
from . import io                 # noqa: F401
from . import autograd           # noqa: F401
from . import tensorboard        # noqa: F401

# the reference's legacy alias
onnx_export = onnx.export_model
