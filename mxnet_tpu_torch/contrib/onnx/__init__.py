"""ONNX interop (parity: python/mxnet/contrib/onnx/).

The converter layer (Symbol JSON <-> plain-dict graph IR) runs without
the onnx package; only reading/writing actual .onnx protos is gated on
``import onnx``.
"""
from .mx2onnx import (symbol_to_onnx_ir, ir_to_onnx, export_model,
                      register_converter)
from .onnx2mx import ir_to_symbol, onnx_to_ir, import_model

__all__ = ["symbol_to_onnx_ir", "ir_to_onnx", "export_model",
           "register_converter", "ir_to_symbol", "onnx_to_ir",
           "import_model"]
