"""IO namespace (counterpart of ``mxnet_tpu/io``): the batch types and
the in-memory iterator. The record readers and the async input pipeline
(``io/pipeline.py``) are not ported yet (ROADMAP queue A item 10)."""
from .io import DataDesc, DataBatch, DataIter, NDArrayIter
