"""IO namespace (counterpart of ``mxnet_tpu/io``): the batch types, the
iterators over memory, CSV and MNIST files and RecordIO images, and the
async input pipeline (``io/pipeline.py``), and ``LibSVMIter`` (csr
batches), with ``make_sharded_pipeline``: each rank of a ``dp`` mesh
gets its rows of every batch."""
from .io import (DataDesc, DataBatch, DataIter, ResizeIter, PrefetchingIter,
                 NDArrayIter, MNISTIter, CSVIter, LibSVMIter)
from .image_record import ImageRecordIter, ImageDetRecordIter
from .pipeline import (AsyncInputPipeline, data_workers, pipeline_enabled,
                       placement_for_module, make_sharded_pipeline,
                       place_batch)
