"""Command-line tools (counterpart of ``mxnet_tpu/tools``): the
launcher's worker contract (:mod:`.launch`), the telemetry report
(:mod:`.diagnose`), and the RecordIO packers :mod:`.im2rec` and
:mod:`.rec2idx`."""
