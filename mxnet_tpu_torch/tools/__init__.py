"""Command-line tools (counterpart of ``mxnet_tpu/tools``): the
launcher's worker contract (:mod:`.launch`), the telemetry report
(:mod:`.diagnose`), the RecordIO packers :mod:`.im2rec` and
:mod:`.rec2idx`, the kvstore probe (:mod:`.bandwidth`), training-log
tables (:mod:`.parse_log`), the flakiness checker
(:mod:`.flakiness_checker`) and the package's own lint (:mod:`.lint`)."""
