"""Command-line tools (counterpart of ``mxnet_tpu/tools``); this slice
ports the launcher's worker contract (:mod:`.launch`)."""
