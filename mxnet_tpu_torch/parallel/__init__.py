"""Parallel and attention kernels (counterpart of ``mxnet_tpu/parallel``):
the flash-attention kernels (:mod:`~mxnet_tpu_torch.parallel.
flash_attention`), the process group (:mod:`~mxnet_tpu_torch.parallel.
distributed`), the contexts-to-devices rule (:mod:`~mxnet_tpu_torch.
parallel.mesh`) and the bucketed gradient exchange
(:mod:`~mxnet_tpu_torch.parallel.grad_sync`)."""
