"""Parallel and attention kernels (counterpart of ``mxnet_tpu/parallel``);
this slice ports the flash-attention kernels of the serving path
(:mod:`mxnet_tpu_torch.parallel.flash_attention`)."""
