"""DataLoader (counterpart of ``mxnet_tpu/gluon/data/dataloader.py``;
parity: python/mxnet/gluon/data/dataloader.py).

The reference forks worker processes and ships NDArrays back through
shared memory (dataloader.py:53-98). Here the workers are a thread pool,
as in the JAX package: decode and augmentation release the GIL in
numpy, cv2 and PIL, and the batches land in host memory.
``device_prefetch`` hands the batches to the async input pipeline's
placer (``io/pipeline.py``), which copies them to the card on its own
stream ahead of the training step; the workers then build the batches on
the host (``cpu()``), never on the card.
"""
from __future__ import annotations

import concurrent.futures as _futures

import numpy as np

from ... import ndarray as nd
from ...context import cpu, current_context
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch (reference: dataloader.py:127): NDArray
    samples where they lie, others on the current context."""
    if isinstance(data[0], nd.NDArray):
        return nd.stack(*data)
    if isinstance(data[0], tuple):
        return [default_batchify_fn(i) for i in zip(*data)]
    data = np.asarray(data)
    return nd.array(data, dtype=data.dtype)


class _GeneratorSource:
    """A generator as the ``next``/``reset`` source the pipeline drives;
    the loader's own pool sits behind the generator, so the pipeline
    adds only the placer."""

    batch_size = 0

    def __init__(self, gen):
        self._gen = gen

    def next(self):
        return next(self._gen)

    def reset(self):
        pass


class DataLoader:
    """Mini-batch loader over a Dataset (reference: dataloader.py:441).

    ``device_prefetch``: True for the current context's device, or a
    ``torch.device``, a context, or a ``(name, tensor) -> device``
    callable; batches arrive there, copied ahead of time by the input
    pipeline's placer."""

    def __init__(self, dataset, batch_size=None, shuffle=False,
                 sampler=None, last_batch=None, batch_sampler=None,
                 batchify_fn=None, num_workers=0, pin_memory=False,
                 pin_device_id=0, prefetch=None, thread_pool=True,
                 device_prefetch=None):
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._device_prefetch = device_prefetch

        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                if shuffle:
                    sampler = RandomSampler(len(dataset))
                else:
                    sampler = SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = BatchSampler(
                sampler, batch_size, last_batch if last_batch else 'keep')
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = num_workers if num_workers >= 0 else 0
        self._prefetch = max(0, int(prefetch) if prefetch is not None
                             else 2 * self._num_workers)
        if batchify_fn is None:
            batchify_fn = default_batchify_fn
        self._batchify_fn = batchify_fn

    def _make_batch(self, batch_indices, on_host):
        samples = [self._dataset[i] for i in batch_indices]
        if not on_host:
            return self._batchify_fn(samples)
        with cpu():
            return self._batchify_fn(samples)

    def _iter_batches(self, on_host):
        if self._num_workers == 0:
            for batch in self._batch_sampler:
                yield self._make_batch(batch, on_host)
            return
        with _futures.ThreadPoolExecutor(self._num_workers) as pool:
            pending = []
            it = iter(self._batch_sampler)
            try:
                for _ in range(self._prefetch or self._num_workers):
                    pending.append(pool.submit(self._make_batch, next(it),
                                               on_host))
            except StopIteration:
                pass
            while pending:
                fut = pending.pop(0)
                try:
                    pending.append(pool.submit(self._make_batch, next(it),
                                               on_host))
                except StopIteration:
                    pass
                yield fut.result()

    def _resolve_placement(self):
        target = self._device_prefetch
        if target is True:
            return current_context().torch_device()
        return target

    def __iter__(self):
        placement = self._resolve_placement()
        if placement is None or placement is False:
            yield from self._iter_batches(False)
            return
        from ...io.pipeline import AsyncInputPipeline
        gen = self._iter_batches(True)
        # floor of 1: the ready queue must hold a batch
        pipe = AsyncInputPipeline(_GeneratorSource(gen), num_workers=1,
                                  prefetch_depth=max(1, self._prefetch),
                                  placement=placement)
        try:
            while True:
                try:
                    yield pipe.next()
                except StopIteration:
                    return
        finally:
            pipe.close()
            try:
                gen.close()         # shuts the loader's worker pool
            except ValueError:      # still running in a wedged scheduler
                pass

    def __len__(self):
        return len(self._batch_sampler)
