"""Learning-rate schedules (counterpart of ``mxnet_tpu/lr_scheduler.py``).

Every schedule is a pure function of the update count, ``lr =
schedule(t)``, recomputed from the constructor arguments (the reference
mutates internal counters instead): a schedule replays identically after
a restore and can be evaluated out of order.
"""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    """Base: holds the peak lr and the warmup ramp.

    Subclasses implement :meth:`_decayed_lr`, the post-warmup schedule
    as a pure function of the update count.
    """

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode='linear'):
        if warmup_begin_lr > base_lr:
            raise ValueError(
                "warmup must ramp up: warmup_begin_lr %s exceeds base_lr %s"
                % (warmup_begin_lr, base_lr))
        if warmup_steps < 0:
            raise ValueError("warmup_steps must be >= 0")
        if warmup_mode not in ('linear', 'constant'):
            raise ValueError(
                "warmup_mode must be 'linear' or 'constant', got %r"
                % (warmup_mode,))
        self.base_lr, self.warmup_final_lr = base_lr, base_lr
        self.warmup_steps, self.warmup_mode = warmup_steps, warmup_mode
        self.warmup_begin_lr = warmup_begin_lr

    # -- warmup ramp ------------------------------------------------------
    def get_warmup_lr(self, num_update):
        assert num_update < self.warmup_steps
        if self.warmup_mode == 'constant':
            return self.warmup_begin_lr
        frac = num_update / self.warmup_steps
        return self.warmup_begin_lr + \
            frac * (self.warmup_final_lr - self.warmup_begin_lr)

    # -- schedule protocol ------------------------------------------------
    def _decayed_lr(self, num_update):
        raise NotImplementedError(
            "%s must implement _decayed_lr" % type(self).__name__)

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        return self._decayed_lr(num_update)


class FactorScheduler(LRScheduler):
    """Multiply by ``factor`` once per ``step`` updates, floored at
    ``stop_factor_lr`` (reference: lr_scheduler.py:83)."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8,
                 base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode='linear'):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise ValueError("step must be >= 1, got %s" % (step,))
        if factor > 1.0:
            raise ValueError(
                "factor %s > 1 would grow the lr; use <= 1" % (factor,))
        self.step, self.factor = step, factor
        self.stop_factor_lr = stop_factor_lr

    def _decayed_lr(self, num_update):
        n_decays = max(0, (num_update - 1) // self.step)
        lr = self.base_lr * self.factor ** n_decays
        return max(lr, self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """Multiply by ``factor`` as each milestone in ``step`` is passed
    (reference: lr_scheduler.py:131)."""

    def __init__(self, step, factor=1, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode='linear'):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list of milestones")
        prev = 0
        for s in step:
            if s < 1:
                raise ValueError("milestones must be >= 1, got %s" % (s,))
            if s <= prev:
                raise ValueError(
                    "milestones must strictly increase, got %s" % (step,))
            prev = s
        self.step, self.factor = step, factor

    def _decayed_lr(self, num_update):
        n_passed = sum(1 for s in self.step if num_update > s)
        return self.base_lr * self.factor ** n_passed


class _RampDown(LRScheduler):
    """Shared shape for schedules that descend from base_lr to final_lr
    over ``max_update`` steps and then hold."""

    def __init__(self, max_update, base_lr, final_lr, warmup_steps,
                 warmup_begin_lr, warmup_mode):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(max_update, int) or max_update < 1:
            raise ValueError(
                "max_update must be a positive int, got %r" % (max_update,))
        if warmup_steps >= max_update:
            raise ValueError(
                "warmup_steps (%d) must be < max_update (%d): the decay "
                "would have zero or negative span"
                % (warmup_steps, max_update))
        self.max_update, self.final_lr = max_update, final_lr
        self.max_steps = max_update - warmup_steps

    def _progress(self, num_update):
        """Fraction of the decay completed, clamped to [0, 1]."""
        done = (num_update - self.warmup_steps) / self.max_steps
        return min(max(done, 0.0), 1.0)

    def _shape(self, progress):
        raise NotImplementedError

    def _decayed_lr(self, num_update):
        span = self.base_lr - self.final_lr
        return self.final_lr + span * self._shape(self._progress(num_update))


class PolyScheduler(_RampDown):
    """Polynomial decay: lr follows (1 - t)^pwr
    (reference: lr_scheduler.py:178)."""

    def __init__(self, max_update, base_lr=0.01, pwr=2,
                 final_lr=0, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode='linear'):
        super().__init__(max_update, base_lr, final_lr, warmup_steps,
                         warmup_begin_lr, warmup_mode)
        self.power = pwr

    def _shape(self, progress):
        return (1.0 - progress) ** self.power


class CosineScheduler(_RampDown):
    """Half-cosine decay (reference: lr_scheduler.py:223)."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode='linear'):
        super().__init__(max_update, base_lr, final_lr, warmup_steps,
                         warmup_begin_lr, warmup_mode)

    def _shape(self, progress):
        return 0.5 * (1.0 + math.cos(math.pi * progress))
