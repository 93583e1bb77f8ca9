"""Learning-rate schedules (port of qpwcnet_tpu/train/schedules.py).

Each returns a callable from the step count to the learning rate, as the
optax schedules do; for ``torch.optim.lr_scheduler.LambdaLR``, which
multiplies the optimizer's base rate, divide it by that rate::

    sched = piecewise_halving_schedule(16)
    LambdaLR(opt, lambda step: sched(step) / 1e-4)

Both existed in the reference but were bypassed for a constant 1e-4;
provided for capability parity.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np


def piecewise_halving_schedule(batch_size: int, base_lr: float = 1e-4
                               ) -> Callable[[int], float]:
    """PiecewiseConstantDecay: halvings at 400k/600k/800k/1000k samples
    (x8), adjusted by batch size. As ``optax.piecewise_constant_schedule``,
    the rate is halved AT each boundary count (count >= boundary), in
    float32."""
    boundaries = [int(x * 8 / batch_size)
                  for x in (400_000, 600_000, 800_000, 1_000_000)]

    def schedule(count: int) -> float:
        lr = np.float32(base_lr)
        for b in boundaries:
            if count >= b:
                lr = np.float32(lr * np.float32(0.5))
        return float(lr)

    return schedule


def triangular2_cyclic_schedule(batch_size: int,
                                initial_learning_rate: float = 1e-4,
                                maximal_learning_rate: float = 5e-3,
                                step_size: float | None = None
                                ) -> Callable[[int], float]:
    """Triangular2 cyclical LR (tfa's Triangular2CyclicalLearningRate): a
    triangle wave between the initial and the maximal rate whose amplitude
    halves every full cycle. Computed in float32, as JAX's jnp arithmetic
    on an int32 count."""
    if step_size is None:
        step_size = 10e3 * (8 / batch_size)
    f32 = np.float32
    step, lo = f32(step_size), f32(initial_learning_rate)
    span = f32(maximal_learning_rate - initial_learning_rate)

    def schedule(count: int) -> float:
        c = f32(count)
        cycle = f32(math.floor(f32(1) + c / (f32(2) * step)))
        x = abs(c / step - f32(2) * cycle + f32(1))
        amp = span / f32(2.0) ** (cycle - f32(1))
        return float(lo + amp * max(f32(0), f32(1) - x))

    return schedule
