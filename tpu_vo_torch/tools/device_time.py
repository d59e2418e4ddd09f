"""Device time of one call on the card (port of tools/device_time.py).

device_time_ms times `reps` calls of fn(*args) between two CUDA events,
`iters` times after `warmup` calls, and returns the median of the
`iters` times divided by `reps`. The JAX harness runs the op inside one
lax.fori_loop with a scalar carry threaded through every iteration, so
that XLA can neither hoist the op out of the loop nor drop it as dead
code; eager PyTorch launches every call it is given, so no carry is
needed and none is added.
"""

from __future__ import annotations

from tpu_vo_torch.utils.profiling import cuda_times


def device_time_ms(fn, *args, reps: int = 32, iters: int = 5,
                   warmup: int = 2) -> float:
    """Median over `iters` of the CUDA-event time of `reps` calls of
    fn(*args), divided by `reps`, in ms."""
    times = cuda_times(lambda: fn(*args), warmup=warmup, reps=iters, iters=reps)
    return sorted(times)[len(times) // 2]


def overhead_ms(example, reps: int = 32) -> float:
    """Timing floor: a call that launches nothing, on `example`."""
    return device_time_ms(lambda x: x, example, reps=reps)
