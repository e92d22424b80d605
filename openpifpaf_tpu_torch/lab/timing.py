"""Device time per call: by the slope of two chains of back-to-back calls
(the CUDA counterpart of ``bench.py::time_op``), and from
``torch.profiler`` for the kernels alone."""


import numpy as np
import torch


def time_op(fn, n_lo=4, n_hi=16, repeats=5):
    """Seconds of device time per call of ``fn`` (no arguments) on the
    current CUDA device.

    Each repeat times ``n_lo`` and then ``n_hi`` back-to-back calls with
    CUDA events; the slope between the two removes the fixed cost of a
    chain, and the median of the ``repeats`` slopes is returned (a spike in
    one chain skews its slope high and its neighbour's low, so not the
    minimum). Raises without a CUDA device: there is nothing to time.
    """
    if not torch.cuda.is_available():
        raise RuntimeError('time_op times CUDA work and needs a CUDA device')

    def chain(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    fn()  # build, load and warm
    torch.cuda.synchronize()
    slopes = []
    for _ in range(repeats):
        t_lo = chain(n_lo)
        t_hi = chain(n_hi)
        slopes.append((t_hi - t_lo) / (n_hi - n_lo))
    return max(float(np.median(slopes)), 1e-9)


def device_ms(fn, n, kernel=None, between=None, warmup=3):
    """Milliseconds of device time per call of ``fn`` (no arguments) from
    ``torch.profiler``: ``warmup`` calls, then one session of ``n`` calls.
    It counts the kernels whose name holds ``kernel`` (one per call), or
    every device op of the calls when ``kernel`` is None. ``between``, when
    given, runs before each call and its ops are not counted (it must
    launch no kernel named ``kernel``; with ``kernel`` None it is not
    allowed). The profiler can miss the first launches of a session: the
    mean is over the last calls whose ops were recorded, None when that is
    fewer than half of ``n``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError('device_ms times CUDA work and needs a CUDA '
                           'device')
    if kernel is None and between is not None:
        raise ValueError('device_ms: between needs a kernel name')
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            if between is not None:
                between()
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and (kernel is None or kernel in e.name)),
                    key=lambda e: e.time_range.start)
    per_call = 1 if kernel is not None else max(1, round(len(events) / n))
    calls = min(n, len(events) // per_call)
    if calls < max(1, n // 2):
        return None
    events = events[-calls * per_call:]
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / calls
