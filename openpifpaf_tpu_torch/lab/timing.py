"""Device time per call, by the slope of two chains of back-to-back calls
(the CUDA counterpart of ``bench.py::time_op``)."""

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
