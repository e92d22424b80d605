"""Profiling wrappers (port of ``openpifpaf_tpu/profiler.py``).

``Profiler`` wraps a callable with cProfile and prints/dumps the tottime
ranking; ``TorchProfiler`` (the counterpart of ``JaxProfiler``) wraps it
with a ``torch.profiler`` session and writes a Chrome trace of every call.
"""

import cProfile
import io
import logging
import pstats

import torch

LOG = logging.getLogger(__name__)


class Profiler:
    def __init__(self, function_to_profile, *, profile=None, out_name=None):
        self.function_to_profile = function_to_profile
        self.profile = profile if profile is not None else cProfile.Profile()
        self.out_name = out_name

    def _report(self):
        buffer = io.StringIO()
        stats = pstats.Stats(self.profile, stream=buffer)
        stats.sort_stats('tottime').print_stats()
        if self.out_name:
            LOG.info('writing profile file %s', self.out_name)
            stats.dump_stats(self.out_name)
        print(buffer.getvalue())

    def __call__(self, *args, **kwargs):
        result = self.profile.runcall(self.function_to_profile,
                                      *args, **kwargs)
        self._report()
        return result


def _device_ops(prof):
    from torch.autograd import DeviceType
    return sum(e.device_type == DeviceType.CUDA for e in prof.events())


class TorchProfiler:
    """Trace-capture wrapper: writes ``<out_name>.<n>.json``, a Chrome
    trace of ``torch.profiler`` (CPU activities, and CUDA activities on a
    CUDA ``device``), for every wrapped call, the card synchronised before
    the trace closes.

    A process's first profiler session can miss the card's launches, so
    before the first traced call on the card one session profiles small
    ops until it records a device op. ``traces`` lists ``(path, device
    ops)`` of every call; a trace on the card with no device op is logged
    as such (device ops 0 then means "not recorded", not "none ran")."""

    trace_counter = 0
    _warm = False

    def __init__(self, function_to_profile, *, out_name='torch_trace',
                 device=None):
        self.function_to_profile = function_to_profile
        self.out_name = out_name
        if device is None:
            device = 'cuda' if torch.cuda.is_available() else 'cpu'
        self.cuda = torch.device(device).type == 'cuda'
        self.traces = []

    def _activities(self):
        from torch.profiler import ProfilerActivity
        return [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else [])

    def _warm_up(self):
        from torch.profiler import profile
        x = torch.ones(1024, device='cuda')
        for _ in range(5):
            with profile(activities=self._activities()) as prof:
                for _ in range(10):
                    x.add_(1)
                torch.cuda.synchronize()
            if _device_ops(prof):
                break
        TorchProfiler._warm = True

    def __call__(self, *args, **kwargs):
        from torch.profiler import profile

        if self.cuda and not TorchProfiler._warm:
            self._warm_up()
        self.__class__.trace_counter += 1
        path = f'{self.out_name}.{self.trace_counter}.json'
        with profile(activities=self._activities()) as prof:
            result = self.function_to_profile(*args, **kwargs)
            if self.cuda:
                torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        n_ops = _device_ops(prof)
        self.traces.append((path, n_ops))
        if self.cuda and not n_ops:
            LOG.warning('trace %s recorded no device op: the profiler '
                        'missed the card\'s launches', path)
        LOG.info('wrote trace to %s', path)
        return result
