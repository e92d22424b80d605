"""cProfile wrapper (copy of ``Profiler`` of ``openpifpaf_tpu/profiler.py``;
its JAX trace wrapper has no counterpart here yet, ROADMAP A13)."""

import cProfile
import io
import logging
import pstats

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
