"""Logging setup (port of ``openpifpaf_tpu/logger.py``): JSON-lines train
log file + console logging with --quiet/--debug, and the build directory
of the port's libraries (``--xla-compilation-cache``,
:mod:`.compile_cache`)."""

import argparse
import json
import logging
import sys


class JsonFormatter(logging.Formatter):
    def format(self, record):
        payload = record.msg
        if not isinstance(payload, dict):
            payload = {'message': record.getMessage()}
        return json.dumps({
            'levelname': record.levelname,
            'name': record.name,
            # wall-clock stamp in the reference's format (the logs CLI
            # parses it for the time-per-epoch panels)
            'asctime': self.formatTime(record, '%Y-%m-%d %H:%M:%S')
            + ',{:03.0f}'.format(record.msecs),
            **payload,
        })


def cli(parser: argparse.ArgumentParser):
    group = parser.add_argument_group('logging')
    group.add_argument('-q', '--quiet', default=False, action='store_true')
    group.add_argument('--debug-log', dest='debug_logging',
                       default=False, action='store_true')
    group.add_argument('--log-stats', default=False, action='store_true')
    from . import compile_cache
    compile_cache.cli(parser)


def configure(args: argparse.Namespace, local_log=None):
    from . import compile_cache
    compile_cache.configure(args)

    level = logging.INFO
    if args.quiet:
        level = logging.WARNING
    if getattr(args, 'debug', False) or getattr(args, 'debug_logging', False):
        level = logging.DEBUG

    stream_handler = logging.StreamHandler(sys.stdout)
    stream_handler.setLevel(level)
    logging.basicConfig(level=level, handlers=[stream_handler])

    if getattr(args, 'output', None):
        root = logging.getLogger('')
        # a second run in the same process writes its own file only
        for handler in list(root.handlers):
            if isinstance(handler.formatter, JsonFormatter):
                root.removeHandler(handler)
                handler.close()
        file_handler = logging.FileHandler(args.output + '.log', mode='w')
        file_handler.setFormatter(JsonFormatter())
        file_handler.setLevel(logging.INFO)
        root.addHandler(file_handler)

    return local_log
