"""Logs CLI: plot training log JSON-lines files and eval stats (port of
``openpifpaf_tpu/logs.py``; it reads the port's JSON-lines training log,
:mod:`.logger`, and the eval CLI's ``.stats.json`` files).

Reference surface (the reference's ``src/openpifpaf/logs.py``): wall-clock
and per-epoch time panels, learning rate, epoch loss (train/val), per-field
head-loss grids (epoch and batch level), data-preprocessing share, shaded
batch-loss curve, auto-tuned MTL sigma grids, AP-metric-over-epochs grids
from ``.eval-*.stats.json`` files, and AP-vs-GMACs / AP-vs-parameters
scatter panels. Each panel saves to ``<output-prefix><panel>.png`` (or
shows interactively with ``--show``). matplotlib is imported only by
the functions that draw, so ``--print-last`` runs where it is missing.
"""

import argparse
import datetime
import glob
import json
import logging
import re
from collections import defaultdict
from pprint import pprint

import numpy as np

from . import logger, show
from . import __version__

LOG = logging.getLogger(__name__)


def fractional_epoch(row, *, default=None):
    """Epoch 1 at batch 30 of 100 -> 1.3 (role of reference logs.py:40-52)."""
    if 'epoch' not in row:
        return default
    epoch = row.get('epoch')
    if 'batch' not in row:
        return epoch
    return epoch + row['batch'] / max(1, row.get('n_batches', 1))


def optionally_shaded(ax, x, y, *, color, label, **kwargs):
    """Bin dense batch series to ~30 points/epoch with a min-max shade
    (role of reference logs.py:24-37)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    epochs = x[-1] - x[0] if len(x) > 1 else 0.0
    stride = int(len(x) / epochs / 30.0) if len(x) > 30 and epochs > 0 else 1
    if stride <= 1:
        ax.plot(x, y, color=color, label=label, **kwargs)
        return

    # full bins only; a trailing partial bin is dropped
    n_bins = -(-len(x) // stride) - 1
    bins = y[:n_bins * stride].reshape(n_bins, stride)
    bin_x = x[:n_bins * stride:stride]
    ax.plot(bin_x, bins.mean(axis=1), color=color, label=label, **kwargs)
    ax.fill_between(bin_x, bins.min(axis=1), bins.max(axis=1),
                    alpha=0.2, facecolor=color)


def _color(i):
    import matplotlib
    return matplotlib.colormaps['tab10']((i % 10 + 0.05) / 10)


def _parse_asctime(row):
    t = row.get('asctime')
    if not t:
        return None
    return datetime.datetime.strptime(t[:19], '%Y-%m-%d %H:%M:%S')


class Plots:
    """Training-log panels (reference logs.py:55-386)."""

    def __init__(self, log_files, labels=None, *, output_prefix=None,
                 first_epoch=1e-6, share_y=True, show_plots=False):
        self.log_files = log_files
        self.labels = labels or self.labels_from_filenames(log_files)
        self.output_prefix = output_prefix or log_files[-1] + '.'
        self.first_epoch = first_epoch
        self.share_y = share_y
        self.show_plots = show_plots
        self.datas = [self.read_log(f) for f in log_files]

    @staticmethod
    def labels_from_filenames(log_files):
        if len(log_files) == 1:
            return log_files
        # strip the longest common prefix/suffix (reference logs.py:67-77)
        prefix = len(log_files[0])
        suffix = len(log_files[0])
        for f in log_files[1:]:
            p = 0
            while p < min(len(f), len(log_files[0])) \
                    and f[p] == log_files[0][p]:
                p += 1
            prefix = min(prefix, p)
            s = 0
            while s < min(len(f), len(log_files[0])) \
                    and f[-1 - s] == log_files[0][-1 - s]:
                s += 1
            suffix = min(suffix, s)
        return [f[prefix:len(f) - suffix] or f for f in log_files]

    def read_log(self, path):
        data = defaultdict(list)
        with open(path, 'r') as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue
                row_type = row.get('type')
                if row_type is None:
                    continue
                e = fractional_epoch(row)
                if e is not None and e < self.first_epoch:
                    continue
                data[row_type].append(row)
        return data

    def _canvas(self, name, **kwargs):
        fig_file = None if self.show_plots \
            else f'{self.output_prefix}{name}.png'
        return show.canvas(fig_file, show=self.show_plots, **kwargs)

    def field_names(self):
        out = {}
        for data, label in zip(self.datas, self.labels):
            names = []
            if data.get('config'):
                names = data['config'][0].get('field_names', [])
            if not names and data.get('train'):
                n = len(data['train'][0].get('head_losses', []))
                names = [f'field{i}' for i in range(n)]
            out[label] = names
        return out

    def process_arguments(self):
        return {label: (data['config'][0].get('argv', [])[1:]
                        if data.get('config') else [])
                for data, label in zip(self.datas, self.labels)}

    def time(self, ax):
        """Cumulative wall-clock hours vs epoch."""
        for i, (data, label) in enumerate(zip(self.datas, self.labels)):
            rows = data.get('train', [])
            times = [_parse_asctime(r) for r in rows]
            pairs = [(fractional_epoch(r), t)
                     for r, t in zip(rows, times) if t is not None]
            if not pairs:
                continue
            t0 = pairs[0][1]
            ax.plot([e for e, _ in pairs],
                    [(t - t0).total_seconds() / 3600.0 for _, t in pairs],
                    color=_color(i), label=label)
        ax.set_xlabel('epoch')
        ax.set_ylabel('time [h]')
        ax.legend(loc='upper left')

    def epoch_time(self, ax):
        """Minutes per epoch (train and val separately)."""
        for i, (data, label) in enumerate(zip(self.datas, self.labels)):
            for row_type, style in (('train-epoch', 'o-'),
                                    ('val-epoch', 'x:')):
                rows = data.get(row_type, [])
                rows = [r for r in rows if 'time' in r]
                if not rows:
                    continue
                ax.plot([r['epoch'] for r in rows],
                        [r['time'] / 60.0 for r in rows], style,
                        color=_color(i), markersize=2,
                        label=label if row_type == 'train-epoch' else None)
        ax.set_xlabel('epoch')
        ax.set_ylabel('epoch time [min]')
        ax.text(0.01, 1.01, 'train (dot-solid), val (cross-dotted)',
                transform=ax.transAxes, size='x-small')
        ax.legend(loc='upper left')

    def lr(self, ax):
        for i, (data, label) in enumerate(zip(self.datas, self.labels)):
            rows = data.get('train', [])
            if not rows:
                continue
            ax.plot([fractional_epoch(r) for r in rows],
                    [r.get('lr') for r in rows],
                    color=_color(i), label=label)
        ax.set_xlabel('epoch')
        ax.set_ylabel('learning rate')
        ax.set_yscale('log', nonpositive='clip')
        ax.legend(loc='upper left')

    def epoch_loss(self, ax):
        for i, (data, label) in enumerate(zip(self.datas, self.labels)):
            val = data.get('val-epoch', [])
            if val:
                ax.plot([r['epoch'] for r in val],
                        [r['loss'] for r in val], 'o-',
                        color=_color(i), markersize=2, label=label)
            train = [r for r in data.get('train-epoch', [])
                     if r['epoch'] > 0]
            if train:
                ax.plot([r['epoch'] for r in train],
                        [r['loss'] for r in train], 'x:',
                        color=_color(i), markersize=2)
        ax.set_xlabel('epoch')
        ax.set_ylabel('loss')
        ax.grid(linestyle='dotted')
        ax.legend(loc='upper right')
        ax.text(0.01, 1.01, 'train (cross-dotted), val (dot-solid)',
                transform=ax.transAxes, size='x-small')

    def _head_series(self, data, label, field_name, row_type):
        names = self.field_names()[label]
        if field_name not in names:
            return None
        field_i = names.index(field_name)
        rows = [r for r in data.get(row_type, [])
                if r.get('head_losses')]
        x = np.array([fractional_epoch(r) for r in rows])
        y = np.array([r['head_losses'][field_i]
                      if field_i < len(r['head_losses'])
                      and r['head_losses'][field_i] is not None
                      else np.nan
                      for r in rows], dtype=np.float64)
        m = np.logical_not(np.isnan(y))
        return x[m], y[m]

    def epoch_head(self, ax, field_name):
        last_five = []
        for i, (data, label) in enumerate(zip(self.datas, self.labels)):
            for row_type, style in (('val-epoch', 'o-'),
                                    ('train-epoch', 'x:')):
                series = self._head_series(data, label, field_name, row_type)
                if series is None or not len(series[0]):
                    continue
                x, y = series
                ax.plot(x, y, style, color=_color(i), markersize=2,
                        label=label if row_type == 'val-epoch' else None)
                last_five.append(y[-5:])
        if not last_five:
            return
        ax.set_xlabel('epoch')
        ax.set_ylabel(field_name, fontsize=8 if len(field_name) < 30 else 5)
        flat = np.concatenate(last_five)
        if not self.share_y and flat.size >= 2:
            ax.set_ylim(np.min(flat), np.max(flat))
        ax.grid(linestyle='dotted')
        ax.text(0.01, 1.01, 'train (cross-dotted), val (dot-solid)',
                transform=ax.transAxes, size='x-small')

    def preprocess_time(self, ax):
        for i, (data, label) in enumerate(zip(self.datas, self.labels)):
            rows = [r for r in data.get('train', [])
                    if r.get('batch', 1) > 0 and r.get('time')]
            if not rows:
                continue
            x = [fractional_epoch(r) for r in rows]
            y = [r.get('data_time', 0.0) / r['time'] * 100.0 for r in rows]
            optionally_shaded(ax, x, y, color=_color(i), label=label)
        ax.set_xlabel('epoch')
        ax.set_ylabel('data preprocessing time [%]')
        ax.set_ylim(0, 100)
        ax.legend(loc='upper right')

    def train(self, ax):
        min_y = 0.0
        for i, (data, label) in enumerate(zip(self.datas, self.labels)):
            rows = data.get('train', [])
            if not rows:
                continue
            x = [fractional_epoch(r) for r in rows]
            y = [r['loss'] for r in rows]
            min_y = min(min_y, min(y))
            optionally_shaded(ax, x, y, color=_color(i), label=label)
        ax.set_xlabel('epoch')
        ax.set_ylabel('training loss')
        if min_y > -0.1:
            ax.set_yscale('log', nonpositive='clip')
        ax.grid(linestyle='dotted')
        ax.legend(loc='upper right')

    def train_head(self, ax, field_name):
        for i, (data, label) in enumerate(zip(self.datas, self.labels)):
            series = self._head_series(data, label, field_name, 'train')
            if series is None or not len(series[0]):
                continue
            optionally_shaded(ax, series[0], series[1],
                              color=_color(i), label=label)
        ax.set_xlabel('epoch')
        ax.set_ylabel(field_name, fontsize=8 if len(field_name) < 30 else 5)
        ax.grid(linestyle='dotted')

    def mtl_sigma(self, ax, field_name):
        y = None
        for i, (data, label) in enumerate(zip(self.datas, self.labels)):
            names = self.field_names()[label]
            if field_name not in names:
                continue
            field_i = names.index(field_name)
            rows = data.get('train', [])
            x = np.array([fractional_epoch(r) for r in rows])
            y = np.array([r['mtl_sigmas'][field_i]
                          if r.get('mtl_sigmas')
                          and field_i < len(r['mtl_sigmas'])
                          else np.nan
                          for r in rows], dtype=np.float64)
            m = np.logical_not(np.isnan(y))
            if not np.any(m):
                continue
            optionally_shaded(ax, x[m], y[m], color=_color(i), label=label)
        ax.set_xlabel('epoch')
        ax.set_ylabel(field_name)
        ax.grid(linestyle='dotted')

    def print_last_line(self):
        for data, label in zip(self.datas, self.labels):
            if data.get('train'):
                print(f'{label}: {data["train"][-1]}')

    def _field_rows(self):
        """Group field names into plot-grid rows by dataset.head prefix."""
        rows = defaultdict(list)
        for names in self.field_names().values():
            for f in names:
                row_name = '.'.join(f.split('.')[:2])
                if f not in rows[row_name]:
                    rows[row_name].append(f)
        return rows

    def show_all(self, show_mtl_sigmas=False):
        pprint(self.process_arguments())

        with self._canvas('time') as ax:
            self.time(ax)
        with self._canvas('epoch-time') as ax:
            self.epoch_time(ax)
        with self._canvas('lr') as ax:
            self.lr(ax)
        with self._canvas('epoch-loss') as ax:
            self.epoch_loss(ax)
        with self._canvas('preprocess-time') as ax:
            self.preprocess_time(ax)
        with self._canvas('train') as ax:
            self.train(ax)

        rows = self._field_rows()
        if rows:
            n_rows = len(rows)
            n_cols = max(len(r) for r in rows.values())
            figsize = (5 * n_cols, 2.5 * n_rows)
            grid_kwargs = dict(nrows=n_rows, ncols=n_cols, squeeze=False,
                               figsize=figsize, sharex=True,
                               sharey=self.share_y)
            with self._canvas('epoch-head', **grid_kwargs) as axs:
                for row_i, row in enumerate(rows.values()):
                    for col_i, field_name in enumerate(row):
                        self.epoch_head(axs[row_i, col_i], field_name)
            with self._canvas('train-head', **grid_kwargs) as axs:
                for row_i, row in enumerate(rows.values()):
                    for col_i, field_name in enumerate(row):
                        self.train_head(axs[row_i, col_i], field_name)
            if show_mtl_sigmas:
                with self._canvas('mtl-sigmas', **grid_kwargs) as axs:
                    for row_i, row in enumerate(rows.values()):
                        for col_i, field_name in enumerate(row):
                            self.mtl_sigma(axs[row_i, col_i], field_name)

        self.print_last_line()


class EvalPlots:
    """AP-metric panels from ``<ckpt>.epochNNN.eval-*.stats.json`` files
    (reference logs.py:388-563)."""

    text_to_latex_labels = {
        'AP0.5': 'AP$^{0.50}$',
        'AP0.75': 'AP$^{0.75}$',
        'APS': 'AP$^{S}$',
        'APM': 'AP$^{M}$',
        'APL': 'AP$^{L}$',
        'AR0.5': 'AR$^{0.50}$',
        'AR0.75': 'AR$^{0.75}$',
        'ARS': 'AR$^{S}$',
        'ARM': 'AR$^{M}$',
        'ARL': 'AR$^{L}$',
    }

    def __init__(self, log_files, file_suffix, *, labels=None,
                 output_prefix=None, legend_last_ap=True,
                 first_epoch=1e-6, share_y=True, show_plots=False):
        self.file_suffix = file_suffix
        self.legend_last_ap = legend_last_ap
        self.first_epoch = first_epoch
        self.share_y = share_y
        self.show_plots = show_plots
        self.datas = [self.read_log(f) for f in log_files]
        self.labels = labels or Plots.labels_from_filenames(log_files)
        self.output_prefix = output_prefix or log_files[-1] + '.'

    def read_log(self, path):
        base = path[:-len('.log')] if path.endswith('.log') else path
        points = []
        for stats_path in sorted(glob.glob(
                base + '.epoch*' + self.file_suffix)):
            m = re.search(r'\.epoch(\d+)', stats_path)
            if not m:
                continue
            epoch = int(m.group(1))
            if epoch < self.first_epoch:
                continue
            try:
                with open(stats_path) as f:
                    stats = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            if 'stats' not in stats:
                continue
            stats.setdefault('text_labels', [
                f'stat{i}' for i in range(len(stats['stats']))])
            stats.setdefault('dataset', 'eval')
            points.append((epoch, stats))
        return sorted(points, key=lambda p: p[0])

    def _canvas(self, name, **kwargs):
        fig_file = None if self.show_plots \
            else f'{self.output_prefix}{name}.png'
        return show.canvas(fig_file, show=self.show_plots, **kwargs)

    def metrics(self):
        by_dataset = defaultdict(list)
        for data in self.datas:
            if not data:
                continue
            dataset = data[0][1]['dataset']
            for m in data[0][1]['text_labels']:
                if m not in by_dataset[dataset]:
                    by_dataset[dataset].append(m)
        return by_dataset

    def fill_metric(self, ax, dataset, metric_name):
        for data, label in zip(self.datas, self.labels):
            if not data or data[0][1]['dataset'] != dataset:
                continue
            if metric_name not in data[0][1]['text_labels']:
                continue
            entry = data[0][1]['text_labels'].index(metric_name)
            if self.legend_last_ap:
                last_main = data[-1][1]['stats'][0]
                main_name = data[0][1]['text_labels'][0]
                main_label = self.text_to_latex_labels.get(
                    main_name, main_name)
                label = f'{label} ({main_label}={last_main:.1%})'
            x = [e for e, _ in data]
            y = [d['stats'][entry] if entry < len(d['stats']) else np.nan
                 for _, d in data]
            ax.plot(x, y, 'o-', label=label, markersize=2)
        ax.set_xlabel('epoch')
        ax.set_ylabel('{} {}'.format(
            dataset, self.text_to_latex_labels.get(metric_name,
                                                   metric_name)))
        ax.grid(linestyle='dotted')

    def frame_ops(self, ax, entry):
        """AP vs GMACs (entry 0) or million parameters (entry 1)."""
        assert entry in (0, 1)
        s = 1e9 if entry == 0 else 1e6
        for data, label in zip(self.datas, self.labels):
            if not data:
                continue
            ops = data[-1][1].get('count_ops') or [0, 0]
            x = ops[entry] / s
            if x == 0.0:
                continue
            y = data[-1][1]['stats'][0]
            ax.plot([x], [y], 'o', label=label, markersize=10)
            ax.annotate(
                label if len(label) < 20 else label.split('-')[0],
                (x, y), xytext=(0.0, -5.0), textcoords='offset points',
                rotation=90,
                horizontalalignment='center', verticalalignment='top')
        ax.set_xlabel('GMACs' if entry == 0 else 'million parameters')
        ax.set_ylabel('AP')
        ax.grid(linestyle='dotted')

    def show_all(self):
        all_metrics = self.metrics()
        if not all_metrics:
            return
        # a dataset's metrics span one or two grid rows
        all_rows = []
        for dataset, metrics in all_metrics.items():
            chunks = [metrics] if len(metrics) <= 6 else [
                metrics[:-(len(metrics) // 2)],
                metrics[-(len(metrics) // 2):]]
            all_rows.extend([(dataset, m) for m in chunk]
                            for chunk in chunks)
        nrows = len(all_rows)
        ncols = max(len(r) for r in all_rows)

        with self._canvas('eval', nrows=nrows, ncols=ncols,
                          figsize=(4 * ncols, 3 * nrows), sharex=True,
                          sharey=self.share_y, squeeze=False) as axs:
            for ax_row, metric_row in zip(axs, all_rows):
                for ax, (dataset, metric_name) in zip(ax_row, metric_row):
                    self.fill_metric(ax, dataset, metric_name)
                ax_row[len(metric_row) - 1].legend(
                    fontsize=5, loc='lower right')

        with self._canvas('frame-ops', nrows=1, ncols=2, figsize=(10, 5),
                          sharey=self.share_y) as axs:
            self.frame_ops(axs[0], 0)
            self.frame_ops(axs[1], 1)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python3 -m openpifpaf_tpu_torch.logs',
        description=__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--version', action='version',
                        version=f'OpenPifPaf-TPU (PyTorch) {__version__}')
    logger.cli(parser)
    parser.add_argument('log_file', nargs='+', help='path to log file(s)')
    parser.add_argument('--label', nargs='+', default=None,
                        help='legend labels, one per log file')
    parser.add_argument('--eval-suffix', default='.eval-*.stats.json',
                        help='suffix of evaluation stats files')
    parser.add_argument('--first-epoch', default=1e-6, type=float,
                        help='epoch (can be float) of first data point')
    parser.add_argument('--no-share-y', dest='share_y',
                        default=True, action='store_false',
                        help='do not share y-axes within plot rows')
    parser.add_argument('-o', '--output', default=None,
                        help='output prefix (default: log_file + .)')
    parser.add_argument('--show', default=False, action='store_true')
    parser.add_argument('--show-mtl-sigmas', default=False,
                        action='store_true')
    parser.add_argument('--print-last', default=False, action='store_true',
                        help='print the last train entries instead of '
                             'plotting')
    args = parser.parse_args(argv)

    args.debug = False
    args.output = args.output or None
    # logger.configure writes '<output>.log' when args.output is set —
    # never wanted for a plotting CLI
    log_args = argparse.Namespace(**{**vars(args), 'output': None})
    logger.configure(log_args)

    if args.output is None:
        args.output = args.log_file[-1] + '.'

    plots = Plots(args.log_file, args.label, output_prefix=args.output,
                  first_epoch=args.first_epoch, share_y=args.share_y,
                  show_plots=args.show)
    if args.print_last:
        plots.print_last_line()
        return

    import matplotlib
    if not args.show:
        matplotlib.use('Agg')

    EvalPlots(args.log_file, args.eval_suffix, labels=args.label,
              output_prefix=args.output, first_epoch=args.first_epoch,
              share_y=args.share_y, show_plots=args.show).show_all()
    plots.show_all(show_mtl_sigmas=args.show_mtl_sigmas)


if __name__ == '__main__':
    main()
