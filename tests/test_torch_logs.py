"""``python -m openpifpaf_tpu_torch.logs`` against ``openpifpaf_tpu.logs``:
the same panels, bit for bit (RGBA of every PNG, as ``test_torch_show.py``
holds the painters), and the same text, on two JSON-lines training logs
written through the port's ``logger.JsonFormatter`` (the trainer's schema:
config, train, train-epoch and val-epoch rows) with their eval
``.stats.json`` files; ``--print-last`` prints the same lines.
"""

import json
import logging
import os
import sys

import numpy as np
import PIL.Image
import pytest

from openpifpaf_tpu import logs as jax_logs
from openpifpaf_tpu_torch import _nvcc, logger, logs

PANELS = ('time', 'epoch-time', 'lr', 'epoch-loss', 'preprocess-time',
          'train', 'epoch-head', 'train-head', 'mtl-sigmas', 'eval',
          'frame-ops')
FIELDS = ['cocokp.cif.c', 'cocokp.cif.vec', 'cocokp.cif.scales',
          'cocokp.caf.c', 'cocokp.caf.vec', 'cocokp.caf.scales']


def _rows(seed):
    rng = np.random.RandomState(seed)
    rows = [{'type': 'config', 'field_names': FIELDS,
             'argv': ['train.py', '--dataset=cocokp', f'--seed={seed}']}]
    t = 0
    for epoch in range(3):
        for batch in range(40):
            t += int(rng.randint(20, 40))
            rows.append({
                'type': 'train', 'epoch': epoch, 'batch': batch,
                'n_batches': 40, 'time': float(rng.uniform(0.4, 0.6)),
                'data_time': float(rng.uniform(0.05, 0.2)),
                'lr': 1e-4 * (1 + epoch),
                'loss': float(100.0 / (1 + epoch + batch / 40.0)
                              + rng.uniform(0, 5)),
                'head_losses': [float(v) for v in
                                rng.uniform(1.0, 10.0, 6) / (1 + epoch)],
                'mtl_sigmas': [float(v) for v in rng.uniform(0.1, 1.0, 6)],
                'asctime': f'2026-08-17 {8 + t // 3600:02d}:'
                           f'{t // 60 % 60:02d}:{t % 60:02d},000',
            })
        for kind, scale in (('train-epoch', 1.0), ('val-epoch', 1.1)):
            rows.append({'type': kind, 'epoch': epoch + 1,
                         'loss': scale * 100.0 / (1 + epoch),
                         'time': float(rng.uniform(100, 200)),
                         'n_batches': 40,
                         'head_losses': [scale * 10.0 / (1 + epoch)] * 6})
    return rows


def _write_log(path, rows):
    """The rows as the port's training log writes them."""
    log = logging.getLogger(f'test_torch_logs.{os.path.basename(path)}')
    log.propagate = False
    handler = logging.FileHandler(path, mode='w')
    handler.setFormatter(logger.JsonFormatter())
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        for row in rows:
            log.info(row)
    finally:
        log.removeHandler(handler)
        handler.close()


@pytest.fixture(scope='module')
def log_files(tmp_path_factory):
    directory = tmp_path_factory.mktemp('logs')
    paths = []
    for seed, name in enumerate(('k16-a', 'k16-b')):
        path = str(directory / f'{name}.log')
        _write_log(path, _rows(seed))
        for epoch in (1, 2, 3):
            stats = {'stats': [0.1 * epoch + 0.01 * seed, 0.2 * epoch, 0.1,
                               0.1, 0.2, 0.15 * epoch, 0.25, 0.12, 0.1, 0.2],
                     'text_labels': ['AP', 'AP0.5', 'AP0.75', 'APM', 'APL',
                                     'AR', 'AR0.5', 'AR0.75', 'ARM', 'ARL'],
                     'dataset': 'cocokp',
                     'count_ops': [12.3e9 + 1e9 * seed, 17.2e6]}
            with open(str(directory / f'{name}.epoch{epoch:03d}'
                          '.eval-cocokp.stats.json'), 'w') as f:
                json.dump(stats, f)
        paths.append(path)
    return paths


@pytest.fixture(autouse=True)
def _build_dir():
    saved = _nvcc.BUILD_DIR
    try:
        yield
    finally:
        _nvcc.set_build_dir(saved)


def _run(package, argv, monkeypatch, capsys):
    """(stdout) of ``package``'s logs CLI with ``argv``."""
    argv = [*argv, '--xla-compilation-cache', '']
    if package == 'jax':
        monkeypatch.setattr(sys, 'argv', ['logs', *argv])
        jax_logs.main()
    else:
        logs.main(argv)
    return capsys.readouterr().out


def test_log_rows_are_the_trainer_schema(log_files):
    with open(log_files[0]) as f:
        rows = [json.loads(line) for line in f]
    assert {r['type'] for r in rows} == {'config', 'train', 'train-epoch',
                                         'val-epoch'}
    assert all(r['levelname'] == 'INFO' and 'asctime' in r for r in rows)


def test_logs_panels_equal_jax(log_files, tmp_path, monkeypatch, capsys):
    import matplotlib
    matplotlib.use('Agg')
    outputs = {}
    for package in ('jax', 'port'):
        prefix = str(tmp_path / package / 'plots.')
        os.makedirs(os.path.dirname(prefix))
        outputs[package] = _run(package, [*log_files, '-o', prefix,
                                          '--show-mtl-sigmas'],
                                monkeypatch, capsys)
    assert outputs['port'] == outputs['jax']
    assert 'k16-a' in outputs['port']
    for panel in PANELS:
        images = [np.asarray(PIL.Image.open(
            str(tmp_path / p / f'plots.{panel}.png')).convert('RGBA'))
            for p in ('jax', 'port')]
        assert images[0].shape == images[1].shape, panel
        np.testing.assert_array_equal(images[1], images[0], err_msg=panel)


@pytest.mark.parametrize('n_logs', [1, 2])
def test_print_last_equals_jax(log_files, n_logs, monkeypatch, capsys):
    argv = [*log_files[:n_logs], '--print-last']
    ours = _run('port', argv, monkeypatch, capsys)
    ref = _run('jax', argv, monkeypatch, capsys)
    assert ours == ref
    assert len(ours.strip().splitlines()) == n_logs
