"""The PyTorch port never imports JAX.

The GPU machine the port runs on has no JAX, flax or orbax, so every module
of ``openpifpaf_tpu_torch`` (and ``chip_smoke.py``) must import without
them. A fresh interpreter blocks those packages and the JAX package at the
import system, imports every port module, and reports what it loaded.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'openpifpaf_tpu')

_PROBE = r'''
import importlib, importlib.abc, json, pkgutil, sys

FORBIDDEN = {forbidden!r}


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in FORBIDDEN:
            raise ImportError('blocked: ' + name)
        return None


sys.meta_path.insert(0, Block())
import openpifpaf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    openpifpaf_tpu_torch.__path__, 'openpifpaf_tpu_torch.')]
for name in names:
    importlib.import_module(name)
print(json.dumps({{
    'modules': names,
    'loaded': sorted(m for m in sys.modules
                     if m.split('.')[0] in FORBIDDEN),
}}))
'''


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_every_port_module_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    done = subprocess.run(
        [sys.executable, '-c', _PROBE.format(forbidden=FORBIDDEN)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
        check=False)
    assert done.returncode == 0, done.stderr
    report = json.loads(done.stdout.strip().splitlines()[-1])
    for name in ('predict', '_nvcc', 'ops.cifhr_cuda', 'models.dw_cuda',
                 'models.shuffle_cuda', 'models.block_cuda',
                 'models.fused_inference', 'lab.kernels', 'lab.timing',
                 'lab.mosaic_lab', 'train', 'logger', 'training.trainer',
                 'training.losses', 'training.optimize',
                 'training.checkpoint', 'encoder.cif', 'encoder.caf',
                 'transforms.rotate', 'transforms.image',
                 'datasets.loader', 'plugins.coco.cocokp',
                 'models.basenetworks', 'models.factory',
                 'models.convert_jax', 'transforms.toannotations',
                 'annotation', 'metric', 'metric.base', 'metric.cocoeval',
                 'metric.coco', 'eval', 'eval_cli', 'benchmark',
                 'headmeta', 'signal_', 'profiler', 'stream', 'video',
                 'plugins.posetrack.constants', 'plugins.posetrack.cocokpst',
                 'datasets.factory', 'models.tracking', 'decoder.base',
                 'decoder.multi', 'decoder.factory',
                 'decoder.track_annotation', 'decoder.track_base',
                 'decoder.tracking_pose', 'decoder.pose_similarity',
                 'decoder.pose_distance', 'decoder.pose_distance.base',
                 'decoder.pose_distance.crafted',
                 'decoder.pose_distance.euclidean',
                 'decoder.pose_distance.oks', 'encoder.tcaf',
                 'encoder.single_image', 'encoder.annrescaler',
                 'transforms.pair', 'transforms.pair.single_image',
                 'transforms.pair.image_to_tracking',
                 'transforms.pair.camera_shift', 'transforms.pair.crop',
                 'transforms.pair.pad', 'transforms.pair.encoders',
                 'transforms.pair.blank_past',
                 'transforms.pair.sample_pairing', 'datasets.collate',
                 'datasets.loader_with_reset', 'plugins.posetrack.datasets',
                 'plugins.posetrack.normalize',
                 'plugins.posetrack.posetrack2018',
                 'plugins.posetrack.posetrack2017',
                 'plugins.posetrack.metric', 'plugins.posetrack.benchmark'):
        assert f'openpifpaf_tpu_torch.{name}' in report['modules']
    assert report['loaded'] == []


@pytest.mark.parametrize('source', ['openpifpaf_tpu_torch', 'chip_smoke.py'])
def test_no_jax_import_statement(source):
    """No import statement of the port or of ``chip_smoke.py`` names JAX or
    the JAX package, not even one inside a function."""
    path = os.path.join(REPO, source)
    files = [path] if path.endswith('.py') else [
        os.path.join(root, name) for root, _, names in os.walk(path)
        for name in names if name.endswith('.py')]
    assert len(files) >= 1
    bad = [(f, name) for f in files for name in _imports(f)
           if name.split('.')[0] in FORBIDDEN]
    assert bad == []
