"""The port's auxiliary modules against the JAX package's:
``transforms/misc.py``, the ``decoder/utils.py`` aliases (and the
single-edge ``grow_connection_blend``), ``compile_cache`` (the build
directory of the port's libraries behind ``--xla-compilation-cache``),
the flag on every CLI, and ``TorchProfiler`` with ``train --profile``.
"""

import copy
import json
import os
import shutil
import stat
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

import openpifpaf_tpu.decoder.utils as jax_utils
from openpifpaf_tpu import transforms as jax_transforms
from openpifpaf_tpu.ops import grow as jax_grow
from openpifpaf_tpu_torch import _nvcc, compile_cache, transforms
from openpifpaf_tpu_torch.decoder import utils
from openpifpaf_tpu_torch.io import native
from openpifpaf_tpu_torch.ops import caf_scored, cifhr, grow, nms, seeds
from openpifpaf_tpu_torch.profiler import TorchProfiler

from torch_port_helpers import jax_f32, one_torch_thread, \
    write_synthetic_coco

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAG = '--xla-compilation-cache'


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


# -- transforms/misc.py -------------------------------------------------------

def _sample(seed=0):
    """A PIL image, two normalised annotations (one without a visible head
    but with both shoulders) and a meta."""
    rng = np.random.RandomState(seed)
    image = PIL.Image.fromarray(rng.randint(0, 256, (48, 64, 3))
                                .astype(np.uint8))
    anns = []
    for head_visible in (True, False):
        kps = np.zeros((17, 3), np.float32)
        kps[:, :2] = rng.uniform(5.0, 40.0, (17, 2))
        kps[5:, 2] = 2.0
        if head_visible:
            kps[:5, 2] = 2.0
        anns.append({'keypoints': kps, 'iscrowd': False,
                     'bbox': np.array([4.0, 6.0, 30.0, 35.0], np.float32)})
    meta = {'offset': np.array((0.0, 0.0)), 'scale': np.array((1.0, 1.0)),
            'valid_area': np.array((0.0, 0.0, 63.0, 47.0)),
            'hflip': False, 'width_height': np.array((64, 48))}
    return image, anns, meta


def _assert_same(ours, ref):
    """Images as arrays, and nested dicts, lists and arrays, equal."""
    if isinstance(ref, PIL.Image.Image):
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))
    elif isinstance(ref, dict):
        assert ours.keys() == ref.keys()
        for k in ref:
            _assert_same(ours[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            _assert_same(a, b)
    elif isinstance(ref, np.ndarray):
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
    else:
        assert ours == ref


def test_misc_transforms_are_exported():
    for name in ('Assert', 'Deinterlace', 'MultiScale',
                 'AddCrowdForIncompleteHead'):
        assert getattr(transforms, name).__module__ == \
            'openpifpaf_tpu_torch.transforms.misc'


def test_assert_equals_jax():
    sample = _sample()
    for module in (transforms, jax_transforms):
        out = module.Assert(lambda image, anns, meta: len(anns) == 2)(
            *copy.deepcopy(sample))
        _assert_same(out, sample)
        with pytest.raises(AssertionError, match='two'):
            module.Assert(lambda *_: False, 'two')(*copy.deepcopy(sample))


@pytest.mark.parametrize('name', ['Deinterlace', 'AddCrowdForIncompleteHead'])
def test_misc_transform_equals_jax(name):
    sample = _sample(seed=1)
    ours = getattr(transforms, name)()(*copy.deepcopy(sample))
    ref = getattr(jax_transforms, name)()(*copy.deepcopy(sample))
    _assert_same(ours, ref)
    if name == 'AddCrowdForIncompleteHead':
        assert len(ours[1]) == 3 and ours[1][2]['iscrowd']


def test_multi_scale_equals_jax():
    sample = _sample(seed=2)

    def scales(module):
        return module.MultiScale([
            module.Compose([module.RescaleAbsolute(edge),
                            module.CenterPadTight(16)])
            for edge in (33, 49, 97)])

    ours = scales(transforms)(*copy.deepcopy(sample))
    ref = scales(jax_transforms)(*copy.deepcopy(sample))
    assert len({im.size for im in ours[0]}) == 3
    _assert_same(ours, ref)


# -- decoder/utils.py --------------------------------------------------------

def test_decoder_utils_aliases_resolve_to_the_port_ops():
    assert utils.CifHr is cifhr.cif_hr
    assert utils.CifSeeds is seeds.cif_seeds
    assert utils.CafScored is caf_scored.caf_scored
    assert utils.Keypoints is nms.nms_keypoints
    assert utils.grow_connection_blend is grow.grow_connection_blend
    names = {n for n in vars(jax_utils) if not n.startswith('_')} - {
        'cifhr', 'seeds', 'caf_scored', 'nms', 'grow'}
    assert names <= set(vars(utils))


@pytest.mark.parametrize('only_max', [False, True])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_grow_connection_blend_matches_jax(seed, only_max):
    """Candidates crowd one window so that the top-2 blend, the single
    candidate and the empty case all occur; exp() rounds differently in
    XLA and torch (the growth tests' tolerance)."""
    rng = np.random.RandomState(seed)
    n_dir, n_cand = 38, 24
    cands = {k: rng.uniform(20.0, 30.0, (n_dir, n_cand)).astype(np.float32)
             for k in ('sx', 'sy', 'tx', 'ty')}
    cands['ts'] = rng.uniform(-1.0, 6.0, (n_dir, n_cand)).astype(np.float32)
    cands['c'] = np.where(rng.rand(n_dir, n_cand) < 0.3,
                          rng.uniform(0.1, 1.0, (n_dir, n_cand)),
                          0.0).astype(np.float32)
    port_cands = {k: torch.from_numpy(v) for k, v in cands.items()}
    jax_cands = {k: jnp.asarray(v) for k, v in cands.items()}
    values = []
    for _ in range(40):
        d = int(rng.randint(0, n_dir))
        x, y = (np.float32(v) for v in rng.uniform(18.0, 32.0, 2))
        s = np.float32(rng.uniform(0.2, 12.0))
        ours = grow.grow_connection_blend(port_cands, d, x, y, s,
                                          only_max=only_max)
        with jax_f32():
            ref = jax_grow.grow_connection_blend(jax_cands, d, x, y, s,
                                                 only_max=only_max)
        for o, r in zip(ours, ref):
            assert o.shape == ()
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4,
                                       rtol=1e-5)
        values.append(float(ours[0]))
    assert 0.0 in values and max(values) > 0.0


# -- compile_cache -----------------------------------------------------------

@pytest.fixture
def build_dir():
    """Put the build directory back after the test."""
    saved = _nvcc.BUILD_DIR
    try:
        yield
    finally:
        _nvcc.set_build_dir(saved)


def test_compile_cache_directory(build_dir, tmp_path):
    cache = str(tmp_path / 'kernels')
    assert compile_cache.enable(cache)
    assert _nvcc.BUILD_DIR == cache
    lib = native.build()
    assert os.path.dirname(lib) == cache
    # the second build of the same bytes and flags loads, not compiles
    mtime = os.path.getmtime(lib)
    assert native.build() == lib and os.path.getmtime(lib) == mtime


def test_compile_cache_empty_means_a_temporary_directory(build_dir):
    assert not compile_cache.enable('')
    temporary = _nvcc.BUILD_DIR
    try:
        assert temporary != _nvcc.DEFAULT_BUILD_DIR
        assert os.path.isdir(temporary) and not os.listdir(temporary)
        assert os.path.dirname(native.build()) == temporary
    finally:
        shutil.rmtree(temporary)


def test_compile_cache_default_is_the_package_build_directory():
    assert compile_cache.DEFAULT_DIR == os.path.join(
        REPO, 'openpifpaf_tpu_torch', '_build')


def test_unwritable_build_directory_names_the_flag(build_dir, tmp_path):
    blocker = tmp_path / 'a-file'
    blocker.write_text('')
    _nvcc.set_build_dir(str(blocker / 'build'))
    with pytest.raises(RuntimeError, match=FLAG):
        native.build()


_READ_ONLY = r'''
import os, sys
from openpifpaf_tpu_torch import _nvcc, compile_cache
from openpifpaf_tpu_torch.io import native
assert _nvcc.__file__.startswith(sys.argv[1])
compile_cache.enable(sys.argv[2])
print(native.build())
compile_cache.enable('')
print(native.build())
'''


def test_read_only_package_builds_where_the_flag_says(tmp_path):
    """A copy of the package made read-only (as an installed one may be)
    builds into the directory of ``--xla-compilation-cache`` or, with
    ``''``, a temporary one, and writes nothing into the package."""
    root = tmp_path / 'site'
    package = root / 'openpifpaf_tpu_torch'
    shutil.copytree(os.path.join(REPO, 'openpifpaf_tpu_torch'), package,
                    ignore=shutil.ignore_patterns('_build', '__pycache__'))
    for path, dirs, files in os.walk(package):
        for name in files + dirs:
            full = os.path.join(path, name)
            os.chmod(full, os.stat(full).st_mode & ~0o222)
    os.chmod(package, stat.S_IRUSR | stat.S_IXUSR | stat.S_IRGRP
             | stat.S_IXGRP | stat.S_IROTH | stat.S_IXOTH)
    cache = str(tmp_path / 'cache')
    env = dict(os.environ, PYTHONPATH=str(root), PYTHONDONTWRITEBYTECODE='1')
    try:
        done = subprocess.run(
            [sys.executable, '-c', _READ_ONLY, str(package), cache],
            cwd=str(tmp_path), env=env, capture_output=True, text=True,
            timeout=300, check=False)
        assert done.returncode == 0, done.stderr[-3000:]
        built, temporary = done.stdout.split()
        assert os.path.dirname(built) == cache
        assert not temporary.startswith(str(package))
        assert not os.path.exists(temporary)  # removed at exit
        assert not os.path.exists(package / '_build')
    finally:
        for path, dirs, _ in os.walk(tmp_path):
            for name in dirs:
                os.chmod(os.path.join(path, name), 0o755)
        os.chmod(package, 0o755)


#: the CLIs of both packages; the flag of ``logger.cli`` must be on a port
#: CLI exactly where it is on JAX's
CLIS = ('predict', 'train', 'eval_cli', 'video', 'logs', 'export',
        'benchmark', 'count_ops', 'migrate')


def _help(module_name, monkeypatch, capsys):
    import importlib
    module = importlib.import_module(module_name)
    monkeypatch.setattr(sys, 'argv', [module_name, '--help'])
    with pytest.raises(SystemExit):
        module.main()
    return capsys.readouterr().out


@pytest.mark.parametrize('cli', CLIS)
def test_compile_cache_flag_on_every_cli_where_jax_has_it(cli, monkeypatch,
                                                          capsys):
    jax_has = FLAG in _help(f'openpifpaf_tpu.{cli}', monkeypatch, capsys)
    port_has = FLAG in _help(f'openpifpaf_tpu_torch.{cli}', monkeypatch,
                             capsys)
    assert port_has == jax_has
    assert jax_has == (cli in ('predict', 'train', 'eval_cli', 'video',
                               'logs'))


def test_cli_flag_sets_the_build_directory(build_dir, tmp_path):
    from openpifpaf_tpu_torch import decoder, predict
    from torch_port_helpers import drawing_statics, restored_statics
    with drawing_statics('openpifpaf_tpu_torch'), \
            restored_statics(*decoder.DECODERS):
        predict.cli(['image.jpg', FLAG, str(tmp_path / 'k')])
    assert _nvcc.BUILD_DIR == str(tmp_path / 'k')


# -- the profiler -------------------------------------------------------------

def test_torch_profiler_writes_one_trace_per_call(tmp_path):
    prefix = str(tmp_path / 'trace')
    profiled = TorchProfiler(lambda a, b: a @ b, out_name=prefix,
                             device='cpu')
    first = TorchProfiler.trace_counter + 1
    a = torch.ones((8, 8))
    for _ in range(3):
        assert torch.equal(profiled(a, a), a @ a)
    paths = [f'{prefix}.{n}.json' for n in range(first, first + 3)]
    assert [p for p, _ in profiled.traces] == paths
    for path in paths:
        with open(path) as f:
            events = json.load(f)['traceEvents']
        assert any('mm' in e.get('name', '') for e in events)


_TRAIN = r'''
import sys
from openpifpaf_tpu_torch import train
from openpifpaf_tpu_torch.models import basenetworks, factory
factory.BASE_FACTORIES['shufflenetv2k-narrow'] = \
    lambda: basenetworks.ShuffleNetV2K([1, 2, 1], [8, 16, 32, 64, 64])
train.main(sys.argv[1:])
'''


def test_train_profile_writes_a_trace_of_each_step(tmp_path):
    ann_file, image_dir = write_synthetic_coco(
        str(tmp_path / 'coco'), n_images=4, image_hw=(97, 129), seed=2)
    prefix = str(tmp_path / 'step')
    argv = ['--dataset', 'cocokp', '--basenet', 'shufflenetv2k-narrow',
            '--cocokp-train-annotations', ann_file,
            '--cocokp-val-annotations', ann_file,
            '--cocokp-train-image-dir', image_dir,
            '--cocokp-val-image-dir', image_dir,
            '--cocokp-square-edge', '97', '--batch-size', '2',
            '--epochs', '1', '--train-batches', '2', '--val-batches', '1',
            '--log-interval', '1', '--device', 'cpu', '--profile', prefix,
            '--output', str(tmp_path / 'model')]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    done = subprocess.run([sys.executable, '-c', _TRAIN, *argv],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=600, check=False)
    assert done.returncode == 0, done.stderr[-3000:]
    traces = sorted(p for p in os.listdir(tmp_path)
                    if p.startswith('step.'))
    assert traces == ['step.1.json', 'step.2.json']
    for name in traces:
        with open(tmp_path / name) as f:
            names = {e.get('name', '') for e in json.load(f)['traceEvents']}
        assert any('convolution' in n for n in names)
        assert any('backward' in n.lower() for n in names)
    with open(str(tmp_path / 'model') + '.log') as f:
        lines = [json.loads(line) for line in f]
    assert len([r for r in lines if r.get('type') == 'train']) == 2
