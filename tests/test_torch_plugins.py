"""The port's dataset registry, plugin discovery and keypoint plugins
(wholebody, crowdpose, animal, apollo) against the JAX package's; the
registry and flags cover the detection plugins (cocodet, cifar10,
nuscenes) too, whose pipelines ``test_torch_detection_plugins.py``
holds.

Everything here is host-side Python and numpy, so the comparisons are
exact: the registry's names, every field of the head metas (with the
per-edge CAF weights derived from the local-centrality weights), each
module's flags with their defaults, ``MeanPixelError``'s stats, the
converters' output files (but the ``date_created`` they stamp) and the
ids of each ``--crowdpose-index`` bucket.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import PIL.Image
import pytest

import openpifpaf_tpu
from openpifpaf_tpu.annotation import Annotation as JaxAnnotation
from openpifpaf_tpu.plugins.animalpose.voc_to_coco import \
    VocToCoco as JaxVocToCoco
from openpifpaf_tpu.plugins.apollocar3d import ApolloKp as JaxApolloKp
from openpifpaf_tpu.plugins.apollocar3d.apollo_to_coco import \
    ApolloToCoco as JaxApolloToCoco
from openpifpaf_tpu.plugins.apollocar3d.metrics import \
    MeanPixelError as JaxMeanPixelError
from openpifpaf_tpu.plugins.crowdpose import CrowdPose as JaxCrowdPose
from openpifpaf_tpu_torch import datasets, plugin
from openpifpaf_tpu_torch.annotation import Annotation
from openpifpaf_tpu_torch.plugins.animalpose.voc_to_coco import VocToCoco
from openpifpaf_tpu_torch.plugins.apollocar3d import ApolloKp
from openpifpaf_tpu_torch.plugins.apollocar3d.apollo_to_coco import \
    ApolloToCoco, KPS_MAPPING
from openpifpaf_tpu_torch.plugins.apollocar3d.metrics import MeanPixelError
from openpifpaf_tpu_torch.plugins.crowdpose import CrowdPose

from torch_port_helpers import CROWD_INDICES, restored_statics, \
    write_synthetic_crowdpose

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the JAX package's data modules that the port lacks
NOT_PORTED = set()
PORTED = {'cocokp', 'cocokpst', 'posetrack2018', 'posetrack2017',
          'wholebody', 'crowdpose', 'animal', 'apollo', 'cocodet',
          'cifar10', 'nuscenes'}


def _jax_modules():
    return openpifpaf_tpu.DATAMODULES


# -- the registry and discovery ----------------------------------------------

def test_registry_is_jax_minus_what_waits_for_a9():
    assert set(datasets.datamodules()) == PORTED
    assert set(_jax_modules()) - NOT_PORTED == PORTED
    assert set(plugin.REGISTERED) == {
        f'openpifpaf_tpu_torch.plugins.{name}' for name in (
            'animalpose', 'apollocar3d', 'cifar10', 'coco', 'crowdpose',
            'nuscenes', 'posetrack', 'wholebody')}


def test_port_package_defines_no_register():
    """JAX's discovery imports every ``openpifpaf_tpu_*`` package, the port
    included, and calls its ``register`` if it has one."""
    import openpifpaf_tpu_torch
    assert not hasattr(openpifpaf_tpu_torch, 'register')
    assert not plugin.PREFIX.startswith('openpifpaf_tpu_torch.')
    assert not 'openpifpaf_tpu_torch'.startswith(plugin.PREFIX)


_PROBE = '''
import json, sys
import openpifpaf_tpu_torch
before = sorted(m for m in sys.modules if m.startswith('openpifpaf'))
from openpifpaf_tpu_torch import datasets, plugin
names = sorted(datasets.datamodules())
print(json.dumps({'before': before, 'names': names,
                  'versions': plugin.versions(),
                  'loaded': sorted(m for m in sys.modules
                                   if m.split('.')[0] in ('jax',
                                                          'openpifpaf_tpu'))}))
'''


def test_external_plugin_discovery(tmp_path):
    """An installed ``openpifpaf_tpu_torch_*`` package registers its data
    module on first use of the registry; importing the port registers
    nothing and imports nothing else."""
    pkg = tmp_path / 'openpifpaf_tpu_torch_testplugin'
    pkg.mkdir()
    (pkg / '__init__.py').write_text(textwrap.dedent('''
        from openpifpaf_tpu_torch import datasets

        __version__ = '9.9'


        class FakeDataModule(datasets.DataModule):
            pass


        def register():
            datasets.DATAMODULES['testplugin'] = FakeDataModule
    '''))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + str(tmp_path))
    done = subprocess.run([sys.executable, '-c', _PROBE], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300, check=False)
    assert done.returncode == 0, done.stderr
    report = json.loads(done.stdout.strip().splitlines()[-1])
    assert report['before'] == ['openpifpaf_tpu_torch']
    assert set(report['names']) == PORTED | {'testplugin'}
    assert report['versions']['openpifpaf_tpu_torch_testplugin'] == '9.9'
    assert report['loaded'] == []


# -- the head metas ----------------------------------------------------------

def _configured_metas(cls, argv):
    parser = argparse.ArgumentParser()
    with restored_statics(cls):
        cls.cli(parser)
        cls.configure(parser.parse_args(argv))
        return cls().head_metas


def _plugin_classes(name):
    return datasets.datamodules()[name], _jax_modules()[name]


META_CASES = {
    'wholebody': ('wholebody', [], [133, 160]),
    'wholebody_centrality': (
        'wholebody', ['--wholebody-apply-local-centrality-weights'],
        [133, 160]),
    'crowdpose': ('crowdpose', [], [14, 15]),
    'animal': ('animal', [], [20, 20]),
    'apollo': ('apollo', [], [24, 49]),
    'apollo_66': ('apollo', ['--apollo-use-66-kps'], [66, None]),
    'apollo_66_centrality': (
        'apollo', ['--apollo-use-66-kps',
                   '--apollo-apply-local-centrality-weights'], [66, None]),
}


@pytest.mark.parametrize('case', sorted(META_CASES))
def test_head_metas_equal_jax(case):
    name, argv, n_fields = META_CASES[case]
    ours_cls, jax_cls = _plugin_classes(name)
    with restored_statics(ours_cls), restored_statics(jax_cls):
        ours = _configured_metas(ours_cls, argv)
        ref = _configured_metas(jax_cls, argv)
    assert [type(m).__name__ for m in ours] == ['Cif', 'Caf']
    assert [type(m).__name__ for m in ref] == ['Cif', 'Caf']
    assert ours[0].n_fields == n_fields[0]
    if n_fields[1] is not None:
        assert ours[1].n_fields == n_fields[1]
    assert ours[1].n_fields == ref[1].n_fields
    weighted = 'centrality' in case
    for m, r in zip(ours, ref):
        assert (m.training_weights is not None) == weighted
        for f in dataclasses.fields(r):
            a, b = getattr(m, f.name), getattr(r, f.name)
            if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name
        assert m.upsample_stride == r.upsample_stride
    if weighted:
        caf_w = np.asarray(ours[1].training_weights)
        assert np.isclose(caf_w.mean(), 1.0)


@pytest.mark.parametrize('package', ['port', 'jax'])
def test_apollo_centrality_weights_need_66_keypoints(package):
    cls = ApolloKp if package == 'port' else JaxApolloKp
    with restored_statics(cls), pytest.raises(ValueError, match='66 kps'):
        _configured_metas(cls, ['--apollo-apply-local-centrality-weights'])


def test_apollo_kp_count_flags():
    """``--apollo-use-66-kps`` switches the class to the 66-keypoint
    configuration (``use_66()`` writes class attributes), as in
    ``tests/test_plugins.py::test_apollo_kp_count_flags``. The annotation
    files then come from the ``--apollo-*-annotations`` flags, whose
    defaults are the 24-keypoint files, in both packages."""
    configured = {}
    for cls in (ApolloKp, JaxApolloKp):
        with restored_statics(cls):
            parser = argparse.ArgumentParser()
            cls.cli(parser)
            cls.configure(parser.parse_args(['--apollo-use-66-kps']))
            assert len(cls.keypoints) == 66 and not cls.use_24_kps
            assert len(cls().head_metas[0].keypoints) == 66
            configured[cls] = [getattr(cls, k) for k in (
                'keypoints', 'sigmas', 'skeleton', 'hflip',
                'train_annotations', 'val_annotations', 'eval_annotations')]
        assert len(cls.keypoints) == 24 and cls.use_24_kps
    assert configured[ApolloKp] == configured[JaxApolloKp]
    assert configured[ApolloKp][5].endswith('_24_val.json')


# -- the CLI -----------------------------------------------------------------

def _flags(cls):
    parser = argparse.ArgumentParser()
    with restored_statics(cls):
        cls.cli(parser)
    return {tuple(a.option_strings): (a.dest, a.default, a.type, a.nargs,
                                      a.const, a.choices, type(a).__name__)
            for a in parser._actions  # pylint: disable=protected-access
            if a.option_strings != ['-h', '--help']}


@pytest.mark.parametrize('name', sorted(PORTED - {'cocokp'}))
def test_flags_equal_jax(name):
    ours_cls, jax_cls = _plugin_classes(name)
    ours, ref = _flags(ours_cls), _flags(jax_cls)
    assert ours == ref
    assert ours


def test_no_two_modules_share_a_flag():
    """Every module's ``cli`` runs in each CLI: argparse raises on a
    repeated option string."""
    parser = argparse.ArgumentParser()
    for cls in datasets.datamodules().values():
        cls.cli(parser)
    args = parser.parse_args([])
    for cls in datasets.datamodules().values():
        with restored_statics(cls):
            cls.configure(args)


# -- the apollo metric -------------------------------------------------------

def _mean_pixel_error(annotation_cls, metric_cls, seed):
    """``tests/test_plugins.py``'s four-joint case, then seeded cars."""
    kps = [f'k{i}' for i in range(5)]
    skel = [(1, 2)]
    gt = annotation_cls(kps, skel).set(
        np.array([[10.0, 10.0, 2.0], [20.0, 10.0, 2.0], [30.0, 10.0, 2.0],
                  [40.0, 10.0, 2.0], [0.0, 0.0, 0.0]], np.float32),
        fixed_bbox=np.array([0.0, 0.0, 368.0, 368.0]))
    pred = annotation_cls(kps, skel).set(
        np.array([[11.0, 10.0, 0.9], [20.0, 10.0, 0.9], [30.0, 30.0, 0.9],
                  [41.0, 10.0, 0.9], [0.0, 0.0, 0.0]], np.float32))
    metric = metric_cls()
    metric.accumulate([pred], {}, ground_truth=[gt])
    rng = np.random.RandomState(seed)
    for _ in range(4):
        gts, preds = [], []
        for _ in range(rng.randint(1, 4)):
            data = np.stack([rng.uniform(0, 300, 5), rng.uniform(0, 200, 5),
                             rng.choice([0.0, 2.0], 5, p=[0.2, 0.8])], 1)
            gts.append(annotation_cls(kps, skel).set(
                data.astype(np.float32),
                fixed_bbox=rng.uniform(20, 300, 4)))
            data = data.copy()
            data[:, :2] += rng.normal(0, 8.0, (5, 2))
            data[:, 2] = rng.uniform(0.1, 1.0, 5)
            preds.append(annotation_cls(kps, skel).set(
                data.astype(np.float32)))
        metric.accumulate(preds, {}, ground_truth=gts)
    return metric.stats()


@pytest.mark.parametrize('seed', [0, 1])
def test_mean_pixel_error_equals_jax(seed):
    ours = _mean_pixel_error(Annotation, MeanPixelError, seed)
    ref = _mean_pixel_error(JaxAnnotation, JaxMeanPixelError, seed)
    assert ours['text_labels'] == ref['text_labels']
    assert ours['stats'] == ref['stats']
    assert 0.0 < ours['stats'][2] < 100.0


def test_apollo_metrics_add_mean_pixel_error(tmp_path):
    ann_file = tmp_path / 'apollo.json'
    ann_file.write_text(json.dumps({'images': [], 'annotations': [],
                                    'categories': []}))
    with restored_statics(ApolloKp):
        ApolloKp.eval_annotations = str(ann_file)
        metrics = ApolloKp().metrics()
    assert [type(m).__name__ for m in metrics] == ['Coco', 'MeanPixelError']


# -- the converters ----------------------------------------------------------

def _apollo_release(root):
    """``tests/test_plugins.py::test_apollo_to_coco_converter``'s input."""
    for sub in ('images', 'keypoints', 'ignore_mask', 'split'):
        (root / sub).mkdir(parents=True)
    im_name = 'picture_0001'
    PIL.Image.new('RGB', (120, 80)).save(root / 'images' / f'{im_name}.jpg')
    kp_dir = root / 'keypoints' / im_name
    kp_dir.mkdir()
    np.savetxt(kp_dir / f'{im_name}_3.txt',
               np.array([[49.0, 10.0, 20.0], [8.0, 30.0, 25.0],
                         [1.0, 50.0, 30.0]]), delimiter='\t')
    mask = np.zeros((80, 120), dtype=np.uint8)
    mask[60:75, 90:110] = 255
    PIL.Image.fromarray(mask).save(root / 'ignore_mask' / f'{im_name}.jpg')
    for split_file in ('train-list.txt', 'validation-list.txt'):
        with open(root / 'split' / split_file, 'w') as f:
            f.write(f'{im_name}.jpg\n')


def _voc_release(root):
    """``tests/test_plugins.py::test_voc_to_coco_converter``'s input."""
    (root / 'TrainVal' / 'VOCdevkit' / 'VOC2011'
     / 'JPEGImages').mkdir(parents=True)
    (root / 'PASCAL2011_animal_annotation').mkdir()
    img_dir = root / 'animalpose_image_part2' / 'dog'
    img_dir.mkdir(parents=True)
    ann_dir = root / 'animalpose_anno2' / 'dog'
    ann_dir.mkdir(parents=True)
    PIL.Image.new('RGB', (100, 60)).save(img_dir / 'do42.jpg')
    (ann_dir / 'do42.xml').write_text('''<annotation>
      <visible_bounds xmin="11" ymin="6" width="50" height="40"/>
      <keypoints>
        <keypoint name="Nose" visible="1" x="20" y="15" z="0"/>
        <keypoint name="L_Eye" visible="1" x="25" y="12" z="0"/>
        <keypoint name="TailBase" visible="0" x="70" y="40" z="0"/>
      </keypoints>
    </annotation>''')
    (root / 'train.txt').write_text('do42.jpg\n')
    (root / 'val.txt').write_text('')


def _outputs(directory):
    """{relative path: JSON without its date, or the file's bytes}."""
    out = {}
    for root, _, names in os.walk(directory):
        for name in names:
            path = os.path.join(root, name)
            key = os.path.relpath(path, directory)
            if name.endswith('.json'):
                with open(path) as f:
                    data = json.load(f)
                data['info'].pop('date_created')
                out[key] = data
            else:
                with open(path, 'rb') as f:
                    out[key] = f.read()
    return out


CONVERTERS = {
    'apollo_to_coco': (_apollo_release, ApolloToCoco, JaxApolloToCoco,
                       'train', 'annotations/apollo_keypoints_24_train.json'),
    'voc_to_coco': (_voc_release, VocToCoco, JaxVocToCoco, '',
                    'annotations/animal_keypoints_20_train.json'),
}


@pytest.mark.parametrize('name', sorted(CONVERTERS))
def test_converter_outputs_equal_jax(name, tmp_path):
    release, ours_cls, jax_cls, sub, main_file = CONVERTERS[name]
    release(tmp_path / 'release' / sub if sub else tmp_path / 'release')
    src = str(tmp_path / 'release' / sub)
    ours_cls(src, str(tmp_path / 'ours')).process()
    jax_cls(src, str(tmp_path / 'jax')).process()
    ours, ref = _outputs(tmp_path / 'ours'), _outputs(tmp_path / 'jax')
    assert sorted(ours) == sorted(ref)
    assert main_file in ours
    assert ours == ref
    if name == 'apollo_to_coco':
        car, = [a for a in ours[main_file]['annotations']
                if not a['iscrowd']]
        kps = np.asarray(car['keypoints']).reshape(-1, 3)
        assert len(kps) == 24 and kps[KPS_MAPPING.index(49)][0] == 10.0


# -- the crowdpose buckets ---------------------------------------------------

def _bucket_ids(cls, ann_file, image_dir, index):
    parser = argparse.ArgumentParser()
    with restored_statics(cls):
        cls.cli(parser)
        argv = ['--crowdpose-val-annotations', ann_file,
                '--crowdpose-image-dir', image_dir]
        if index:
            argv += ['--crowdpose-index', index]
        cls.configure(parser.parse_args(argv))
        return list(cls().eval_loader().dataset.ids)


@pytest.mark.parametrize('index', [None, 'easy', 'medium', 'hard'])
def test_crowdpose_index_selects_jax_ids(tmp_path, index):
    """Half-open buckets [0, 0.1), [0.1, 0.8) and the closed top bucket
    [0.8, 1.0]: each image is in exactly one."""
    ann_file, image_dir = write_synthetic_crowdpose(
        str(tmp_path), n_images=len(CROWD_INDICES), image_hw=(97, 129),
        seed=6)
    ours = _bucket_ids(CrowdPose, ann_file, image_dir, index)
    ref = _bucket_ids(JaxCrowdPose, ann_file, image_dir, index)
    assert ours == ref
    with open(ann_file) as f:
        data = json.load(f)
    with_people = {a['image_id'] for a in data['annotations']}
    lo, hi = {None: (0.0, 2.0), 'easy': (0.0, 0.1), 'medium': (0.1, 0.8),
              'hard': (0.8, 1.0)}[index]
    want = [i['id'] for i in data['images']
            if i['id'] in with_people and (
                lo <= i['crowdIndex'] < hi
                or (index == 'hard' and i['crowdIndex'] == hi))]
    assert sorted(ours) == sorted(want) and want
