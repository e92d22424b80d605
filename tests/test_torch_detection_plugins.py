"""The detection data modules of the PyTorch port (cocodet, cifar10,
nuscenes), the crowd-demotion transforms, the bbox ``metric.Coco`` and
``Classification`` against the JAX package's.

Everything compared here is host-side numpy, so the comparisons are exact:
- the head metas: every field;
- ``MinSize``, ``UnclippedSides``, ``UnclippedArea``: the same annotations
  demoted to crowds;
- the train and eval loaders: bit-equal batches (images, targets with NaN
  where NaN, annotations, metas) from the same seeded global
  ``np.random`` (augmentation on, no loader workers);
- bbox eval: the same fields through each package's CifDet decoder and
  ``metric.Coco(iou_type='bbox')`` give the same stats;
- ``Classification``: the same stats.

The JAX package's detection pipelines need every annotation to carry
keypoints (its transforms index them); the synthetic sets that feed both
packages have 17 absent ones, as COCO's person keypoint files do. The
port also takes COCO's instances files, which have none.
"""

import argparse
import dataclasses
import json

import numpy as np
import pytest
import torch

import openpifpaf_tpu
from openpifpaf_tpu import decoder as jax_decoder
from openpifpaf_tpu import headmeta as jax_headmeta
from openpifpaf_tpu import metric as jax_metric
from openpifpaf_tpu import transforms as jax_transforms
from openpifpaf_tpu.annotation import AnnotationDet as JaxAnnotationDet
from openpifpaf_tpu_torch import datasets, decoder, headmeta, metric, \
    transforms
from openpifpaf_tpu_torch.annotation import AnnotationDet
from openpifpaf_tpu_torch.models.shell import assign_strides
from openpifpaf_tpu_torch.plugins.coco.constants import COCO_CATEGORIES

import torch_port_helpers as helpers

EDGE = 97
STRIDE = 16
LOADER_SEED = 7
IMAGE_HW = (97, 129)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    helpers.one_torch_thread()


def _classes(name):
    return datasets.datamodules()[name], openpifpaf_tpu.DATAMODULES[name]


@pytest.fixture(scope='module')
def cocodet_set(tmp_path_factory):
    return helpers.write_synthetic_cocodet(
        str(tmp_path_factory.mktemp('cocodet')), n_images=6,
        image_hw=IMAGE_HW, seed=3, keypoints=True)


@pytest.fixture(scope='module')
def instances_set(tmp_path_factory):
    """:func:`cocodet_set`'s images and boxes, without keypoints."""
    return helpers.write_synthetic_cocodet(
        str(tmp_path_factory.mktemp('instances')), n_images=6,
        image_hw=IMAGE_HW, seed=3)


@pytest.fixture(scope='module')
def nuscenes_set(tmp_path_factory):
    from openpifpaf_tpu_torch.plugins.nuscenes import NUSCENES_CATEGORIES
    return helpers.write_synthetic_cocodet(
        str(tmp_path_factory.mktemp('nuscenes')), n_images=4,
        image_hw=IMAGE_HW, seed=4, categories=NUSCENES_CATEGORIES,
        keypoints=True)


@pytest.fixture(scope='module')
def cifar10_dir(tmp_path_factory):
    return helpers.write_synthetic_cifar10(
        str(tmp_path_factory.mktemp('cifar10')), n_train=6, n_test=5,
        seed=2)


# -- the head metas ----------------------------------------------------------

META_CASES = {
    'cocodet': ('cocodet', [], 80, 1),
    'cocodet_upsample': ('cocodet', ['--cocodet-upsample', '2'], 80, 2),
    'cifar10': ('cifar10', [], 10, 1),
    'nuscenes': ('nuscenes', [], 23, 1),
}


@pytest.mark.parametrize('case', sorted(META_CASES))
def test_head_metas_equal_jax(case):
    name, argv, n_categories, upsample = META_CASES[case]
    metas = []
    for cls in _classes(name):
        with helpers.restored_statics(cls):
            parser = argparse.ArgumentParser()
            cls.cli(parser)
            cls.configure(parser.parse_args(argv))
            metas.append(cls().head_metas)
    (ours,), (ref,) = metas
    assert type(ours) is headmeta.CifDet and type(ref) is jax_headmeta.CifDet
    assert ours.n_fields == n_categories and ours.n_components == 6
    assert ours.upsample_stride == ref.upsample_stride == upsample
    for f in dataclasses.fields(ref):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name


# -- the crowd-demotion transforms -------------------------------------------

def _random_anns(rng, n=12):
    anns = []
    for _ in range(n):
        box = np.array([rng.uniform(-10, 110), rng.uniform(-10, 80),
                        rng.uniform(0, 60), rng.uniform(0, 60)], np.float32)
        anns.append({'bbox': box, 'iscrowd': bool(rng.rand() < 0.2),
                     'bbox_original': box * rng.uniform(0.5, 2.0, 4).astype(
                         np.float32), 'category_id': 1})
    return anns


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_crowd_filters_equal_jax(seed):
    rng = np.random.RandomState(seed)
    anns = _random_anns(rng)
    meta = {'valid_area': np.array([5.0, 3.0, 100.0, 70.0]),
            'scale': np.array(rng.uniform(0.5, 2.0, 2))}
    for name, kwargs in (('MinSize', {'min_side': 4.0}),
                         ('UnclippedSides', {}),
                         ('UnclippedSides', {'margin': 4,
                                             'clipped_sides_okay': 1}),
                         ('UnclippedArea', {'threshold': 0.75})):
        crowds = []
        for module in (transforms, jax_transforms):
            _, out, _ = getattr(module, name)(**kwargs)(None, anns, meta)
            crowds.append([a['iscrowd'] for a in out])
        assert crowds[0] == crowds[1], name
        assert [a['iscrowd'] for a in anns] != crowds[0] or name == \
            'UnclippedSides', name
    assert transforms.minsize.MinSize is transforms.MinSize


# -- the pipelines -----------------------------------------------------------

def _train_batches(cls, data, prefix, **attrs):
    with helpers.restored_statics(cls):
        if prefix == 'cifar10':
            cls.root_dir = data
        else:
            cls.train_annotations, cls.train_image_dir = data
            cls.square_edge = EDGE
        for k, v in attrs.items():
            setattr(cls, k, v)
        datamodule = cls()
        datamodule.batch_size = 2
        # the packages' assign_strides are the same two assignments
        assign_strides(datamodule.head_metas, STRIDE)
        loader = datamodule.train_loader()
        np.random.seed(LOADER_SEED)
        return list(loader)


def _assert_equal_train_batches(ours, ref, n_categories, field_hw,
                                skip=('horizontal_swap',)):
    assert len(ours) == len(ref) > 0
    painted = 0
    for (images, targets, metas), (r_images, r_targets, r_metas) in zip(
            ours, ref):
        np.testing.assert_array_equal(images, r_images)
        assert targets[0].shape[1:] == (n_categories, 7) + field_hw
        painted += int((targets[0][:, :, 0] == 1.0).sum())
        for t, r in zip(targets, r_targets):
            assert t.shape == r.shape and t.dtype == r.dtype
            np.testing.assert_array_equal(t, r)
        for m, r in zip(metas, r_metas):
            assert sorted(m) == sorted(r)
            for key in m:
                if key in skip:
                    continue
                np.testing.assert_equal(m[key], r[key], err_msg=key)
    assert painted > 0


TRAIN_CASES = {'cocodet': ('cocodet', 'cocodet_set', 80, (7, 7)),
               'nuscenes': ('nuscenes', 'nuscenes_set', 23, (7, 7)),
               'cifar10': ('cifar10', 'cifar10_dir', 10, (2, 2))}


@pytest.mark.parametrize('case', sorted(TRAIN_CASES))
def test_train_batches_equal_jax(case, request):
    """Batches of 2 at 97 px, augmentation on (hflip, rescale, rotation,
    crop, pad, MinSize, UnclippedArea; cifar10 has none)."""
    name, fixture, n_categories, field_hw = TRAIN_CASES[case]
    data = request.getfixturevalue(fixture)
    ours_cls, jax_cls = _classes(name)
    ours = _train_batches(ours_cls, data, name)
    ref = _train_batches(jax_cls, data, name)
    _assert_equal_train_batches(ours, ref, n_categories, field_hw)


def test_annotations_without_keypoints_train_as_with_absent_ones(
        cocodet_set, instances_set):
    """COCO's instances files have no keypoints: the port's cocodet
    pipeline gives the batches that the JAX package gives for the same
    boxes with 17 absent keypoints each; JAX's own pipeline raises
    ``KeyError`` there."""
    ours_cls, jax_cls = _classes('cocodet')
    ours = _train_batches(ours_cls, instances_set, 'cocodet')
    ref = _train_batches(jax_cls, cocodet_set, 'cocodet')
    _assert_equal_train_batches(ours, ref, 80, (7, 7), skip=(
        'horizontal_swap', 'local_file_path'))
    with pytest.raises(KeyError, match='keypoints'):
        _train_batches(jax_cls, instances_set, 'cocodet')


def _eval_batches(cls, data, batch_size, name):
    with helpers.restored_statics(cls):
        if name == 'cifar10':
            cls.root_dir = data
        else:
            cls.eval_annotations, cls.eval_image_dir = data
            cls.eval_long_edge = EDGE
        cls.batch_size = batch_size
        np.random.seed(LOADER_SEED)
        return list(cls().eval_loader())


EVAL_CASES = {'cocodet-1': ('cocodet', 'cocodet_set', 1),
              'cocodet-2': ('cocodet', 'cocodet_set', 2),
              'nuscenes-1': ('nuscenes', 'nuscenes_set', 1),
              'cifar10-2': ('cifar10', 'cifar10_dir', 2)}


@pytest.mark.parametrize('case', sorted(EVAL_CASES))
def test_eval_batches_equal_jax(case, request):
    name, fixture, batch_size = EVAL_CASES[case]
    data = request.getfixturevalue(fixture)
    ours_cls, jax_cls = _classes(name)
    ours = _eval_batches(ours_cls, data, batch_size, name)
    ref = _eval_batches(jax_cls, data, batch_size, name)
    assert len(ours) == len(ref) > 0
    n_dets = 0
    for (images, anns, metas), (r_images, r_anns, r_metas) in zip(ours, ref):
        np.testing.assert_array_equal(images, r_images)
        for a, r in zip(metas, r_metas):
            assert a.keys() == r.keys()
            for k in a:
                np.testing.assert_equal(a[k], r[k], err_msg=k)
        for a, r in zip(anns, r_anns):
            assert [type(x).__name__ for x in a] == \
                [type(x).__name__ for x in r]
            for x, y in zip(a, r):
                n_dets += type(x).__name__ == 'AnnotationDet'
                assert x.category_id == y.category_id
                np.testing.assert_array_equal(x.bbox, y.bbox)
    assert n_dets > 0


# -- the metrics -------------------------------------------------------------

def _scene_of(gts, stride=8):
    """Decoded CifDet fields of an IMAGE_HW image at ``stride`` with an
    object at each non-crowd ground-truth box, regression noise and
    clutter."""
    objects = [(g['category_id'] - 1, g['bbox'][0] + 0.5 * g['bbox'][2],
                g['bbox'][1] + 0.5 * g['bbox'][3], g['bbox'][2],
                g['bbox'][3]) for g in gts if not g['iscrowd']]
    return helpers.cifdet_scene(objects, seed=len(objects), hw=IMAGE_HW,
                                stride=stride, noise=0.3, clutter=0.02)


def test_bbox_stats_equal_jax(cocodet_set):
    """Fields made from each image's boxes through each package's CifDet
    decoder (stride 8) and ``metric.Coco(iou_type='bbox')`` over the
    set's ground truth: the same ten stats; the port labels them as
    ``CocoEval`` computes them."""
    ann_file, _ = cocodet_set
    with open(ann_file) as f:
        data = json.load(f)
    gt_by_image = {i['id']: [a for a in data['annotations']
                             if a['image_id'] == i['id']]
                   for i in data['images']}
    results = []
    for package, decoders, metrics in ((headmeta, decoder, metric),
                                       (jax_headmeta, jax_decoder,
                                        jax_metric)):
        meta = package.CifDet('cifdet', 'cocodet',
                              categories=COCO_CATEGORIES)
        meta.head_index, meta.base_stride = 0, 8
        dec = decoders.CifDet([meta])
        coco = metrics.Coco(gt_by_image, max_per_image=100,
                            category_ids=list(range(1, 81)),
                            iou_type='bbox')
        for image_id, gts in gt_by_image.items():
            fields = _scene_of(gts)[None]
            if package is headmeta:
                fields = torch.from_numpy(fields)
            with helpers.jax_f32():
                preds, = dec.batch_decode([fields])
            coco.accumulate(preds, {'image_id': image_id})
        results.append(coco.stats())
    ours, ref = results
    assert len(ours['stats']) == 10
    assert 0.1 < ours['stats'][0] < 1.0
    assert ours['stats'] == ref['stats']
    assert ours['text_labels'] == ['AP', 'AP0.5', 'AP0.75', 'APS', 'APM',
                                   'APL', 'AR', 'ARS', 'ARM', 'ARL']


@pytest.mark.parametrize('name', ['cocodet', 'nuscenes'])
def test_ground_truth_as_prediction_gives_ap_1(name, cocodet_set,
                                               nuscenes_set):
    """The data module's ``metrics()``: the ground truth's boxes as the
    predictions give AP and AR 1.0 (crowds are ignored regions)."""
    ann_file, _ = cocodet_set if name == 'cocodet' else nuscenes_set
    cls = datasets.datamodules()[name]
    with open(ann_file) as f:
        data = json.load(f)
    with helpers.restored_statics(cls):
        cls.eval_annotations = ann_file
        coco, = cls().metrics()
    categories = cls().head_metas[0].categories
    for image in data['images']:
        coco.accumulate([
            AnnotationDet(categories).set(a['category_id'], 1.0, a['bbox'])
            for a in data['annotations']
            if a['image_id'] == image['id'] and not a['iscrowd']],
            {'image_id': image['id']})
    stats = dict(zip(*[coco.stats()[k] for k in ('text_labels', 'stats')]))
    assert stats['AP'] == stats['AR'] == 1.0


@pytest.mark.parametrize('seed', [0, 1])
def test_classification_stats_equal_jax(seed):
    """Seeded detections (some images without any) against a seeded label
    per image, through both packages' ``Classification``."""
    from openpifpaf_tpu_torch.plugins.cifar10 import CATEGORIES
    rng = np.random.RandomState(seed)
    metrics = [metric.Classification(list(CATEGORIES)),
               jax_metric.Classification(list(CATEGORIES))]
    for image_id in range(12):
        gt_label = int(rng.randint(1, 11))
        preds = [(int(rng.randint(1, 11)), float(rng.rand()))
                 for _ in range(rng.randint(0, 4))]
        if preds and rng.rand() < 0.5:
            preds.append((gt_label, float(rng.uniform(0.5, 1.0))))
        box = [5.0, 5.0, 21.0, 21.0]
        for m, cls in zip(metrics, (AnnotationDet, JaxAnnotationDet)):
            m.accumulate([cls(list(CATEGORIES)).set(c, s, box)
                          for c, s in preds], {'image_id': image_id},
                         ground_truth=[cls(list(CATEGORIES)).set(
                             gt_label, 1.0, box)])
    ours, ref = (m.stats() for m in metrics)
    assert ours == ref
    assert 0.0 < ours['stats'][0] < 1.0
    assert metrics[0].predictions == metrics[1].predictions


# -- the CLIs ----------------------------------------------------------------

@pytest.fixture
def restored_logging():
    """The CLIs configure the root logger (a stream and a JSON file
    handler); put it back."""
    import logging
    root = logging.getLogger('')
    saved = (list(root.handlers), root.level)
    yield
    for handler in root.handlers:
        if handler not in saved[0]:
            root.removeHandler(handler)
            handler.close()
    root.setLevel(saved[1])


def test_cifar10_train_eval_and_predict_clis_on_cpu(cifar10_dir, tmp_path,
                                                    restored_logging):
    """``train --dataset cifar10 --basenet cifar10net --device cpu``
    writes a checkpoint that ``eval --dataset cifar10`` scores with
    ``Classification`` and ``predict`` serves as detections' JSON."""
    import PIL.Image
    from openpifpaf_tpu_torch import eval_cli, predict, train

    out = str(tmp_path / 'model')
    with helpers.restored_statics(*decoder.DECODERS,
                                  eval_cli.Evaluator,
                                  *datasets.datamodules().values()):
        train.main(['--dataset', 'cifar10', '--basenet', 'cifar10net',
                    '--cifar10-root-dir', cifar10_dir, '--batch-size', '2',
                    '--epochs', '1', '--train-batches', '2',
                    '--val-batches', '1', '--device', 'cpu',
                    '--output', out])
        eval_cli.main(['--dataset', 'cifar10', '--checkpoint', out,
                       '--cifar10-root-dir', cifar10_dir,
                       '--eval-loader-warmup', '0', '--device', 'cpu',
                       '--output', out + '.eval'])
        image = str(tmp_path / 'image.png')
        PIL.Image.fromarray(np.random.RandomState(0).randint(
            0, 256, (64, 96, 3), dtype=np.uint8)).save(image)
        predict.main([image, '--checkpoint', out, '--device', 'cpu',
                      '--json-output', str(tmp_path), '--cif-th', '0',
                      '--seed-threshold', '0', '--instance-threshold', '0'])
    with open(out + '.json') as f:
        assert json.load(f)['base_name'] == 'cifar10net'
    with open(out + '.eval.stats.json') as f:
        stats = json.load(f)
    assert stats['text_labels'] == ['accuracy'] and stats['n_images'] == 5
    assert 0.0 <= stats['stats'][0] <= 1.0
    with open(image + '.predictions.json') as f:
        dets = json.load(f)
    assert dets and all(sorted(d) == ['bbox', 'category', 'category_id',
                                      'score'] for d in dets)
