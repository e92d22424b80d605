"""The port's eval against the JAX package's.

- ``metric.CocoEval``/``metric.Coco`` (numpy in both packages) on the
  same seeded predictions and ground truth: identical ``stats``;
- the cocokp eval preprocessing and ``eval_loader`` batches (images,
  metas, converted ground truth) under each ``--coco-eval-*`` option:
  equal;
- the Evaluator split into seams, as ``tests/test_eval_ap_parity.py``
  splits it: the NN fields of the converted fixture checkpoint within 1e-4
  of each head's largest value, then the *same* fields through each
  side's decoder, inverse transform and metric give identical stats
  (decoder thresholds are step functions, so two float-different fields
  would flake near a threshold);
- ``python -m openpifpaf_tpu_torch.eval --device cpu`` on a small
  ``write_synthetic_coco`` set (a bright square painted on each image)
  with the converted fixture, and ``benchmark.py`` over two entries of a
  suite.

The fixture (a resnet18 overfit on one image) is served with
``--force-complete-pose`` so that every image gives a pose to evaluate.
"""

import argparse
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from openpifpaf_tpu import decoder as jax_decoder_module
from openpifpaf_tpu.annotation import Annotation as JaxAnnotation
from openpifpaf_tpu.metric.coco import Coco as JaxCoco
from openpifpaf_tpu.plugins.coco.cocokp import CocoKp as JaxCocoKp
from openpifpaf_tpu.predictor import Predictor as JaxPredictor
from openpifpaf_tpu_torch import decoder as port_decoder_module
from openpifpaf_tpu_torch import eval_cli
from openpifpaf_tpu_torch.annotation import Annotation
from openpifpaf_tpu_torch.metric import Coco
from openpifpaf_tpu_torch.plugins.coco import constants
from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp
from openpifpaf_tpu_torch.predictor import Predictor

from torch_port_helpers import FIXTURE, jax_f32, one_torch_thread, \
    orbax_to_port_checkpoint, restored_statics, write_synthetic_coco

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ('--force-complete-pose',)
LONG_EDGE = 161


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


@pytest.fixture(scope='module')
def coco_set(tmp_path_factory):
    """Three synthetic images, each with a bright 60 px square painted
    over it, on which the fixture's trained model finds a pose."""
    ann_file, image_dir = write_synthetic_coco(
        str(tmp_path_factory.mktemp('coco')), n_images=3,
        image_hw=(113, 161), seed=0)
    for i, name in enumerate(sorted(os.listdir(image_dir))):
        path = os.path.join(image_dir, name)
        image = np.asarray(PIL.Image.open(path)).copy()
        image[30 + 10 * i:90 + 10 * i, 50 + 20 * i:110 + 20 * i] = 200
        PIL.Image.fromarray(image).save(path, quality=95)
    return ann_file, image_dir


@pytest.fixture(scope='module')
def converted_fixture(tmp_path_factory):
    return orbax_to_port_checkpoint(
        FIXTURE, str(tmp_path_factory.mktemp('ckpt') / 'fixture'))


def _seeded_eval(annotation_cls, metric_cls, seed):
    """``metric_cls`` fed seeded predictions (``annotation_cls``) against
    seeded ground truth: jittered copies of the truth, misses and false
    positives, a crowd region, an image without people."""
    rng = np.random.RandomState(seed)
    gt_by_image = {}
    images = []
    for image_id in range(1, 7):
        gts = []
        for i in range(rng.randint(0 if image_id == 6 else 1, 4)):
            kps = np.stack([rng.uniform(0, 300, 17), rng.uniform(0, 300, 17),
                            rng.choice([0, 1, 2], 17, p=[0.2, 0.1, 0.7])], 1)
            x0, y0 = kps[:, :2].min(0)
            w, h = np.ptp(kps[:, :2], 0) + 10.0
            gts.append({'image_id': image_id, 'category_id': 1,
                        'keypoints': kps.reshape(-1).tolist(),
                        'bbox': [float(x0), float(y0), float(w), float(h)],
                        'area': float(w * h),
                        'iscrowd': int(i == 2 and image_id == 3)})
        gt_by_image[image_id] = gts
        preds = []
        for g in gts:
            if rng.rand() < 0.2:
                continue
            kps = np.asarray(g['keypoints']).reshape(17, 3).copy()
            kps[:, :2] += rng.normal(0, rng.uniform(1, 25), (17, 2))
            kps[:, 2] = np.where(kps[:, 2] > 0, rng.uniform(0.2, 1.0, 17),
                                 0.0)
            preds.append(kps)
        for _ in range(rng.randint(0, 3)):
            preds.append(np.stack([rng.uniform(0, 300, 17),
                                   rng.uniform(0, 300, 17),
                                   rng.uniform(0.0, 0.6, 17)], 1))
        images.append((image_id, preds))
    metric = metric_cls(gt_by_image, max_per_image=20, category_ids=[1],
                        iou_type='keypoints',
                        keypoint_oks_sigmas=constants.COCO_PERSON_SIGMAS)
    for image_id, preds in images:
        anns = [annotation_cls(constants.COCO_KEYPOINTS,
                               constants.COCO_PERSON_SKELETON).set(
                                   p, joint_scales=np.full(17, 2.0))
                for p in preds]
        metric.accumulate(anns, {'image_id': image_id})
    return metric.stats()


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_coco_metric_stats_equal_jax(seed):
    ours = _seeded_eval(Annotation, Coco, seed)
    ref = _seeded_eval(JaxAnnotation, JaxCoco, seed)
    assert ours['text_labels'] == ref['text_labels']
    assert len(ours['stats']) == 10
    assert 0.0 < ref['stats'][0] < 1.0
    np.testing.assert_array_equal(ours['stats'], ref['stats'])


def test_ground_truth_as_prediction_gives_ap_1(coco_set):
    """The synthetic set's ground truth as its own predictions."""
    ann_file, _ = coco_set
    with restored_statics(CocoKp):
        CocoKp.eval_annotations = ann_file
        metric = CocoKp().metrics()[0]
    with open(ann_file) as f:
        data = json.load(f)
    for image in data['images']:
        anns = [Annotation(constants.COCO_KEYPOINTS,
                           constants.COCO_PERSON_SKELETON).set(
            np.asarray(a['keypoints'], np.float32).reshape(17, 3),
            fixed_score=1.0, fixed_bbox=a['bbox'])
            for a in data['annotations'] if a['image_id'] == image['id']]
        metric.accumulate(anns, {'image_id': image['id']})
    stats = metric.stats()['stats']
    assert stats[0] == 1.0 and stats[5] == 1.0


#: (class attributes of both CocoKp, as the --coco-eval-* flags set them)
EVAL_OPTIONS = {
    'default': {},
    'batch2': {'batch_size': 2},
    'orientation_invariant': {'eval_orientation_invariant': 1.0},
    'extended_scale': {'eval_extended_scale': True},
    'no_annotation_filter': {'eval_annotation_filter': False},
}


def _configured(cls, ann_file, image_dir, options):
    cls.eval_annotations = ann_file
    cls.eval_image_dir = image_dir
    cls.eval_long_edge = LONG_EDGE
    cls.batch_size = 1
    cls.loader_workers = 0
    for k, v in options.items():
        setattr(cls, k, v)
    return cls()


@pytest.mark.parametrize('options', sorted(EVAL_OPTIONS))
def test_eval_loader_batches_equal_jax(coco_set, options):
    ann_file, image_dir = coco_set
    # CenterPad (batches above 1) draws its fill from the global np.random
    with restored_statics(CocoKp, JaxCocoKp):
        np.random.seed(0)
        ours = list(_configured(CocoKp, ann_file, image_dir,
                                EVAL_OPTIONS[options]).eval_loader())
        np.random.seed(0)
        ref = list(_configured(JaxCocoKp, ann_file, image_dir,
                               EVAL_OPTIONS[options]).eval_loader())
    assert len(ours) == len(ref) > 0
    for (images, anns, metas), (r_images, r_anns, r_metas) in zip(ours, ref):
        np.testing.assert_array_equal(images, r_images)
        for a, r in zip(metas, r_metas):
            assert a.keys() == r.keys()
            for k in a:
                if isinstance(a[k], dict):
                    assert a[k] == r[k], k
                else:
                    np.testing.assert_array_equal(a[k], r[k], err_msg=k)
        for a, r in zip(anns, r_anns):
            assert [type(x).__name__ for x in a] == \
                [type(x).__name__ for x in r]
            for x, y in zip(a, r):
                if hasattr(x, 'data'):
                    np.testing.assert_array_equal(x.data, y.data)
                    np.testing.assert_array_equal(x.bbox(), y.bbox())
                else:
                    np.testing.assert_array_equal(x.bbox, y.bbox)


def _decoder_of(module_decoders, cli, configure, build, flags=FLAGS):
    parser = argparse.ArgumentParser()
    with restored_statics(*module_decoders):
        cli(parser)
        configure(parser.parse_args(list(flags)))
        return build()


def test_evaluator_seams_equal_jax(coco_set, converted_fixture):
    """(a) the fields of each side's eval loader and Predictor; (b) JAX's
    fields through each side's decoder, inverse transform and metric."""
    _evaluator_seams(coco_set, converted_fixture, hflip_tta=False,
                     flags=FLAGS)


#: the overfit fixture does not answer the mirrored image, so the TTA
#: halves its confidences and averages its regressions with the mirror's;
#: lower thresholds keep its poses
TTA_FLAGS = FLAGS + ('--seed-threshold', '0.1', '--instance-threshold',
                     '0.01', '--keypoint-threshold', '0.01')


def test_evaluator_seams_equal_jax_under_hflip_tta(coco_set,
                                                   converted_fixture):
    """As :func:`test_evaluator_seams_equal_jax` with ``--hflip-tta``:
    the averaged fields of each side, then identical stats."""
    _evaluator_seams(coco_set, converted_fixture, hflip_tta=True,
                     flags=TTA_FLAGS)


def _evaluator_seams(coco_set, converted_fixture, hflip_tta, flags):
    ann_file, image_dir = coco_set
    with restored_statics(CocoKp, JaxCocoKp):
        ours_dm = _configured(CocoKp, ann_file, image_dir, {})
        ref_dm = _configured(JaxCocoKp, ann_file, image_dir, {})
        port_predictor = _decoder_of(
            (port_decoder_module.CifCaf, port_decoder_module.CifCafDense),
            port_decoder_module.cli, port_decoder_module.configure,
            lambda: Predictor(checkpoint=converted_fixture, device='cpu'),
            flags)
        jax_predictor = _decoder_of(
            jax_decoder_module.factory.DECODERS,
            jax_decoder_module.factory.cli,
            jax_decoder_module.factory.configure,
            lambda: JaxPredictor(checkpoint=FIXTURE), flags)
        port_predictor.hflip_tta = jax_predictor.hflip_tta = hflip_tta
        metric, ref_metric = ours_dm.metrics()[0], ref_dm.metrics()[0]
        n_poses = 0
        for batch, ref_batch in zip(ours_dm.eval_loader(),
                                    ref_dm.eval_loader()):
            images, _, metas = batch
            np.testing.assert_array_equal(images, ref_batch[0])
            with jax_f32():
                ref_fields = [np.asarray(f) for f in
                              jax_predictor.fields_batch(ref_batch[0])]
            fields = port_predictor.fields_batch(images)
            for f, r in zip(fields, ref_fields):
                np.testing.assert_allclose(f.numpy(), r,
                                           atol=1e-4 * np.abs(r).max(),
                                           rtol=0)
            ours = port_predictor.processor.batch_decode(
                [torch.from_numpy(np.array(r)) for r in ref_fields])
            ref = jax_predictor.processor.batch_decode(
                [jnp.asarray(r) for r in ref_fields])
            for pred, ref_pred, meta, ref_meta in zip(ours, ref, metas,
                                                      ref_batch[2]):
                metric.accumulate([a.inverse_transform(meta) for a in pred],
                                  meta)
                ref_metric.accumulate(
                    [a.inverse_transform(ref_meta) for a in ref_pred],
                    ref_meta)
                assert len(pred) == len(ref_pred)
                n_poses += len(pred)
    assert n_poses > 0
    assert metric.predictions == ref_metric.predictions
    stats, ref_stats = metric.stats(), ref_metric.stats()
    assert stats['text_labels'] == ref_stats['text_labels']
    np.testing.assert_array_equal(stats['stats'], ref_stats['stats'])


def _eval_flags(ann_file, image_dir, checkpoint, output):
    return ['--dataset', 'cocokp', '--checkpoint', checkpoint,
            '--cocokp-val-annotations', ann_file,
            '--cocokp-val-image-dir', image_dir,
            '--coco-eval-long-edge', str(LONG_EDGE),
            '--eval-loader-warmup', '0', '--device', 'cpu',
            '--output', output, *FLAGS]


def _port_env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    env.pop('JAX_PLATFORMS', None)
    return env


def test_eval_cli_writes_stats(coco_set, converted_fixture, tmp_path):
    ann_file, image_dir = coco_set
    out = str(tmp_path / 'eval')
    done = subprocess.run(
        [sys.executable, '-m', 'openpifpaf_tpu_torch.eval',
         *_eval_flags(ann_file, image_dir, converted_fixture, out)],
        env=_port_env(), capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    with open(out + '.stats.json') as f:
        stats = json.load(f)
    assert len(stats['stats']) == 10
    assert np.all(np.isfinite(stats['stats']))
    assert stats['n_images'] == 3
    assert stats['nn_time'] > 0 and stats['decoder_time'] > 0
    assert stats['file_size'] == os.path.getsize(converted_fixture + '.pt')
    assert stats['count_ops'] is None
    assert stats['checkpoint'] == converted_fixture


@pytest.mark.parametrize('flag', ['--pipeline-decode'])
def test_eval_cli_refuses_what_is_not_ported(flag, coco_set,
                                             converted_fixture, tmp_path):
    """Each flag that once raised as not ported now runs: eval with
    ``--pipeline-decode`` gives the strict loop's stats and
    predictions."""
    from openpifpaf_tpu_torch import datasets
    ann_file, image_dir = coco_set
    stats = {}
    for name, extra in (('strict', ()), ('flagged', (flag,))):
        out = str(tmp_path / name)
        with restored_statics(*port_decoder_module.DECODERS,
                              *datasets.datamodules().values(),
                              eval_cli.Evaluator):
            eval_cli.main([*_eval_flags(ann_file, image_dir,
                                        converted_fixture, out),
                           '--write-predictions', *extra])
        with open(out + '.stats.json') as f:
            stats[name] = json.load(f)
        with open(out + '.pred.json') as f:
            stats[name]['predictions'] = json.load(f)
    assert stats['flagged']['n_images'] == stats['strict']['n_images'] == 3
    assert stats['flagged']['stats'] == stats['strict']['stats']
    assert len(stats['strict']['predictions']) >= 3
    assert stats['flagged']['predictions'] == stats['strict']['predictions']


@pytest.mark.parametrize('flags', [
    ('--eval-show-final-image',),
    ('--eval-show-final-image', '--eval-show-final-ground-truth')],
    ids=['predictions', 'with_ground_truth'])
def test_eval_cli_draws_the_final_image(coco_set, converted_fixture,
                                        tmp_path, monkeypatch, flags):
    """The last image with its predictions, and under
    ``--eval-show-final-ground-truth`` its ground truth in grey, as
    ``cocokp-eval-final-image.png`` in the working directory."""
    pytest.importorskip('matplotlib')
    from openpifpaf_tpu_torch import datasets, show
    ann_file, image_dir = coco_set
    drawn = []
    annotations = show.AnnotationPainter.annotations
    monkeypatch.setattr(show.AnnotationPainter, 'annotations',
                        lambda self, ax, anns, **kw: drawn.append(
                            (len(anns), kw)) or annotations(self, ax, anns,
                                                            **kw))
    monkeypatch.chdir(tmp_path)
    with restored_statics(*port_decoder_module.DECODERS,
                          *datasets.datamodules().values(),
                          eval_cli.Evaluator):
        eval_cli.main([*_eval_flags(ann_file, image_dir, converted_fixture,
                                    str(tmp_path / 'eval')),
                       '--n-images', '1', *flags])
    ground_truth = '--eval-show-final-ground-truth' in flags
    assert [kw for _, kw in drawn] == [{}] + (
        [{'color': 'grey'}] if ground_truth else [])
    assert all(n > 0 for n, _ in drawn)
    assert PIL.Image.open(tmp_path / 'cocokp-eval-final-image.png').size[0] \
        >= 500


def test_eval_cli_takes_hflip_tta(coco_set):
    """``--hflip-tta`` reaches the Evaluator, as in JAX
    (``test_evaluator_seams_equal_jax_under_hflip_tta`` holds the
    stats)."""
    from openpifpaf_tpu_torch import datasets
    ann_file, image_dir = coco_set
    with restored_statics(*port_decoder_module.DECODERS,
                          *datasets.datamodules().values()):
        args = eval_cli.cli(['--device', 'cpu', '--hflip-tta',
                             '--cocokp-val-annotations', ann_file,
                             '--cocokp-val-image-dir', image_dir])
        evaluator = eval_cli._evaluator(args)
    assert args.hflip_tta and evaluator.hflip_tta


def test_benchmark_runs_two_suite_entries(coco_set, converted_fixture,
                                          tmp_path):
    """``--suite force-complete``: the default entry and the suite's one,
    each an eval subprocess with ``--device`` passed through."""
    ann_file, image_dir = coco_set
    out = str(tmp_path / 'bench')
    flags = _eval_flags(ann_file, image_dir, converted_fixture, 'unused')
    flags = flags[flags.index('--cocokp-val-annotations'):
                  flags.index('--device')]
    done = subprocess.run(
        [sys.executable, '-m', 'openpifpaf_tpu_torch.benchmark',
         '--checkpoints', converted_fixture, '--output', out,
         '--suite', 'force-complete', '--n-images', '2', '--device', 'cpu',
         *flags],
        env=_port_env(), capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    name = converted_fixture.replace('/', '-')
    for suffix in ('', '.force-complete'):
        with open(os.path.join(out + suffix,
                               f'{name}.eval-cocokp.stats.json')) as f:
            stats = json.load(f)
        assert stats['n_images'] == 2
        assert len(stats['stats']) == 10
    assert done.stdout.count('| checkpoint |') == 2
