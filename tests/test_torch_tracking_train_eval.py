"""PoseTrack eval of the PyTorch port against the JAX package's.

A resnet18 tracking model with the posetrack2018 heads (random weights,
``jax_tracking_checkpoints``) is saved as a JAX checkpoint and converted
for the port. Both packages' eval
CLIs run ``--dataset posetrack2018 --write-predictions`` on the CPU over
two synthetic sequences of three frames (``write_synthetic_posetrack2018``).
The model runs on every frame, and
its fields must agree within 1e-4 of each head's largest value (float32
convolutions in two frameworks; the Tcaf head sees the cached features of
the previous frame). Random weights give TrackingPose no track good enough
to report, so the frames are decoded from the fields of
``small_tracking_scene`` instead, served in turn by both packages'
``fields_batch``: ``Multi`` (CifCaf, then TrackingPose) decodes them
through the eval loop, the inverse transform and the PoseTrack metric.
The prediction JSONs must match: the same files, images and per-image
track ids; each tracked pose against JAX's pose of its id, the untracked
ones under the pose gate (``assert_pose_gate``: visibility equal, xy
within 1e-3 px, confidences within 2e-3). ``eval_reset`` fires once,
after the first sequence's last frame was decoded and before the
second's first, and the track ids restart at 1.
"""

import collections
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpifpaf_tpu import decoder as jax_decoder
from openpifpaf_tpu import eval_cli as jax_eval_cli
from openpifpaf_tpu import predictor as jax_predictor
from openpifpaf_tpu.plugins.coco.cocokp import CocoKp as JaxCocoKp
from openpifpaf_tpu.plugins.posetrack.cocokpst import CocoKpSt as JaxCocoKpSt
from openpifpaf_tpu.plugins.posetrack.posetrack2017 import \
    Posetrack2017 as JaxPosetrack2017
from openpifpaf_tpu.plugins.posetrack.posetrack2018 import \
    Posetrack2018 as JaxPosetrack2018
from openpifpaf_tpu.signal_ import Signal as JaxSignal
import openpifpaf_tpu
from openpifpaf_tpu_torch import decoder, eval_cli, predictor
from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp
from openpifpaf_tpu_torch.plugins.posetrack.cocokpst import CocoKpSt
from openpifpaf_tpu_torch.plugins.posetrack.posetrack2017 import \
    Posetrack2017
from openpifpaf_tpu_torch.plugins.posetrack.posetrack2018 import \
    Posetrack2018
from openpifpaf_tpu_torch.signal_ import Signal

from torch_port_helpers import assert_pose_gate, jax_f32, \
    jax_tracking_checkpoints, one_torch_thread, reset_track_ids, \
    restored_statics, small_tracking_scene, write_synthetic_posetrack2018

IMAGE_HW = (97, 161)
LONG_EDGE = 129


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


@pytest.fixture(scope='module')
def checkpoints(tmp_path_factory):
    """(JAX checkpoint, the port's) of the posetrack2018 heads."""
    metas = openpifpaf_tpu.datasets.factory('posetrack2018').head_metas
    for i, meta in enumerate(metas):
        meta.head_index = i
        meta.base_stride = 16
    return jax_tracking_checkpoints(
        str(tmp_path_factory.mktemp('tracking')), metas)


def _statics():
    return restored_statics(
        *decoder.DECODERS, decoder.TrackBase, *jax_decoder.DECODERS,
        jax_decoder.TrackBase, CocoKp, CocoKpSt, Posetrack2018,
        Posetrack2017, JaxCocoKp, JaxCocoKpSt, JaxPosetrack2018,
        JaxPosetrack2017, eval_cli.Evaluator, jax_eval_cli.Evaluator,
        jax_predictor.Predictor)


def _eval(main, signal, argv, probe=len):
    """Run ``main`` on ``argv`` (class settings put back after); returns
    ``probe(resets)`` at each ``eval_reset`` it emitted. JAX's Predictor runs
    without its prefetch thread, which pulls batches ahead and so emits
    ``eval_reset`` before the last frames of a sequence are decoded."""
    resets = []
    saved = dict(signal.subscribers)
    signal.subscribers = {'eval_reset': [
        lambda: resets.append(probe(resets))]}
    try:
        with _statics():
            jax_predictor.Predictor.prefetch_depth = 0
            reset_track_ids()
            main(argv)
    finally:
        signal.subscribers = saved
    return resets


def _jax_main(argv):
    saved = sys.argv
    sys.argv = ['eval'] + argv
    try:
        with jax_f32():
            jax_eval_cli.main()
    finally:
        sys.argv = saved


def _read(output):
    """(stats, {sequence file: (images, {image_id: [(track_id, rows)]})})
    of an eval's outputs; rows (17, 4) [c, x, y, 0] as ``pose_rows``."""
    with open(output + '.stats.json') as f:
        stats = json.load(f)
    sequences = {}
    for name in sorted(os.listdir(output)):
        with open(os.path.join(output, name)) as f:
            data = json.load(f)
        by_image = collections.defaultdict(list)
        for ann in data['annotations']:
            kps = np.asarray(ann['keypoints'], np.float32).reshape(-1, 3)
            assert ann['scores'] == kps[:, 2].tolist()
            rows = np.concatenate([kps[:, 2:], kps[:, :2],
                                   np.zeros((len(kps), 1), np.float32)], 1)
            by_image[ann['image_id']].append((ann['track_id'], rows))
        sequences[name] = (data['images'], by_image)
    return stats, sequences


def _compare(out, ref_out):
    """The two evals' outputs match (see the module docstring); returns
    the track ids of each sequence."""
    stats, sequences = _read(out)
    ref_stats, ref_sequences = _read(ref_out)
    assert stats['stats'][0] == ref_stats['stats'][0] == 6  # images
    assert stats['stats'][1] == ref_stats['stats'][1] > 0  # annotations
    assert stats['nn_time'] > 0 and stats['decoder_time'] > 0
    assert sorted(sequences) == sorted(ref_sequences) == [
        '000001_mpii_test.json', '000002_mpii_test.json']
    seen_ids = []
    for name in sorted(sequences):
        images, by_image = sequences[name]
        ref_images, ref_by_image = ref_sequences[name]
        assert images == ref_images and len(images) == 3
        ids = set()
        for image in images:
            ours, ref = by_image[image['id']], ref_by_image[image['id']]
            our_ids = sorted(i for i, _ in ours if i is not None)
            assert our_ids == sorted(i for i, _ in ref if i is not None)
            assert_pose_gate([r for i, r in ours if i is None],
                             [r for i, r in ref if i is None])
            for track_id in our_ids:
                assert_pose_gate([r for i, r in ours if i == track_id],
                                 [r for i, r in ref if i == track_id])
            ids.update(our_ids)
        assert ids, name  # TrackingPose reported tracks
        seen_ids.append(ids)
    return seen_ids


@pytest.fixture(scope='module')
def posetrack(tmp_path_factory):
    return write_synthetic_posetrack2018(
        str(tmp_path_factory.mktemp('data')), n_sequences=2, n_frames=3,
        image_hw=IMAGE_HW, seed=4)


def _argv(posetrack):
    _, val_glob, root = posetrack
    return ['--dataset', 'posetrack2018',
            '--posetrack2018-eval-annotations', val_glob,
            '--posetrack2018-data-root', root,
            '--posetrack-eval-long-edge', str(LONG_EDGE),
            '--write-predictions', '--eval-loader-warmup', '0']


def _serving(module, as_field, scene, record):
    """``module.Predictor.fields_batch`` that runs the model (its fields
    appended to ``record``) and returns the next frame of ``scene``."""
    real = module.Predictor.fields_batch

    def fields_batch(self, image_batch):
        assert len(image_batch) == 1
        fields = real(self, image_batch)
        record.append([np.asarray(f) for f in fields])
        return [as_field(f[None]) for f in scene[len(record) - 1]]

    return fields_batch


def test_posetrack2018_eval_matches_jax(checkpoints, posetrack, tmp_path,
                                        monkeypatch):
    src, dst = checkpoints
    scene = small_tracking_scene('posetrack2018')
    served = {'port': [], 'jax': []}
    monkeypatch.setattr(predictor.Predictor, 'fields_batch', _serving(
        predictor, torch.from_numpy, scene, served['port']))
    monkeypatch.setattr(jax_predictor.Predictor, 'fields_batch', _serving(
        jax_predictor, jnp.asarray, scene, served['jax']))
    out, ref_out = str(tmp_path / 'port'), str(tmp_path / 'jax')
    resets = _eval(eval_cli.main, Signal,
                   ['--checkpoint', dst, '--output', out, '--device', 'cpu',
                    *_argv(posetrack)], lambda _: len(served['port']))
    ref_resets = _eval(_jax_main, JaxSignal,
                       ['--checkpoint', src, '--output', ref_out,
                        *_argv(posetrack)], lambda _: len(served['jax']))
    # one reset, after the first sequence's 3 frames were decoded and
    # before the second's first frame
    assert resets == ref_resets == [3]

    assert len(served['port']) == len(served['jax']) == 6
    for t, (fields, ref) in enumerate(zip(served['port'], served['jax'])):
        assert [f.shape for f in fields] == [r.shape for r in ref] == [
            (1, 17, 5, 9, 9), (1, 18, 8, 9, 9), (1, 17, 8, 9, 9)]
        for f, r in zip(fields, ref):
            np.testing.assert_allclose(f, r, rtol=0,
                                       atol=1e-4 * np.abs(r).max(),
                                       err_msg=f'frame {t}')

    first, second = _compare(out, ref_out)
    # the simplified track ids restart at 1 in the second sequence
    assert min(first) == min(second) == 1
