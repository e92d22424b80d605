"""The tracking decoders of the PyTorch port against the JAX package on a
synthetic video (``torch_port_helpers.small_tracking_scene``: 6 frames of
257x321 at stride 16, three people who move, one leaving after frame 2
and one entering at frame 3).

Both packages decode each frame with the ``Multi`` of the tracking metas
(``CifCaf`` and ``TrackingPose``) under each of
``torch_port_helpers.TRACKING_CONFIGS``, and with ``PoseSimilarity`` under
each distance; the annotations of every frame must be JAX's within the
tie-free gate (counts and visibility equal, xy within 1e-3 px,
confidences within 2e-3) with equal track ids. Small static budgets
(``TRACKING_TEST_BUDGETS``) keep the JAX compiles short; the track-id
counters of both packages restart at 1 before each sequence.
"""

import argparse

import numpy as np
import pytest
import torch

from openpifpaf_tpu import decoder as jax_decoder
from openpifpaf_tpu.signal_ import Signal as JaxSignal
from openpifpaf_tpu_torch import decoder as port_decoder
from openpifpaf_tpu_torch.signal_ import Signal

from torch_port_helpers import GOLDEN_STRIDE, TRACKING_CONFIGS, \
    TRACKING_TEST_BUDGETS, assert_tracking_frame, decode_frames, jax_f32, \
    jax_tracking_decoder, jax_tracking_metas, one_torch_thread, \
    port_tracking_decoder, port_tracking_metas, reset_track_ids, \
    restored_statics, small_tracking_scene, track_rows, with_overrides


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


@pytest.fixture(scope='module')
def scene():
    return small_tracking_scene()


def _jax_frames(multi, frames):
    reset_track_ids()
    with jax_f32():
        return decode_frames(multi, frames, lambda f: f)


def _port_frames(multi, frames):
    reset_track_ids()
    return decode_frames(multi, frames, torch.from_numpy)


def _assert_sequences_equal(ours, ref):
    assert len(ours) == len(ref)
    for t, (o, r) in enumerate(zip(ours, ref)):
        poses, ids = track_rows(r)
        assert_tracking_frame(o, poses, ids, label=f'frame {t}')


@pytest.mark.parametrize('config', list(TRACKING_CONFIGS))
def test_trackingpose_matches_jax(scene, config):
    flags, dataset = TRACKING_CONFIGS[config]
    kw = dict(flags=flags, dataset=dataset, overrides=TRACKING_TEST_BUDGETS)
    ref = _jax_frames(jax_tracking_decoder(GOLDEN_STRIDE, **kw), scene)
    ours = _port_frames(port_tracking_decoder(GOLDEN_STRIDE, **kw), scene)
    _assert_sequences_equal(ours, ref)
    ids = [[a.id_ for a in frame if a.id_ is not None] for frame in ours]
    assert all(len(frame) == 3 for frame in ids), ids
    assert len({i for frame in ids for i in frame}) > 3, ids
    if config != 'single_seed':
        # a track kept its id (with one seed joint, none links here)
        assert any(set(a) & set(b) for a, b in zip(ids, ids[1:])), ids


def test_multi_concatenates_cifcaf_then_trackingpose(scene):
    multi = port_tracking_decoder(
        GOLDEN_STRIDE, overrides=TRACKING_TEST_BUDGETS)
    reset_track_ids()
    anns = multi.batch_decode([torch.from_numpy(f[None])
                               for f in scene[0]])[0]
    ids = [a.id_ for a in anns]
    assert ids == [None] * 3 + [1, 2, 3]
    assert multi.last_decoder_time == pytest.approx(sum(
        d.last_decoder_time for d in multi.decoders))


@pytest.mark.parametrize('distance', ['euclidean', 'euclidean4', 'crafted',
                                      'oks'])
def test_posesimilarity_matches_jax(scene, distance):
    """Each distance; JAX's ``euclidean4`` raises (its ``configure``
    stores a lambda on the class, which binds as a method), so the JAX
    side of that case is its euclidean distance over the frames
    [-1, -4, -8, -12] that the flag means."""
    trackers = {}
    for name, decoder, factory, metas in (
            ('jax', jax_decoder, jax_decoder.factory,
             jax_tracking_metas(GOLDEN_STRIDE)),
            ('port', port_decoder, port_decoder,
             port_tracking_metas(GOLDEN_STRIDE))):
        jax_euclidean4 = name == 'jax' and distance == 'euclidean4'
        flags = ['--posesimilarity-distance',
                 'euclidean' if jax_euclidean4 else distance]
        parser = argparse.ArgumentParser()
        with restored_statics(*decoder.DECODERS, decoder.pose_distance.Oks):
            factory.cli(parser)
            factory.configure(parser.parse_args(flags))
            tracker, = decoder.PoseSimilarity.from_metas(metas)
        if jax_euclidean4:
            distance_function = decoder.pose_distance.Euclidean(
                track_frames=[-1, -4, -8, -12])
            distance_function.valid_keypoints = \
                tracker.distance_function.valid_keypoints
            distance_function.sigmas = tracker.distance_function.sigmas
            tracker.distance_function = distance_function
        assert type(tracker.distance_function).__name__ == {
            'euclidean4': 'Euclidean'}.get(distance, distance.capitalize())
        trackers[name] = decoder.Multi(with_overrides(
            [tracker], TRACKING_TEST_BUDGETS))
    ref = _jax_frames(trackers['jax'], scene)
    ours = _port_frames(trackers['port'], scene)
    _assert_sequences_equal(ours, ref)
    assert sum(len(frame) for frame in ours) > 0


def test_jax_euclidean4_raises_and_the_port_repairs_it():
    parser = argparse.ArgumentParser()
    flags = ['--posesimilarity-distance', 'euclidean4']
    with restored_statics(*jax_decoder.DECODERS):
        jax_decoder.factory.cli(parser)
        jax_decoder.factory.configure(parser.parse_args(flags))
        with pytest.raises(TypeError):
            jax_decoder.PoseSimilarity.from_metas(
                jax_tracking_metas(GOLDEN_STRIDE))
    parser = argparse.ArgumentParser()
    with restored_statics(*port_decoder.DECODERS):
        port_decoder.cli(parser)
        port_decoder.configure(parser.parse_args(flags))
        tracker, = port_decoder.PoseSimilarity.from_metas(
            port_tracking_metas(GOLDEN_STRIDE))
    assert tracker.distance_function.track_frames == [-1, -4, -8, -12]


def test_eval_reset_restarts_the_sequence(scene):
    """The ``eval_reset`` signal resets every tracker, as in JAX: after it
    the third frame starts a sequence of its own."""
    sides = {}
    for name, build, as_field, signal in (
            ('jax', jax_tracking_decoder, lambda f: f, JaxSignal),
            ('port', port_tracking_decoder, torch.from_numpy, Signal)):
        multi = build(GOLDEN_STRIDE, overrides=TRACKING_TEST_BUDGETS)
        reset_track_ids()
        with jax_f32():
            out = decode_frames(multi, scene[:2], as_field)
            tracker = multi.decoders[1]
            assert tracker.frame_number == 2 and tracker.active
            signal.emit('eval_reset')
            assert tracker.frame_number == 0 and tracker.active == []
            out += decode_frames(multi, scene[2:4], as_field)
        sides[name] = out
    _assert_sequences_equal(sides['port'], sides['jax'])
    assert [a.id_ for a in sides['port'][2]][3:] == [1, 2, 3]


def test_soft_nms_mutates_the_tracks_poses():
    """``soft_nms`` zeroes, in place, the joints of the weaker of two
    overlapping tracks, as JAX's does."""
    from openpifpaf_tpu_torch.annotation import Annotation
    from openpifpaf_tpu_torch.decoder.track_annotation import \
        TrackAnnotation
    from openpifpaf_tpu.annotation import Annotation as JaxAnnotation
    from openpifpaf_tpu.decoder.track_annotation import \
        TrackAnnotation as JaxTrackAnnotation

    rng = np.random.RandomState(4)
    data = np.zeros((2, 17, 3), np.float32)
    data[:, :, :2] = rng.uniform(20.0, 60.0, (17, 2))
    data[1, :, :2] += rng.uniform(-1.0, 1.0, (17, 2))
    data[:, :, 2] = [[0.9], [0.6]]
    data[1, 3, 2] = 0.1
    results = {}
    for name, decoder, annotation, track in (
            ('jax', jax_decoder, JaxAnnotation, JaxTrackAnnotation),
            ('port', port_decoder, Annotation, TrackAnnotation)):
        tracker, = decoder.TrackingPose.factory(
            (jax_tracking_metas if name == 'jax' else port_tracking_metas)(
                GOLDEN_STRIDE))
        tracks = []
        for d in data:
            pose = annotation(tracker.cif_meta.keypoints,
                              tracker.caf_meta.skeleton)
            pose.data[:] = d
            pose.joint_scales[:] = 3.0
            tracks.append(track().add(1, pose))
        tracker.soft_nms(tracks, 1)
        results[name] = np.stack([t.frame_pose[-1][1].data for t in tracks])
    np.testing.assert_array_equal(results['port'], results['jax'])
    assert np.all(results['port'][1, :, 2] == 0.0)
    assert np.all(results['port'][0, :, 2] == 0.9)
