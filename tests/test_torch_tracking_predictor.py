"""The tracking Predictor and the video CLI of the PyTorch port against the
JAX package.

A resnet18 tracking model (the cocokpst heads) with random flax weights
(confidence biases shifted, ``BIAS``, and decoder thresholds lowered,
``FLAGS``, so that tens of poses come out) is saved as a JAX
checkpoint and converted with ``orbax_to_port_checkpoint``. Both
``Predictor(checkpoint=...)`` serve the same frames one at a time: the
fields must agree within 1e-4 of each head's largest value (float32
convolutions in two frameworks; the Tcaf head sees the cached features of
the previous frame) and the annotations, with their track ids, must be
equal up to ``json_data``'s rounding, across an ``eval_reset`` and a
change of resolution. (Random weights make no track good enough to be
reported; ``test_torch_tracking_decode.py`` holds the tracked ids.)
``video.py --device cpu`` on still images writes JAX's JSON lines.
"""

import json
import os
import sys

import numpy as np
import PIL.Image
import pytest
import torch

import openpifpaf_tpu
from openpifpaf_tpu import decoder as jax_decoder
from openpifpaf_tpu import video as jax_video
from openpifpaf_tpu.signal_ import Signal as JaxSignal
from openpifpaf_tpu_torch import decoder as port_decoder
from openpifpaf_tpu_torch import video
from openpifpaf_tpu_torch.models.tracking import TrackingShell
from openpifpaf_tpu_torch.predictor import Predictor
from openpifpaf_tpu_torch.signal_ import Signal

from torch_port_helpers import assert_pose_gate, drawing_statics, \
    jax_f32, jax_tracking_checkpoints, jax_tracking_metas, one_torch_thread, \
    pose_rows, reset_track_ids, restored_statics

#: decoder flags that keep poses in the decode of random-weight fields
#: added to the heads' confidence biases: a few tens of poses per frame
BIAS = -3.0
FLAGS = ('--seed-threshold', '0.05', '--keypoint-threshold', '0.05',
         '--instance-threshold', '0.001')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


@pytest.fixture(scope='module')
def checkpoints(tmp_path_factory):
    """(JAX checkpoint, the port's conversion of it)."""
    return jax_tracking_checkpoints(str(tmp_path_factory.mktemp('tracking')),
                                    jax_tracking_metas(16), bias=BIAS)


def _configured(decoder, factory, flags, build):
    """``build()`` while ``flags`` configure the decoders (the class
    settings are put back after)."""
    import argparse
    parser = argparse.ArgumentParser()
    with restored_statics(*decoder.DECODERS):
        factory.cli(parser)
        factory.configure(parser.parse_args(list(flags)))
        return build()


def _frames():
    rng = np.random.RandomState(9)
    small = [rng.randint(0, 256, (97, 129, 3), dtype=np.uint8)
             for _ in range(3)]
    large = [rng.randint(0, 256, (113, 161, 3), dtype=np.uint8)
             for _ in range(2)]
    return small, large


def _serve(predictor, images, signal=None):
    """Each image as a request of its own; (fields, annotations) per
    image. ``signal`` is emitted as 'eval_reset' before the first."""
    seen = []
    fields_batch = predictor.fields_batch

    def recording(image_batch):
        fields = fields_batch(image_batch)
        seen.append([np.asarray(f) for f in fields])
        return fields

    predictor.fields_batch = recording
    if signal is not None:
        signal.emit('eval_reset')
    out = [next(iter(predictor.numpy_images([im])))[0] for im in images]
    return list(zip(seen, out))


def _assert_annotations_equal(ours, theirs):
    """Equal ids, and the poses within the gate (order-free: the decode of
    random-weight fields gives poses of equal scores)."""
    assert sorted(-1 if a.id_ is None else a.id_ for a in ours) == \
        sorted(-1 if a.id_ is None else a.id_ for a in theirs)
    assert_pose_gate(list(pose_rows(ours)), list(pose_rows(theirs)))


def _assert_json_equal(ours, theirs):
    """``json_data`` predictions alike, each matched to the nearest
    unused one: json_data rounds coordinates to 2 digits and scores to 3,
    so a last-bit float difference may land one rounding step apart."""
    assert len(ours) == len(theirs)
    unused = list(theirs)
    for a in ours:
        b = min(unused, key=lambda b: np.abs(
            np.subtract(a['keypoints'], b['keypoints'])).max())
        unused.remove(b)
        assert set(a) == set(b)
        np.testing.assert_allclose(a['keypoints'], b['keypoints'],
                                   atol=0.0101, rtol=0)
        np.testing.assert_allclose(a['bbox'], b['bbox'], atol=0.0101,
                                   rtol=0)
        assert abs(a['score'] - b['score']) <= 0.00101


def test_tracking_predictor_matches_jax(checkpoints):
    src, dst = checkpoints
    jax_predictor = _configured(
        jax_decoder, jax_decoder.factory, FLAGS,
        lambda: openpifpaf_tpu.Predictor(checkpoint=src))
    jax_predictor.pipeline_decode = False
    port = _configured(port_decoder, port_decoder, FLAGS,
                       lambda: Predictor(checkpoint=dst, device='cpu'))
    assert isinstance(port.model, TrackingShell)
    assert [type(d).__name__ for d in port.processor.decoders] == \
        [type(d).__name__ for d in jax_predictor.processor.decoders] == \
        ['CifCaf', 'TrackingPose']
    small, large = _frames()
    reset_track_ids()
    with jax_f32():
        ref = _serve(jax_predictor, small) \
            + _serve(jax_predictor, large, JaxSignal)
    reset_track_ids()
    ours = _serve(port, small) + _serve(port, large, Signal)
    assert len(ours) == len(ref) == 5
    for i, ((fields, anns), (ref_fields, ref_anns)) in enumerate(
            zip(ours, ref)):
        assert [f.shape for f in fields] == [f.shape for f in ref_fields]
        for f, r in zip(fields, ref_fields):
            np.testing.assert_allclose(f, r, rtol=0,
                                       atol=1e-4 * np.abs(r).max(),
                                       err_msg=f'frame {i}')
        _assert_annotations_equal(anns, ref_anns)
        assert len(anns) > 0
    assert ours[1][0][2].shape == (1, 17, 8, 9, 9)
    assert ours[3][0][2].shape == (1, 17, 8, 9, 17)
    tracker = port.processor.decoders[1]
    assert tracker.frame_number == \
        jax_predictor.processor.decoders[1].frame_number == 2


def test_tracking_predictor_cache(checkpoints):
    """The previous frame's features stay cached on the device; a frame
    pairs with itself first, after ``eval_reset`` and after a change of
    resolution."""
    _, dst = checkpoints
    port = Predictor(checkpoint=dst, device='cpu')
    small, large = _frames()
    images = [port.preprocess(im, [], None)[0] for im in small + large]

    def tcaf(image):
        return port.fields_batch(image[None])[2]

    def alone(image):
        fresh = Predictor(checkpoint=dst, device='cpu')
        return fresh.fields_batch(image[None])[2]

    first = tcaf(images[0])
    torch.testing.assert_close(first, alone(images[0]))
    second = tcaf(images[1])
    assert not torch.allclose(second, alone(images[1]))
    Signal.emit('eval_reset')
    assert port._prev_feats is None
    torch.testing.assert_close(tcaf(images[2]), alone(images[2]))
    torch.testing.assert_close(tcaf(images[3]), alone(images[3]))
    with pytest.raises(AssertionError, match='one frame at a time'):
        port.fields_batch(np.stack(images[:2]))


def _write_frames(directory, images):
    names = []
    for i, image in enumerate(images):
        name = str(directory / f'frame{i}.jpg')
        PIL.Image.fromarray(image).save(name, quality=95)
        names.append(name)
    return ','.join(names)


def _json_lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_video_cli_matches_jax(checkpoints, tmp_path, monkeypatch):
    src, dst = checkpoints
    small, _ = _frames()
    source = _write_frames(tmp_path, small)
    out_jax, out_port = str(tmp_path / 'jax.json'), str(tmp_path / 'p.json')
    with restored_statics(*jax_decoder.DECODERS, jax_decoder.TrackBase):
        monkeypatch.setattr(sys, 'argv', [
            'video', '--source', source, '--checkpoint', src,
            '--json-output', out_jax, *FLAGS])
        reset_track_ids()
        with jax_f32():
            jax_video.main()
    with restored_statics(*port_decoder.DECODERS, port_decoder.TrackBase):
        reset_track_ids()
        video.main(['--source', source, '--checkpoint', dst,
                    '--json-output', out_port, '--device', 'cpu', *FLAGS])
    ours, ref = _json_lines(out_port), _json_lines(out_jax)
    assert [line['frame'] for line in ours] == \
        [line['frame'] for line in ref] == [1, 2, 3]
    assert sum(len(line['predictions']) for line in ours) > 0
    for line, ref_line in zip(ours, ref):
        _assert_json_equal(line['predictions'], ref_line['predictions'])


def test_video_cli_runs_on_the_card_unless_told(tmp_path, monkeypatch):
    """Without ``--device cpu`` and a card it raises; on the CPU
    ``--video-output`` (here without ``ffmpeg``: one JPEG per frame) and
    ``--show`` draw each frame."""
    import matplotlib.animation
    from openpifpaf_tpu_torch import show
    source = _write_frames(tmp_path, _frames()[0][:1])
    monkeypatch.delitem(matplotlib.animation.writers._registered, 'ffmpeg',
                        raising=False)
    drawn = []
    annotations = show.AnnotationPainter.annotations
    monkeypatch.setattr(show.AnnotationPainter, 'annotations',
                        lambda self, ax, anns, **kw: drawn.append(ax)
                        or annotations(self, ax, anns, **kw))
    with restored_statics(*port_decoder.DECODERS, port_decoder.TrackBase), \
            drawing_statics('openpifpaf_tpu_torch'):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match='no CUDA device'):
                video.main(['--source', source])
        for flag in ('--video-output', '--show'):
            video.main(['--source', source, '--device', 'cpu', flag])
    assert len(drawn) == 2
    assert os.path.getsize(source + '.pifpaf.mp4.000001.jpg') > 0
