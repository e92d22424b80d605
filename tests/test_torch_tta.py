"""The Predictor's test-time options in the PyTorch port against the JAX
package: the field flips, the hflip TTA, multi-scale, the NN chunks, the
prefetch worker and the image lists.

Tolerances:
- ``pif_hflip``/``paf_hflip`` and the left/right mapping: equal (index
  and sign operations);
- the hflip TTA fields of a narrow ShuffleNetV2K: atol 1e-4, as the
  plain fields in ``test_torch_predictor.py`` (float32 convolutions in
  two frameworks), and the TTA decode's JSON within its rounding step;
- ``--multi-scale`` predictions: the same count, visibility, locations
  within 1e-3 px and confidences within 2e-3 (the tie-free gate of
  ``tests/test_adversarial_parity.py``);
- the scale merges: the same annotations kept, in the same order;
- chunked against unchunked fields, and prefetch on against off: equal.
"""

import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from openpifpaf_tpu import datasets as jax_datasets
from openpifpaf_tpu import transforms as jax_transforms
from openpifpaf_tpu.annotation import Annotation as JaxAnnotation, \
    AnnotationDet as JaxAnnotationDet
from openpifpaf_tpu.models import heads as jax_heads
from openpifpaf_tpu.predictor import Predictor as JaxPredictor
from openpifpaf_tpu_torch import datasets, decoder, predict, transforms
from openpifpaf_tpu_torch.annotation import Annotation, AnnotationDet
from openpifpaf_tpu_torch.datasets import LoaderWithReset
from openpifpaf_tpu_torch.models import heads
from openpifpaf_tpu_torch.plugins.apollocar3d import CAR_KEYPOINTS_66
from openpifpaf_tpu_torch.plugins.coco import constants
from openpifpaf_tpu_torch.predictor import Predictor
from openpifpaf_tpu_torch.signal_ import Signal

import field_fixtures
import torch_port_helpers
from test_torch_predictor import predictors  # noqa: F401 (fixture)
from torch_port_helpers import assert_pose_gate, jax_f32, \
    one_torch_thread, port_narrow_shell, pose_rows, restored_statics

#: 97x113 images: the bucket pad widens the 113 px to 129, so the hflip
#: mirrors padding to the left
IMAGE_HW = (97, 113)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


def _images(n, seed, hw=IMAGE_HW):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, hw + (3,), dtype=np.uint8)
            for _ in range(n)]


# -- the field flips -----------------------------------------------------------

def test_field_hflips_equal_jax():
    """Random (B, F, C, H, W) fields of the cocokp heads; cocokp's
    skeleton has edges whose mirror runs the other way (the shoulders,
    the hips, ...), whose (x1, y1, s1) and (x2, y2, s2) swap."""
    keypoints = list(constants.COCO_KEYPOINTS)
    skeleton = list(constants.COCO_PERSON_SKELETON)
    hflip = Predictor._hflip_mapping(keypoints)
    assert hflip == dict(constants.HFLIP)
    names = [(keypoints[a - 1], keypoints[b - 1]) for a, b in skeleton]
    flipped = [(hflip.get(a, a), hflip.get(b, b)) for a, b in names]
    assert any((b, a) in flipped for a, b in names)
    rng = np.random.RandomState(0)
    cif = rng.randn(2, 17, 5, 7, 9).astype(np.float32)
    caf = rng.randn(2, 19, 8, 7, 9).astype(np.float32)
    np.testing.assert_array_equal(
        heads.pif_hflip(torch.from_numpy(cif), keypoints, hflip).numpy(),
        np.asarray(jax_heads.pif_hflip(jnp.asarray(cif), keypoints, hflip)))
    np.testing.assert_array_equal(
        heads.paf_hflip(torch.from_numpy(caf), keypoints, skeleton,
                        hflip).numpy(),
        np.asarray(jax_heads.paf_hflip(jnp.asarray(caf), keypoints, skeleton,
                                       hflip)))


def _keypoints(name):
    if name == 'apollo66':
        return list(CAR_KEYPOINTS_66)
    return list(datasets.datamodules()[name].keypoints) \
        if name != 'cocokp' else list(constants.COCO_KEYPOINTS)


@pytest.mark.parametrize('name', ['cocokp', 'wholebody', 'crowdpose',
                                  'animal', 'apollo', 'apollo66'])
def test_hflip_mapping_equals_jax(name):
    """The naming heuristic on each plugin's keypoint names."""
    keypoints = _keypoints(name)
    ours = Predictor._hflip_mapping(keypoints)
    assert ours == JaxPredictor._hflip_mapping(keypoints)
    assert all(ours[ours[k]] == k for k in ours)


# -- hflip TTA ----------------------------------------------------------------

@pytest.fixture
def tta(predictors):  # noqa: F811
    jax_predictor, port = predictors
    jax_predictor.hflip_tta = port.hflip_tta = True
    yield jax_predictor, port
    jax_predictor.hflip_tta = port.hflip_tta = False


def test_tta_fields_equal_jax(tta):
    """The padded batch is mirrored as a whole and mapped back with
    ``x_back = (W - 1) - x``; the averaged fields equal JAX's."""
    jax_predictor, port = tta
    batch = np.stack([port.preprocess(im, [], None)[0]
                      for im in _images(2, seed=0)])
    assert batch.shape[1:3] == IMAGE_HW
    with jax_f32():
        ref = jax_predictor.fields_batch(batch)
    out = port.fields_batch(batch)
    port.hflip_tta = False
    plain = port.fields_batch(batch)
    assert [tuple(o.shape) for o in out] == [r.shape for r in ref] == [
        (2, 17, 5, 9, 9), (2, 19, 8, 9, 9)]
    for o, r, p in zip(out, ref, plain):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=0)
        assert not torch.allclose(o, p)


def test_tta_annotations_equal_jax(tta):
    jax_predictor, port = tta
    images = _images(2, seed=1)
    with jax_f32():
        ref = [[a.json_data() for a in pred]
               for pred, _, _ in jax_predictor.numpy_images(images)]
    out = [[a.json_data() for a in pred]
           for pred, _, _ in port.numpy_images(images)]
    assert len(out) == len(ref) == 2
    assert sum(len(anns) for anns in ref) > 0
    for ours, theirs in zip(out, ref):
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a['keypoints'], b['keypoints'],
                                       atol=0.0101, rtol=0)
            assert abs(a['score'] - b['score']) <= 0.00101


def test_tta_keeps_cifdet_and_unmapped_heads(caplog):
    """A CifDet head, and a keypoint head whose names give no left/right
    mapping, keep their direct fields (with JAX's warning, once); a
    tracking model serves without TTA, as JAX's branch order does."""
    metas = datasets.factory('cocokp-cocodet').head_metas
    model = port_narrow_shell(metas)
    predictor = Predictor(model=model, device='cpu')
    batch = np.stack([predictor.preprocess(im, [], None)[0]
                      for im in _images(1, seed=2)])
    plain = predictor.fields_batch(batch)
    predictor.hflip_tta = True
    out = predictor.fields_batch(batch)
    assert torch.equal(out[2], plain[2])
    assert not torch.allclose(out[0], plain[0])

    predictor.hflip_mapping = None
    for meta in predictor.head_metas[:2]:
        meta.keypoints = [f'joint{i}' for i in range(17)]
    with caplog.at_level('WARNING'):
        out = predictor.fields_batch(batch)
        predictor.fields_batch(batch)
    assert all(torch.equal(o, p) for o, p in zip(out, plain))
    assert sum('no left/right mapping' in r.message
               for r in caplog.records) == 2

    tracking = port_narrow_shell(datasets.factory('cocokpst').head_metas)
    served = []
    for hflip_tta in (False, True):
        p = Predictor(model=tracking, device='cpu')
        p.hflip_tta = hflip_tta
        served.append(p.fields_batch(batch))
    assert all(torch.equal(a, b) for a, b in zip(*served))


# -- multi-scale ---------------------------------------------------------------

@pytest.fixture(scope='module')
def image_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('images') / 'image.png')
    PIL.Image.fromarray(_images(1, seed=3, hw=(97, 129))[0]).save(path)
    return path


def _scene_fields(as_tensor):
    """A stand-in for ``fields_batch``: the fields of two people drawn at
    fixed places relative to the image inside the padded batch (its
    padding is 0 after normalisation), the same for both packages, so
    that each scale decodes real poses."""
    def fields_batch(image_batch):
        image_batch = np.asarray(image_batch)
        rows, = np.nonzero(np.abs(image_batch[0]).sum(axis=(1, 2)))
        cols, = np.nonzero(np.abs(image_batch[0]).sum(axis=(0, 2)))
        y0, h = rows[0], rows[-1] + 1 - rows[0]
        x0, w = cols[0], cols[-1] + 1 - cols[0]
        people = [field_fixtures.synthetic_person(
            x0 + fx * w, y0 + 0.5 * h, fh * h, np.random.RandomState(i))
            for i, (fx, fh) in enumerate(((0.3, 0.8), (0.75, 0.6)))]
        cif, caf, _ = field_fixtures.fields_from_annotations(
            [field_fixtures.annotation_dict(kps) for kps in people],
            image_batch.shape[1:3], stride=16)
        return [as_tensor(cif[None]), as_tensor(caf[None])]
    return fields_batch


def test_port_pose_fields_equal_the_jax_fixtures():
    """The scene ``chip_smoke.py`` draws on the card without JAX
    (``port_person``, ``port_pose_fields``) equals the JAX fixtures' on
    the same people: equal fields."""
    cif_meta, caf_meta = constants.cocokp_head_metas()
    for meta in (cif_meta, caf_meta):
        meta.base_stride = 16
    hw = (97, 129)
    people = [(torch_port_helpers.port_person(
        x, 50.0, h, np.random.RandomState(i)), field_fixtures.synthetic_person(
        x, 50.0, h, np.random.RandomState(i)))
        for i, (x, h) in enumerate(((35.0, 70.0), (95.0, 55.0)))]
    for ours, ref in people:
        np.testing.assert_array_equal(ours, ref)
    ours = torch_port_helpers.port_pose_fields(
        [p for p, _ in people], hw, cif_meta, caf_meta)
    ref = field_fixtures.fields_from_annotations(
        [field_fixtures.annotation_dict(r) for _, r in people], hw,
        stride=16)[:2]
    for o, r in zip(ours, ref):
        assert o.shape == r.shape and r[:, 1].max() == 1.0
        np.testing.assert_array_equal(o, r)


def test_multi_scale_predictions_equal_jax(predictors, image_file):  # noqa: F811
    """Long edges 81, 65 and 129 (factors 1, 0.75, 1.5 of 81; each padded
    to the 129 px bucket), each decoded and merged greedily by OKS 0.8;
    ``json_data`` put back. The fields are the same scene of two people
    on both sides (:func:`_scene_fields`)."""
    jax_predictor, port = predictors
    jax_predictor.fields_batch = _scene_fields(jnp.asarray)
    port.fields_batch = _scene_fields(torch.from_numpy)
    for p in predictors:
        p.multi_scale = True
        p.long_edge = 81
    try:
        with jax_f32():
            ref, _, ref_meta = jax_predictor.image(image_file)
        ours, _, meta = port.image(image_file)
        scales = []
        for factor in port.multi_scale_factors:
            port.multi_scale_factors = (factor,)
            scales.append(port.image(image_file)[0])
        port.multi_scale_factors = Predictor.multi_scale_factors
        port.json_data = True
        as_json, _, _ = port.image(image_file)
        assert port.json_data
    finally:
        for p in predictors:
            del p.fields_batch
            p.multi_scale = False
            p.long_edge = None
            p.json_data = False
    assert meta['file_name'] == ref_meta['file_name'] == image_file
    assert [len(anns) for anns in scales] == [2, 2, 2]
    assert 2 <= len(ours) < 6
    assert_pose_gate(pose_rows(ours), pose_rows(ref))
    assert as_json == [a.json_data() for a in ours]


def _poses(rng):
    """(x, y, confidence) rows of six poses: two near-duplicates of one
    person (one with an equal score), a second person and its
    near-duplicate, a pose elsewhere."""
    people = [np.stack([rng.uniform(20, 80, 17), rng.uniform(20, 120, 17)],
                       1) for _ in range(3)]
    rows = []
    for person, offset, conf in ((0, 0.0, 0.9), (0, 0.6, 0.7), (1, 150.0, 0.8),
                                 (0, 0.3, 0.9), (1, 151.0, 0.8),
                                 (2, 400.0, 0.2)):
        xy = people[person] + [offset, 0.0]
        rows.append(np.concatenate([xy, np.full((17, 1), conf)], 1))
    return rows


def test_merges_equal_jax(predictors):  # noqa: F811
    """Hand-built overlaps: near-duplicate poses across scales, equal
    scores (Python's stable sort keeps the first), poses apart; boxes of
    one category overlapping by more and less than IoU 0.7, and of two
    categories overlapping."""
    jax_predictor, port = predictors
    rows = _poses(np.random.RandomState(0))
    kept = {}
    for name, ann_cls, det_cls, p in (
            ('port', Annotation, AnnotationDet, port),
            ('jax', JaxAnnotation, JaxAnnotationDet, jax_predictor)):
        poses = []
        for r in rows:
            ann = ann_cls(list(constants.COCO_KEYPOINTS),
                          list(constants.COCO_PERSON_SKELETON))
            ann.data[:] = r
            poses.append(ann)
        dets = [det_cls(['a', 'b']).set(c, s, b) for c, s, b in (
            (1, 0.9, [10, 10, 50, 50]), (1, 0.8, [12, 12, 50, 50]),
            (1, 0.85, [40, 40, 50, 50]), (2, 0.8, [10, 10, 50, 50]),
            (1, 0.9, [11, 10, 50, 50]))]
        kept[name] = ([poses.index(a) for a in p._merge_annotations(poses)],
                      [dets.index(d) for d in p._merge_detections(dets)])
    assert kept['port'] == kept['jax']
    assert kept['port'] == ([0, 2, 5], [0, 2, 3])


# -- NN chunks ----------------------------------------------------------------

def test_chunked_forward_equals_unchunked(predictors):  # noqa: F811
    """A batch of 16 runs as two forwards of 8, whose fields concatenate
    to the unchunked forward's; a batch of 12 (not a multiple of 8) and
    a batch of 8 (under the threshold) run whole."""
    _, port = predictors
    images = _images(16, seed=4)
    batch = np.stack([port.preprocess(im, [], None)[0] for im in images])
    sizes = []
    forward = port._forward

    def counted(x):
        sizes.append(x.shape[0])
        return forward(x)

    port._forward = counted
    try:
        port.nn_chunk_size = 8
        chunked = port.fields_batch(batch)
        port.fields_batch(batch[:12])
        port.fields_batch(batch[:8])
        port.nn_chunk_size = 0
        whole = port.fields_batch(batch)
    finally:
        del port._forward
        port.nn_chunk_size = Predictor.nn_chunk_size
    assert sizes == [8, 8, 12, 8, 16]
    for c, w in zip(chunked, whole):
        np.testing.assert_array_equal(c.numpy(), w.numpy())


# -- prefetch -----------------------------------------------------------------

def test_prefetch_gives_the_strict_output(predictors):  # noqa: F811
    _, port = predictors
    images = _images(2, seed=5)
    out = {}
    for depth in (2, 0):
        port.prefetch_depth = depth
        out[depth] = [[a.json_data() for a in pred]
                      for pred, _, _ in port.numpy_images(images)]
    port.prefetch_depth = Predictor.prefetch_depth
    assert out[2] == out[0]


def _bare_predictor(depth):
    """A Predictor of the serving loop only (pipelined, the default, and
    strict): each batch 'decodes' to its meta."""
    p = Predictor.__new__(Predictor)
    p.prefetch_depth = depth
    p._run_batch = lambda batch: iter(batch[2])
    p._dispatch_batch = lambda batch: batch
    p._materialize_batch = lambda staged: iter(staged[2])
    return p


def test_prefetch_reraises_on_the_caller_and_stops_its_worker():
    """A worker exception comes after the batches before it; a consumer
    that stops early ends the worker thread."""
    def batches():
        yield [], [], [{'i': 0}]
        yield [], [], [{'i': 1}]
        raise KeyError('broken batch')

    p = _bare_predictor(2)
    seen = []
    with pytest.raises(KeyError, match='broken batch'):
        for meta in p._run_batches(p._prefetched(batches())):
            seen.append(meta['i'])
    assert seen == [0, 1]

    before = threading.active_count()
    endless = ((([], [], [{'i': i}]) for i in range(10 ** 6)))
    gen = p._run_batches(p._prefetched(endless))
    assert next(gen) == {'i': 0}
    gen.close()
    assert threading.active_count() == before


class _Frames:
    """Two sequences of 3 frames, one batch each."""

    def __iter__(self):
        for seq in ('a', 'b'):
            for frame in range(3):
                yield [], [], [{'seq': seq, 'frame': frame}]

    def __len__(self):
        return 6


@pytest.mark.parametrize('depth', [2, 0])
def test_prefetch_resets_after_the_last_frame_of_a_sequence(depth):
    """``LoaderWithReset`` through ``Predictor.dataloader`` with the
    prefetch worker: ``eval_reset`` fires once, after sequence a's third
    frame was decoded and yielded, on the caller's thread (JAX's prefetch
    fires it early, from its worker: ROADMAP §C)."""
    p = _bare_predictor(depth)
    events = []
    saved = dict(Signal.subscribers)
    Signal.subscribers = {'eval_reset': [
        lambda: events.append(('reset', threading.current_thread()))]}
    try:
        for meta in p.dataloader(LoaderWithReset(_Frames(), 'seq')):
            events.append((meta['seq'], meta['frame']))
    finally:
        Signal.subscribers = saved
    assert events == [('a', 0), ('a', 1), ('a', 2),
                      ('reset', threading.current_thread()),
                      ('b', 0), ('b', 1), ('b', 2)]


@pytest.mark.parametrize('depth', [2, 0])
def test_enumerated_dataloader_resets_after_the_last_frame_of_a_sequence(
        depth):
    """``enumerate(LoaderWithReset(...))``, as JAX's evaluator passes it,
    through ``Predictor.enumerated_dataloader``: whatever the prefetch
    depth, the pairs are pulled strictly, so ``eval_reset`` fires after
    sequence a's third frame was decoded and yielded."""
    p = _bare_predictor(depth)
    events = []
    saved = dict(Signal.subscribers)
    Signal.subscribers = {'eval_reset': [lambda: events.append('reset')]}
    try:
        for meta in p.enumerated_dataloader(
                enumerate(LoaderWithReset(_Frames(), 'seq'))):
            events.append((meta['seq'], meta['frame']))
    finally:
        Signal.subscribers = saved
    assert events == [('a', 0), ('a', 1), ('a', 2), 'reset',
                      ('b', 0), ('b', 1), ('b', 2)]


# -- image lists and the entry points ------------------------------------------

def test_image_lists_give_the_same_samples(predictors, image_file):  # noqa: F811
    """``ImageList`` of a file, ``PilImageList`` and ``NumpyImageList`` of
    its pixels give equal samples, equal to JAX's lists'; ``images``,
    ``pil_images`` and ``numpy_images`` answer alike."""
    jax_predictor, port = predictors
    with open(image_file, 'rb') as f:
        pil = PIL.Image.open(f).convert('RGB')
    array = np.asarray(pil)
    samples = []
    for lists, preprocess in ((datasets, port.preprocess),
                              (jax_datasets, jax_predictor.preprocess)):
        for cls, source in ((lists.ImageList, image_file),
                            (lists.PilImageList, pil),
                            (lists.NumpyImageList, array)):
            image, anns, meta = cls([source], preprocess=preprocess)[0]
            samples.append((np.asarray(image), anns, meta))
            raw, *_ = cls([source], preprocess=preprocess,
                          with_raw_image=True)[0]
            np.testing.assert_array_equal(np.asarray(raw), array)
    for image, anns, meta in samples:
        np.testing.assert_array_equal(image, samples[0][0])
        assert anns == []
    assert samples[0][2]['file_name'] == samples[3][2]['file_name'] \
        == image_file
    answers = [[a.json_data() for a in port.image(image_file)[0]],
               [a.json_data() for a in port.pil_image(pil)[0]],
               [a.json_data() for a in port.numpy_image(array)[0]]]
    assert answers[0] == answers[1] == answers[2]


def test_precise_rescaling_resizes_alike():
    """``--precise-rescaling`` is accepted and ignored: as in JAX,
    ``RescaleAbsolute(fast=)`` is never read, and the images equal JAX's
    either way."""
    with restored_statics(*decoder.DECODERS):
        assert predict.cli(['x.jpg', '--precise-rescaling']) \
            .fast_rescaling is False
        assert predict.cli(['x.jpg']).fast_rescaling is True
    image = PIL.Image.fromarray(_images(1, seed=6, hw=(90, 120))[0])
    out = [np.asarray(lib.Compose([
        lib.NormalizeAnnotations(), lib.RescaleAbsolute(97, fast=fast),
    ])(image, [], None)[0]) for lib in (transforms, jax_transforms)
        for fast in (True, False)]
    assert out[0].shape[:2] == (72, 97)
    for o in out[1:]:
        np.testing.assert_array_equal(o, out[0])


def test_predict_cli_takes_the_test_time_flags(image_file, tmp_path):
    """``predict --hflip-tta --multi-scale --precise-rescaling`` reaches
    the Predictor and writes the merged predictions."""
    seen = {}
    images = Predictor.images

    def spy(self, file_names):
        seen.update(hflip_tta=self.hflip_tta, multi_scale=self.multi_scale)
        return images(self, file_names)

    Predictor.images = spy
    try:
        with restored_statics(*decoder.DECODERS):
            predict.main([image_file, '--long-edge', '65', '--hflip-tta',
                          '--multi-scale', '--precise-rescaling',
                          '--device', 'cpu', '--json-output', str(tmp_path)])
    finally:
        Predictor.images = images
    assert seen == {'hflip_tta': True, 'multi_scale': True}
    with open(os.path.join(str(tmp_path), os.path.basename(image_file))
              + '.predictions.json') as f:
        assert isinstance(json.load(f), list)
