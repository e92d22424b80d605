"""The port's ``visualizer/`` and the decoder's debug hooks against the JAX
package's.

``--debug-indices`` parses into the same requests; each field visualizer
(``Cif``, ``Caf``, ``CifHr``, ``CifDet``, ``Seeds``, ``Occupancy``,
``MultiTracking``, ``Tcaf``) draws seeded numpy fields under
``--save-all`` in both packages, and the files must be the same, pixel
for pixel. ``CifCaf.batch_decode`` of both packages on the same seeded
fields with ``cif:0 caf:0`` saves the same figures; without the flag the
port's decode draws nothing.
"""

import argparse
import importlib
import types

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip('matplotlib')
matplotlib.use('Agg')
import matplotlib.figure  # noqa: E402
import PIL.Image  # noqa: E402
from matplotlib.backends.backend_agg import FigureCanvasAgg  # noqa: E402

from openpifpaf_tpu import annotation as jax_annotation  # noqa: E402
from openpifpaf_tpu import headmeta as jax_headmeta  # noqa: E402
from openpifpaf_tpu import visualizer as jax_visualizer  # noqa: E402
from openpifpaf_tpu_torch import annotation as port_annotation  # noqa: E402
from openpifpaf_tpu_torch import headmeta  # noqa: E402
from openpifpaf_tpu_torch import visualizer  # noqa: E402
from openpifpaf_tpu_torch.plugins.coco import constants  # noqa: E402
from openpifpaf_tpu_torch.predictor import Predictor  # noqa: E402

from torch_port_helpers import drawing_statics, jax_decoder, jax_f32, \
    one_torch_thread, port_decoder  # noqa: E402

STRIDE = 8
FIELD_HW = (9, 11)
SIDES = {'jax': (jax_visualizer, jax_headmeta, jax_annotation,
                 importlib.import_module('openpifpaf_tpu.show.canvas')),
         'port': (visualizer, headmeta, port_annotation,
                  importlib.import_module('openpifpaf_tpu_torch.show.canvas'))}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


@pytest.fixture(autouse=True)
def _restored_drawing_state():
    with drawing_statics('openpifpaf_tpu'), \
            drawing_statics('openpifpaf_tpu_torch'):
        yield


@pytest.mark.parametrize('entries', [
    [], ['cif:0'], ['cif:5,6:confidence,hr', 'caf:1'],
    ['cif,caf:0,3:regression', 'seeds', 'occupancy:2'],
    ['cifdet:79:confidence', 'tcaf:0,1,2']],
    ids=['none', 'one', 'lists', 'heads', 'types'])
def test_debug_indices_parse_as_jax(entries):
    for vis in (jax_visualizer, visualizer):
        parser = argparse.ArgumentParser()
        vis.cli(parser)
        vis.configure(parser.parse_args(
            ['--debug-indices', *entries] if entries else []))
    assert visualizer.Base.all_indices == jax_visualizer.Base.all_indices
    assert bool(visualizer.Base.all_indices) == bool(entries)
    for head in ('cif', 'caf', 'cifdet', 'tcaf'):
        for type_ in (None, 'confidence', 'regression', 'hr'):
            assert visualizer.Base(head).indices(type_) == \
                jax_visualizer.Base(head).indices(type_)


def test_base_state_equal_jax():
    rng = np.random.RandomState(1)
    image = rng.randn(24, 32, 3).astype(np.float32) * 3
    field = rng.rand(5, 7).astype(np.float32)
    for vis in (jax_visualizer, visualizer):
        vis.Base.processed_image(image)
        vis.Base.image(image[:, :, 0], meta={'a': 1})
        vis.Base.ground_truth(['gt'])
    np.testing.assert_array_equal(visualizer.Base.processed_image(),
                                  jax_visualizer.Base.processed_image())
    assert visualizer.Base.processed_image().min() >= 0.0
    assert visualizer.Base.processed_image().max() <= 1.0
    assert visualizer.Base._image_meta == {'a': 1}
    for stride in (1, 2, 8, 16):
        np.testing.assert_array_equal(
            visualizer.Base.scale_scalar(field, stride),
            jax_visualizer.Base.scale_scalar(field, stride))
    visualizer.Base.reset()
    assert visualizer.Base.processed_image() is None
    assert visualizer.Base._ground_truth is None


def _metas(side):
    _, hm, _, _ = SIDES[side]
    cif = hm.Cif('cif', 'cocokp', keypoints=constants.COCO_KEYPOINTS,
                 sigmas=constants.COCO_PERSON_SIGMAS,
                 pose=constants.COCO_UPRIGHT_POSE,
                 draw_skeleton=constants.COCO_PERSON_SKELETON)
    caf = hm.Caf('caf', 'cocokp', keypoints=constants.COCO_KEYPOINTS,
                 sigmas=constants.COCO_PERSON_SIGMAS,
                 pose=constants.COCO_UPRIGHT_POSE,
                 skeleton=constants.COCO_PERSON_SKELETON)
    cifdet = hm.CifDet('cifdet', 'cocodet',
                       categories=constants.COCO_CATEGORIES[:4])
    for meta in (cif, caf, cifdet):
        meta.base_stride = STRIDE
    tcaf = types.SimpleNamespace(name='tcaf', stride=STRIDE)
    return cif, caf, cifdet, tcaf


def _fields(seed):
    rng = np.random.RandomState(seed)
    h, w = FIELD_HW
    grid = np.stack(np.meshgrid(np.arange(w), np.arange(h)))[None]

    def field(n_fields, n_components, regressions):
        f = rng.rand(n_fields, n_components, h, w).astype(np.float32)
        for r in regressions:  # absolute positions near each cell
            f[:, r:r + 2] = grid + rng.uniform(-1.5, 1.5, (n_fields, 2, h, w))
        return f

    return {
        'cif_pred': field(17, 5, (2,)),
        'cif_target': field(17, 5, (1,)) - 0.5,
        'caf_pred': field(19, 8, (2, 4)),
        'caf_target': field(19, 8, (1, 3)) - 0.5,
        'cifdet': field(4, 6, (2,)),
        'hr': rng.rand(17, h * STRIDE, w * STRIDE).astype(np.float32),
        'occupancy': (rng.rand(17, h * 2, w * 2) > 0.7).astype(np.float32),
        'seeds': [(int(rng.randint(17)), float(rng.rand()),
                   float(rng.uniform(0, w * STRIDE)),
                   float(rng.uniform(0, h * STRIDE))) for _ in range(6)],
        'image': rng.randn(h * STRIDE, w * STRIDE, 3).astype(np.float32),
    }


def _tracked(annotation):
    rng = np.random.RandomState(3)
    ann = annotation.Annotation(constants.COCO_KEYPOINTS,
                                constants.COCO_PERSON_SKELETON)
    data = np.stack([rng.uniform(5, 80, 17), rng.uniform(5, 65, 17),
                     rng.uniform(0.2, 1.0, 17)], 1)
    ann.set(data, joint_scales=rng.uniform(1, 4, 17))
    ann.id_ = 4
    det = annotation.AnnotationDet(['person', 'car']).set(
        2, 0.6, np.asarray([10.0, 12.0, 30.0, 20.0]))
    return [ann, det]


DEBUG_INDICES = ['cif:0,3', 'caf:1', 'cifdet:2', 'cifhr:5',
                 'seeds:0', 'occupancy:4', 'multitracking:0', 'tcaf:2']


def _draw_all(side, directory, backdrop):
    vis, _, annotation, canvas = SIDES[side]
    canvas.SAVE_ALL.update(dir=str(directory), count=0)
    canvas.CONFIG['out_file_extension'] = 'png'
    vis.Base.set_all_indices(DEBUG_INDICES)
    fields = _fields(7)
    vis.Base.reset()
    if backdrop:
        vis.Base.processed_image(fields['image'])
    cif, caf, cifdet, tcaf = _metas(side)
    vis.Cif(cif).predicted(fields['cif_pred'])
    vis.Cif(cif).targets(fields['cif_target'])
    vis.Caf(caf).predicted(fields['caf_pred'])
    vis.Caf(caf).targets(fields['caf_target'])
    vis.CifDet(cifdet).predicted(fields['cifdet'])
    vis.CifDet(cifdet).targets(fields['cifdet'][:, 1:])
    vis.CifHr(stride=STRIDE).predicted(fields['hr'])
    vis.CifHr(stride=STRIDE).predicted(fields['hr'], low=0.2)
    vis.Seeds(stride=STRIDE).predicted(fields['seeds'])
    vis.Occupancy().predicted(fields['occupancy'])
    vis.MultiTracking(types.SimpleNamespace(name='multitracking')) \
        .predicted(_tracked(annotation))
    vis.Tcaf(tcaf).predicted(fields['caf_pred'][:3])


def _saved(directory):
    names = sorted(p.name for p in directory.iterdir())
    return names, [np.asarray(PIL.Image.open(directory / n)) for n in names]


@pytest.mark.parametrize('backdrop', [True, False],
                         ids=['processed_image', 'blank'])
def test_field_visualizers_save_the_same_files_as_jax(tmp_path, backdrop):
    for side in SIDES:
        _draw_all(side, tmp_path / side, backdrop)
    names, ref = _saved(tmp_path / 'jax')
    names_port, out = _saved(tmp_path / 'port')
    # cif:0,3 x (confidence, regression) x (predicted, targets) = 8,
    # caf:1 x 2 x 2 = 4, cifdet:2 x 2 = 2, cifhr 2, seeds 1, occupancy 1,
    # multitracking 1, tcaf:2 x 2 = 2
    assert names_port == names == [f'{i:04d}.png' for i in range(1, 22)]
    for name, o, r in zip(names, out, ref):
        np.testing.assert_array_equal(o, r, err_msg=name)


def test_visualizers_draw_on_the_common_axis(tmp_path):
    """``Base.common_ax`` (the video's debug axis): every plot goes on it
    and no file is written."""
    fig = matplotlib.figure.Figure(figsize=(3, 2), dpi=40)
    FigureCanvasAgg(fig)
    ax = fig.add_axes([0.0, 0.0, 1.0, 1.0])
    visualizer.Base.common_ax = ax
    importlib.import_module('openpifpaf_tpu_torch.show.canvas').SAVE_ALL \
        .update(dir=str(tmp_path / 'none'), count=0)
    visualizer.Base.set_all_indices(['cif:0'])
    cif, _, _, _ = _metas('port')
    visualizer.Cif(cif).predicted(_fields(1)['cif_pred'])
    assert len(ax.images) == 1 and len(ax.patches) > 1
    assert not (tmp_path / 'none').exists()


def _decoder_fields(seed):
    rng = np.random.RandomState(seed)
    cif = rng.rand(1, 17, 5, *FIELD_HW).astype(np.float32)
    caf = rng.rand(1, 19, 8, *FIELD_HW).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(FIELD_HW[1]),
                                np.arange(FIELD_HW[0])))
    cif[:, :, 2:4] = grid + rng.uniform(-1, 1, (1, 17, 2, *FIELD_HW))
    caf[:, :, 2:4] = grid + rng.uniform(-1, 1, (1, 19, 2, *FIELD_HW))
    caf[:, :, 4:6] = grid + rng.uniform(-1, 1, (1, 19, 2, *FIELD_HW))
    return cif, caf


def test_decoder_hook_saves_the_same_figures_as_jax(tmp_path):
    """``--debug-indices cif:0 caf:0``: both decoders draw batch element 0
    of their fields (the port's copied to the host) before decoding."""
    cif, caf = _decoder_fields(2)
    backdrop = np.random.RandomState(4).randn(
        FIELD_HW[0] * STRIDE, FIELD_HW[1] * STRIDE, 3).astype(np.float32)
    jax_dec, port_dec = jax_decoder(STRIDE), port_decoder(STRIDE)
    for side, run in (
            ('jax', lambda: jax_dec.batch_decode([cif, caf])),
            ('port', lambda: port_dec.batch_decode(
                [torch.from_numpy(cif), torch.from_numpy(caf)]))):
        vis, _, _, canvas = SIDES[side]
        canvas.SAVE_ALL.update(dir=str(tmp_path / side), count=0)
        canvas.CONFIG['out_file_extension'] = 'png'
        vis.Base.set_all_indices(['cif:0', 'caf:0'])
        vis.Base.processed_image(backdrop)
        with jax_f32():
            run()
    names, ref = _saved(tmp_path / 'jax')
    names_port, out = _saved(tmp_path / 'port')
    # cif:0 and caf:0, each its confidence and its regression
    assert names_port == names == [f'{i:04d}.png' for i in range(1, 5)]
    for name, o, r in zip(names, out, ref):
        np.testing.assert_array_equal(o, r, err_msg=name)


def test_decoder_hook_is_off_without_debug_indices(monkeypatch):
    def refuse(self, field):
        raise AssertionError('a visualizer drew without --debug-indices')

    monkeypatch.setattr(visualizer.Cif, 'predicted', refuse)
    monkeypatch.setattr(visualizer.Caf, 'predicted', refuse)
    cif, caf = _decoder_fields(3)
    assert not visualizer.Base.all_indices
    port_decoder(STRIDE).batch_decode([torch.from_numpy(cif),
                                       torch.from_numpy(caf)])


@pytest.mark.parametrize('indices', [[], ['cif:0']], ids=['off', 'on'])
def test_predictor_keeps_the_processed_image_for_the_visualizers(
        monkeypatch, indices):
    """Batch element 0 of the batch is the visualizers' backdrop, kept
    only under ``--debug-indices``."""
    predictor = Predictor.__new__(Predictor)
    seen = []
    monkeypatch.setattr(predictor, 'fields_batch',
                        lambda images: seen.append(
                            visualizer.Base.processed_image()) or [],
                        raising=False)
    predictor.processor = types.SimpleNamespace(
        batch_decode=lambda fields: [[], []], last_decoder_time=0.0)
    predictor.total_nn_time = predictor.total_decoder_time = 0.0
    predictor.last_nn_time = 0.0
    predictor.total_images = 0
    predictor.json_data = False
    visualizer.Base.all_indices = indices
    images = np.random.RandomState(0).randn(2, 16, 24, 3).astype(np.float32)
    out = list(predictor._run_batch((images, [[], []], [{}, {}])))
    assert len(out) == 2
    if indices:
        jax_visualizer.Base.processed_image(images[0])
        np.testing.assert_array_equal(
            seen[0], jax_visualizer.Base.processed_image())
    else:
        assert seen == [None]
