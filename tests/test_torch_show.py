"""The port's ``show/`` against the JAX package's.

The same annotations, made from a numpy seed, are built once as JAX
annotations and once as the port's, and each is drawn with its own
package's painter on an Agg figure of the same size and dpi: the RGBA
buffers must be equal bit for bit (same process, same matplotlib) and the
axes must hold as many artists. Every class option of ``KeypointPainter``
(as ``tests/test_painters.py`` sets them), its instance options and
methods, ``DetectionPainter``, ``CrowdPainter``, ``AnnotationPainter``,
the field primitives, the canvases with ``--save-all`` and the
``--show-*`` flags are covered.
"""

import argparse
import importlib

import numpy as np
import pytest

matplotlib = pytest.importorskip('matplotlib')
matplotlib.use('Agg')
import matplotlib.figure  # noqa: E402
import PIL.Image  # noqa: E402
from matplotlib.backends.backend_agg import FigureCanvasAgg  # noqa: E402

from openpifpaf_tpu import annotation as jax_annotation  # noqa: E402
from openpifpaf_tpu import show as jax_show  # noqa: E402
from openpifpaf_tpu.decoder.cifcaf import CifCaf as JaxCifCaf  # noqa: E402
from openpifpaf_tpu_torch import annotation as port_annotation  # noqa: E402
from openpifpaf_tpu_torch import show as port_show  # noqa: E402
from openpifpaf_tpu_torch.decoder.cifcaf import CifCaf  # noqa: E402
from openpifpaf_tpu_torch.plugins.coco import constants  # noqa: E402

from torch_port_helpers import SHOW_FLAGS, drawing_statics  # noqa: E402

SIDES = ((jax_show, jax_annotation), (port_show, port_annotation))
# the modules (show/__init__ re-exports a function under the name canvas)
jax_canvas = importlib.import_module('openpifpaf_tpu.show.canvas')
port_canvas = importlib.import_module('openpifpaf_tpu_torch.show.canvas')
FIG_SIZE = (4.0, 3.0)
FIG_DPI = 60


@pytest.fixture(autouse=True)
def _restored_drawing_state():
    with drawing_statics('openpifpaf_tpu'), \
            drawing_statics('openpifpaf_tpu_torch'):
        yield


def _person(annotation, seed=0, *, with_order=True):
    rng = np.random.RandomState(seed)
    ann = annotation.Annotation(constants.COCO_KEYPOINTS,
                                constants.COCO_PERSON_SKELETON)
    data = np.zeros((17, 3), np.float32)
    data[:, 0] = 50 + rng.rand(17) * 60
    data[:, 1] = 40 + rng.rand(17) * 120
    data[:, 2] = 0.2 + 0.8 * rng.rand(17)
    data[rng.rand(17) < 0.2, 2] = 0.0
    ann.set(data, joint_scales=2.0 + rng.rand(17) * 6)
    if with_order:
        ann.decoding_order = [
            (0, 1, tuple(data[0]), tuple(data[1])),
            (1, 3, tuple(data[1]), tuple(data[3])),
            (0, 2, tuple(data[0]), tuple(data[2])),
        ]
        ann.frontier_order = [(3, 5), (5, 7), (2, 4)]
    return ann


def _detection(annotation, seed=0):
    rng = np.random.RandomState(seed)
    return annotation.AnnotationDet(constants.COCO_CATEGORIES).set(
        int(rng.randint(1, 80)), float(rng.uniform(0.1, 1.0)),
        np.asarray([10 + 50 * rng.rand(), 10 + 50 * rng.rand(),
                    3 + 60 * rng.rand(), 3 + 60 * rng.rand()]))


def _crowd(annotation, seed=0):
    rng = np.random.RandomState(seed)
    return annotation.AnnotationCrowd(['person']).set(
        1, np.asarray([5 + 20 * rng.rand(), 5 + 20 * rng.rand(),
                       30 + 40 * rng.rand(), 20 + 40 * rng.rand()]))


def _render(paint, size=FIG_SIZE, dpi=FIG_DPI):
    """(RGBA buffer, artist count) of ``paint(ax)`` on a fresh Agg figure."""
    fig = matplotlib.figure.Figure(figsize=size, dpi=dpi)
    FigureCanvasAgg(fig)
    ax = fig.add_axes([0.0, 0.0, 1.0, 1.0])
    ax.set_xlim(0, 200)
    ax.set_ylim(200, 0)
    paint(ax)
    fig.canvas.draw()
    n = (len(ax.lines) + len(ax.patches) + len(ax.texts)
         + len(ax.collections) + len(ax.images))
    return np.asarray(fig.canvas.buffer_rgba()).copy(), n


def _assert_same_drawing(paint):
    """``paint(show, annotation, ax)`` with the JAX package and the port:
    equal RGBA buffers and artist counts; returns the artist count."""
    (ref, n_ref), (out, n_out) = [
        _render(lambda ax, s=show, a=annotation: paint(s, a, ax))
        for show, annotation in SIDES]
    assert n_out == n_ref
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    # the drawing is not empty
    assert (out != 255).any()
    return n_out


#: KeypointPainter's class options, as tests/test_painters.py sets them,
#: and the style options (each set on both packages' class)
KEYPOINT_OPTIONS = [
    {},
    {'show_box': True},
    {'show_joint_scales': True},
    {'show_joint_confidences': True},
    {'show_decoding_order': True},
    {'show_frontier_order': True},
    {'show_only_decoded_connections': True},
    {'monocolor_connections': True},
    {'line_width': 3},
    {'marker_size': 9},
    {'textbox_alpha': 0.9, 'text_color': 'black'},
    {'font_size': 0},
    {'font_size': 14},
    {'solid_threshold': 0.8},
    {'show_box': True, 'show_joint_scales': True,
     'show_joint_confidences': True, 'show_decoding_order': True,
     'show_frontier_order': True, 'show_only_decoded_connections': True,
     'monocolor_connections': True},
]


@pytest.mark.parametrize('options', KEYPOINT_OPTIONS,
                         ids=lambda o: '-'.join(o) or 'defaults')
def test_keypoint_painter_options_equal_jax(options):
    for show, _ in SIDES:
        for k, v in options.items():
            setattr(show.KeypointPainter, k, v)
    n = _assert_same_drawing(lambda show, annotation, ax:
                             show.KeypointPainter().annotation(
                                 ax, _person(annotation)))
    assert n >= 2


@pytest.mark.parametrize('kwargs', [
    {'xy_scale': 0.5}, {'highlight': [0, 5, 9]},
    {'highlight': [1, 2], 'highlight_invisible': True}],
    ids=['xy_scale', 'highlight', 'highlight_invisible'])
def test_keypoint_painter_instance_options_equal_jax(kwargs):
    _assert_same_drawing(lambda show, annotation, ax:
                         show.KeypointPainter(**kwargs).annotation(
                             ax, _person(annotation)))


def test_keypoint_painter_annotations_texts_colors_equal_jax():
    def paint(show, annotation, ax):
        anns = [_person(annotation, seed) for seed in range(3)]
        anns[1].id_ = 7
        anns[2].fixed_score = ''
        show.KeypointPainter().annotations(
            ax, anns, colors=[3, 'red', 11], texts=['a', None, 'c'],
            subtexts=[None, 'sub', None])
        show.KeypointPainter().annotation(ax, anns[0], color='green',
                                          text='t', subtext='s', alpha=0.5)
    _assert_same_drawing(paint)


@pytest.mark.parametrize('show_box', [False, True])
def test_keypoint_painter_keypoints_equal_jax(show_box):
    rng = np.random.RandomState(3)
    kps = np.zeros((3, 17, 3), np.float32)
    kps[:, :, 0] = 20 + 150 * rng.rand(3, 17)
    kps[:, :, 1] = 20 + 150 * rng.rand(3, 17)
    kps[:, :, 2] = rng.rand(3, 17)
    for show, _ in SIDES:
        show.KeypointPainter.show_box = show_box
    _assert_same_drawing(lambda show, annotation, ax:
                         show.KeypointPainter().keypoints(
                             ax, kps, skeleton=constants.COCO_PERSON_SKELETON,
                             scores=[0.5, 0.25, 0.75], texts=['x', 'y', 'z']))


def test_detection_painter_equal_jax():
    def paint(show, annotation, ax):
        dets = [_detection(annotation, seed) for seed in range(4)]
        dets[1].id_ = 3
        show.DetectionPainter().annotations(ax, dets)
        show.DetectionPainter(xy_scale=0.5).annotation(
            ax, dets[2], color='red', text='t', subtext='s')
    assert _assert_same_drawing(paint) >= 3 * 5


def test_crowd_painter_equal_jax():
    def paint(show, annotation, ax):
        show.CrowdPainter().annotations(
            ax, [_crowd(annotation, seed) for seed in range(3)],
            colors=[None, 2, 'blue'])
        show.CrowdPainter(alpha=0.2, color='green').annotation(
            ax, _crowd(annotation, 5), text='t')
        show.CrowdPainter.draw_polygon(
            ax, [np.asarray([[0.0, 0.0], [50.0, 10.0], [20.0, 60.0]])],
            alpha=0.3, color='purple')
    _assert_same_drawing(paint)


@pytest.mark.parametrize('colors', ['indices', 'color', 'colors'])
def test_annotation_painter_dispatch_equal_jax(colors):
    def paint(show, annotation, ax):
        anns = [_person(annotation, 0), _detection(annotation, 1),
                _crowd(annotation, 2), _person(annotation, 3),
                _detection(annotation, 4)]
        kwargs = {'indices': {}, 'color': {'color': 'grey'},
                  'colors': {'colors': [1, 'red', 'green', 4, 5],
                             'texts': ['a', 'b', 'c', 'd', 'e']}}[colors]
        show.AnnotationPainter().annotations(ax, anns, **kwargs)
    _assert_same_drawing(paint)


def test_painters_registry_names_the_annotation_classes():
    assert set(port_show.PAINTERS) == set(jax_show.PAINTERS) == {
        'Annotation', 'AnnotationDet', 'AnnotationCrowd'}
    for name, painter in port_show.PAINTERS.items():
        assert hasattr(port_annotation, name)
        assert painter.__name__ == jax_show.PAINTERS[name].__name__
        assert painter.__module__.startswith('openpifpaf_tpu_torch.')


def test_field_primitives_equal_jax():
    rng = np.random.RandomState(4)
    vectors = rng.uniform(0, 12, (2, 9, 11)).astype(np.float32)
    vectors[0, 2, 3] = np.nan
    confidence = rng.rand(9, 11).astype(np.float32)
    scales = rng.uniform(-0.5, 3.0, (9, 11)).astype(np.float32)
    scales[1, 1] = np.inf

    def paint(show, annotation, ax):
        show.white_screen(ax, alpha=0.5)
        show.fields.white_screen(ax, alpha=0.3)
        show.quiver(ax, vectors, confidence_field=confidence, xy_scale=8.0,
                    threshold=0.3)
        show.quiver(ax, vectors, step=2, uv_is_offset=True, xy_scale=8.0,
                    reg_uncertainty=scales)
        show.boxes(ax, scales, regression_field=vectors,
                   confidence_field=confidence, xy_scale=8.0)
        show.boxes(ax, scales, xy_scale=8.0, fill=True, color='red')
        show.circles(ax, scales, confidence_field=confidence, xy_scale=8.0)
    _assert_same_drawing(paint)


def _saved(directory):
    names = sorted(p.name for p in directory.iterdir())
    return names, [np.asarray(PIL.Image.open(directory / n))
                   for n in names]


def test_canvases_save_all_equal_jax(tmp_path):
    """``image_canvas``, ``canvas`` (with and without margins) and
    ``annotation_canvas`` under ``--save-all``, with a white overlay and a
    minimum dpi: the same files, pixel-equal."""
    rng = np.random.RandomState(5)
    image = rng.randint(0, 256, (97, 129, 3), dtype=np.uint8)
    for show, annotation in SIDES:
        side = 'jax' if show is jax_show else 'port'
        module = jax_canvas if show is jax_show else port_canvas
        module.SAVE_ALL.update(dir=str(tmp_path / side), count=0)
        module.CONFIG.update(white_overlay=0.5, image_min_dpi=30.0,
                             out_file_extension='png')
        ann = _person(annotation)
        painter = show.KeypointPainter()
        with show.image_canvas(image, show=False) as ax:
            painter.annotation(ax, ann)
        with show.image_canvas(image, show=False, dpi_factor=2.0,
                               fig_width=4.0) as ax:
            painter.annotation(ax, ann)
        with show.canvas(show=False, figsize=(3, 2)) as ax:
            ax.plot([0, 1], [1, 0])
        with show.canvas(show=False, nomargin=True, figsize=(3, 2)) as ax:
            ax.plot([0, 1], [0, 1])
        with show.Canvas.annotation(ann, show=False) as ax:
            painter.annotation(ax, ann)
    names, ref = _saved(tmp_path / 'jax')
    names_port, out = _saved(tmp_path / 'port')
    assert names_port == names == [f'{i:04d}.png' for i in range(1, 6)]
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)


def test_canvas_without_matplotlib_raises(monkeypatch):
    monkeypatch.setattr(port_canvas, 'plt', None)
    with pytest.raises(ImportError):
        with port_show.canvas(show=False):
            pass
    with pytest.raises(ImportError):
        with port_show.image_canvas(np.zeros((4, 4, 3)), show=False):
            pass


def test_virtualcam_without_pyvirtualcam_raises(monkeypatch):
    from openpifpaf_tpu_torch.show import animation_frame
    monkeypatch.setattr(animation_frame, 'pyvirtualcam', None)
    fig = matplotlib.figure.Figure(figsize=(2, 2), dpi=20)
    writer = port_show.VirtualCamWriter(fps=10)
    writer.setup(fig, 'virtualcam')
    with pytest.raises(ImportError, match='pyvirtualcam'):
        writer.grab_frame()
    writer.finish()


STATE = ('textbox_alpha', 'text_color', 'font_size', 'monocolor_connections',
         'line_width', 'solid_threshold', 'show_frontier_order', 'show_box',
         'show_joint_scales', 'show_joint_confidences',
         'show_decoding_order', 'show_only_decoded_connections')


def _configured_state(show, canvas, decoder_cls, argv):
    parser = argparse.ArgumentParser()
    show.cli(parser)
    args = parser.parse_args(argv)
    show.configure(args)
    return (vars(args), {k: getattr(show.KeypointPainter, k) for k in STATE},
            (show.AnimationFrame.video_fps, show.AnimationFrame.video_dpi),
            dict(canvas.SAVE_ALL), dict(canvas.CONFIG),
            decoder_cls.export_decoding_order)


@pytest.mark.parametrize('argv', [[], list(SHOW_FLAGS),
                                  ['--show-frontier-order'],
                                  ['--show-only-decoded-connections']],
                         ids=['defaults', 'all', 'frontier', 'only_decoded'])
def test_show_cli_configures_as_jax(argv):
    """Every ``--show-*`` flag parses and sets the same state as in JAX;
    the decoding-order overlays switch on the decoder's order export."""
    ref = _configured_state(jax_show, jax_canvas, JaxCifCaf, argv)
    out = _configured_state(port_show, port_canvas, CifCaf, argv)
    assert out == ref
    assert out[-1] == bool(argv)
