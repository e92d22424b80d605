"""The drawing entry points of the port against the JAX package's.

A narrow ShuffleNetV2K with random flax weights, its heads made to decode
to whole people (``torch_port_helpers.posed_head``), bridged to the port
with ``convert_jax.state_dict_from_jax``, serves both CLIs on ``--device
cpu`` with the decoder thresholds lowered and pose budgets of 16
(``FLAGS``, as ``chip_smoke.py`` phase 19 serves):

- ``predict -o --show-decoding-order``: the poses pass the pose gate,
  every pose has its decoding order (a growth from one seed that reaches
  every visible joint), equal to JAX's, and each drawing differs from JAX's in at
  most ``PIXEL_SHARE`` of its pixels by at most ``PIXEL_ATOL`` (the two
  frameworks' float32 convolutions move a joint by well under a pixel,
  which changes the antialiasing of a few pixels by one level: measured
  at most 1/255 on 0.007% of the pixels, in PNG). The default JPEG files
  are held to ``JPEG_ATOL``: the encoder spreads a one-level change over
  its 8x8 block (measured 10/255 on 0.18% of the pixels);
- ``video --video-output`` without ``ffmpeg``: one JPEG per frame under
  JAX's names (``JPEG_ATOL``), and with a stub writer registered as
  ``'ffmpeg'`` (for the test only) the ``AnimationFrame`` frames
  (``PIXEL_ATOL``);
- ``eval --eval-show-final-image --eval-show-final-ground-truth``: the
  final image, within that tolerance;
- ``plugins.posetrack.draw_poses.main``: the same files as JAX's,
  pixel-equal;
- every drawing flag parses in the port's CLIs and none raises
  ``NotImplementedError``.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

matplotlib = pytest.importorskip('matplotlib')
matplotlib.use('Agg')
import matplotlib.animation  # noqa: E402
import PIL.Image  # noqa: E402

import openpifpaf_tpu  # noqa: E402
from openpifpaf_tpu import decoder as jax_decoder  # noqa: E402
from openpifpaf_tpu import eval_cli as jax_eval_cli  # noqa: E402
from openpifpaf_tpu import predict as jax_predict  # noqa: E402
from openpifpaf_tpu import show as jax_show  # noqa: E402
from openpifpaf_tpu import video as jax_video  # noqa: E402
from openpifpaf_tpu.models.heads import CompositeField4  # noqa: E402
from openpifpaf_tpu.models.shell import Shell  # noqa: E402
from openpifpaf_tpu.plugins.posetrack import draw_poses as jax_draw_poses  # noqa: E402,E501
from openpifpaf_tpu_torch import compile_cache, datasets, decoder, eval_cli, \
    predict, show, video  # noqa: E402
from openpifpaf_tpu_torch.models import basenetworks, convert_jax  # noqa: E402
from openpifpaf_tpu_torch.models.factory import Factory  # noqa: E402
from openpifpaf_tpu_torch.plugins.coco.constants import \
    cocokp_head_metas  # noqa: E402
from openpifpaf_tpu_torch.plugins.posetrack import draw_poses  # noqa: E402
from openpifpaf_tpu_torch.predictor import Predictor  # noqa: E402

from torch_port_helpers import DEBUG_INDICES_FLAGS, NARROW, SHOW_FLAGS, \
    assert_decoding_order, assert_pose_gate, drawing_statics, \
    jax_f32, one_torch_thread, order_rows, pose_rows, posed_head, \
    restored_statics, write_synthetic_coco  # noqa: E402

FLAGS = ('--seed-threshold', '0.05', '--keypoint-threshold', '0.05',
         '--instance-threshold', '0.001', '--decoder-poses', '16',
         '--decoder-crowd-poses', '16')
#: image tolerance against JAX's drawing: at most this share of the
#: pixels differ, each by at most PIXEL_ATOL of 255
PIXEL_SHARE = 0.005
PIXEL_ATOL = 8
#: the largest difference of a JPEG file of the drawing (same share)
JPEG_ATOL = 16
IMAGE_HW = (97, 129)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


@pytest.fixture(autouse=True)
def _restored_state():
    with drawing_statics('openpifpaf_tpu'), \
            drawing_statics('openpifpaf_tpu_torch'), \
            restored_statics(*jax_decoder.factory.DECODERS,
                             jax_decoder.TrackBase, *decoder.DECODERS,
                             decoder.TrackBase, jax_eval_cli.Evaluator,
                             eval_cli.Evaluator):
        yield


@pytest.fixture(scope='module')
def models():
    """(JAX shell, its flax variables, the port's model) of one narrow
    ShuffleNetV2K with the cocokp heads."""
    metas = openpifpaf_tpu.datasets.factory('cocokp').head_metas
    base = openpifpaf_tpu.models.basenetworks.ShuffleNetV2K(
        stages_repeats=NARROW[0], stages_out_channels=NARROW[1])
    openpifpaf_tpu.models.shell.assign_strides(metas, base.stride)
    model = Shell(base_net=base, head_nets=tuple(
        CompositeField4(meta=m) for m in metas))
    variables = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 65, 65, 3)), train=True))
    for i, meta in enumerate(metas):
        conv = variables['params'][f'head_nets_{i}']['Conv_0']
        conv['kernel'], conv['bias'] = posed_head(conv['kernel'],
                                                  conv['bias'], meta)
    port_model = Factory().from_scratch(
        cocokp_head_metas(), base_net=basenetworks.ShuffleNetV2K(*NARROW))
    port_model.load_state_dict(convert_jax.state_dict_from_jax(variables),
                               strict=True)
    return model, variables, port_model


def _serve_with(monkeypatch, models, *modules):
    """Each module's ``Predictor`` (JAX's or the port's) serves ``models``
    whatever checkpoint its CLI names."""
    model, variables, port_model = models
    for module in modules:
        if module.__name__.startswith('openpifpaf_tpu_torch'):
            monkeypatch.setattr(module, 'Predictor', lambda **kw: Predictor(
                model=port_model, device='cpu'))
        else:
            monkeypatch.setattr(module, 'Predictor', lambda **kw:
                                openpifpaf_tpu.Predictor(model=model,
                                                         variables=variables))


def _recorded_drawings(monkeypatch, show_module):
    """The annotation lists that ``show_module.AnnotationPainter`` draws,
    with the keywords of each call."""
    drawn = []
    original = show_module.AnnotationPainter.annotations

    def annotations(self, ax, anns, **kwargs):
        drawn.append((list(anns), kwargs))
        return original(self, ax, anns, **kwargs)

    monkeypatch.setattr(show_module.AnnotationPainter, 'annotations',
                        annotations)
    return drawn


def _write_images(directory, n, seed):
    rng = np.random.RandomState(seed)
    os.makedirs(directory, exist_ok=True)
    names = []
    for i in range(n):
        name = os.path.join(directory, f'image{i}.jpg')
        PIL.Image.fromarray(rng.randint(0, 256, IMAGE_HW + (3,),
                                        dtype=np.uint8)).save(name)
        names.append(name)
    return names


def _assert_close_images(out, ref, label, atol=PIXEL_ATOL):
    """At most PIXEL_SHARE of the pixels differ, by at most ``atol``;
    returns (share of differing pixels, largest difference)."""
    out, ref = np.asarray(out, np.int16), np.asarray(ref, np.int16)
    assert out.shape == ref.shape, label
    diff = np.abs(out - ref)
    share = float(np.mean(diff.max(axis=-1) > 0))
    assert share <= PIXEL_SHARE and diff.max() <= atol, \
        f'{label}: {share:.4%} of the pixels differ, by up to {diff.max()}'
    return share, int(diff.max())


def _run_jax(monkeypatch, main, argv):
    monkeypatch.setattr(sys, 'argv', ['jax', *argv])
    with jax_f32():
        main()


def test_predict_image_output_matches_jax(models, tmp_path, monkeypatch):
    names = _write_images(str(tmp_path / 'in'), 2, seed=1)
    _serve_with(monkeypatch, models, jax_predict, predict)
    jax_drawn = _recorded_drawings(monkeypatch, jax_show)
    port_drawn = _recorded_drawings(monkeypatch, show)
    for side in ('jax', 'port'):
        os.makedirs(tmp_path / side)
    argv = [*names, '--show-decoding-order', *FLAGS]
    _run_jax(monkeypatch, jax_predict.main,
             [*argv, '-o', str(tmp_path / 'jax')])
    predict.main([*argv, '-o', str(tmp_path / 'port'), '--device', 'cpu'])

    assert len(port_drawn) == len(jax_drawn) == 2
    assert sum(len(anns) for anns, _ in port_drawn) > 0
    for (ours, _), (ref, _) in zip(port_drawn, jax_drawn):
        assert_pose_gate(list(pose_rows(ours)), list(pose_rows(ref)))
        for a in ours:
            assert_decoding_order(a)
        np.testing.assert_array_equal(order_rows(ours), order_rows(ref))
    assert any(a.decoding_order for anns, _ in port_drawn for a in anns)
    for name in names:
        out_name = os.path.basename(name) + '.predictions.jpg'
        out = PIL.Image.open(tmp_path / 'port' / out_name)
        ref = PIL.Image.open(tmp_path / 'jax' / out_name)
        assert out.size == ref.size
        _assert_close_images(out, ref, out_name, JPEG_ATOL)

    # the drawing itself, lossless: -o names a PNG file
    for side in ('jax', 'port'):
        out = [names[0], *argv[2:], '-o', str(tmp_path / f'{side}.png')]
        if side == 'jax':
            _run_jax(monkeypatch, jax_predict.main, out)
        else:
            predict.main([*out, '--device', 'cpu'])
    _assert_close_images(PIL.Image.open(tmp_path / 'port.png'),
                         PIL.Image.open(tmp_path / 'jax.png'), 'png')


def _video_frames(tmp_path, n=3):
    names = _write_images(str(tmp_path / 'frames'), n, seed=2)
    return ','.join(names)


def test_video_output_without_ffmpeg_writes_jax_frames(models, tmp_path,
                                                       monkeypatch):
    monkeypatch.delitem(matplotlib.animation.writers._registered, 'ffmpeg',
                        raising=False)
    assert 'ffmpeg' not in matplotlib.animation.writers.list()
    source = _video_frames(tmp_path)
    _serve_with(monkeypatch, models, jax_video, video)
    for side in ('jax', 'port'):
        os.makedirs(tmp_path / side)
    argv = ['--source', source, *FLAGS]
    _run_jax(monkeypatch, jax_video.main,
             [*argv, '--video-output', str(tmp_path / 'jax' / 'out.mp4')])
    video.main([*argv, '--video-output', str(tmp_path / 'port' / 'out.mp4'),
                '--device', 'cpu'])
    names = sorted(os.listdir(tmp_path / 'jax'))
    assert names == [f'out.mp4.{i:06d}.jpg' for i in (1, 2, 3)]
    assert sorted(os.listdir(tmp_path / 'port')) == names
    for name in names:
        _assert_close_images(PIL.Image.open(tmp_path / 'port' / name),
                             PIL.Image.open(tmp_path / 'jax' / name), name,
                             JPEG_ATOL)


class StubWriter:
    """A writer registered as ``'ffmpeg'``: keeps each grabbed frame."""

    frames = []

    def __init__(self, fps=None, **kwargs):
        self.fps = fps
        self.fig = None

    @classmethod
    def isAvailable(cls):
        return True

    def setup(self, fig, outfile, dpi=None):
        self.fig = fig
        self.frames.append(('setup', outfile, dpi, self.fps))

    def grab_frame(self, **kwargs):
        self.fig.canvas.draw()
        self.frames.append(np.asarray(self.fig.canvas.buffer_rgba()).copy())

    def finish(self):
        self.frames.append('finish')


@pytest.mark.parametrize('separate_debug_ax', [False, True],
                         ids=['one_axis', 'separate_debug_ax'])
def test_video_output_through_animation_frame_matches_jax(
        models, tmp_path, monkeypatch, separate_debug_ax):
    monkeypatch.setitem(matplotlib.animation.writers._registered, 'ffmpeg',
                        StubWriter)
    assert 'ffmpeg' in matplotlib.animation.writers.list()
    source = _video_frames(tmp_path)
    _serve_with(monkeypatch, models, jax_video, video)
    argv = ['--source', source, '--video-output', str(tmp_path / 'out.mp4'),
            *FLAGS] + (['--separate-debug-ax'] if separate_debug_ax else [])
    frames = {}
    for side in ('jax', 'port'):
        StubWriter.frames = []
        if side == 'jax':
            _run_jax(monkeypatch, jax_video.main, argv)
            frames[side] = StubWriter.frames
        else:
            video.main([*argv, '--device', 'cpu'])
            frames[side] = StubWriter.frames
    ours, ref = frames['port'], frames['jax']
    assert ours[0] == ref[0] == ('setup', str(tmp_path / 'out.mp4'), 100, 10)
    assert ours[-1] == ref[-1] == 'finish'
    assert len(ours) == len(ref) == 5
    for i, (o, r) in enumerate(zip(ours[1:-1], ref[1:-1])):
        _assert_close_images(o, r, f'frame {i}')
    assert not os.path.exists(tmp_path / 'jax')


def test_eval_final_image_matches_jax(models, tmp_path, monkeypatch):
    ann_file, image_dir = write_synthetic_coco(
        str(tmp_path / 'coco'), n_images=2, image_hw=IMAGE_HW, seed=3)
    _serve_with(monkeypatch, models, jax_eval_cli, eval_cli)
    jax_drawn = _recorded_drawings(monkeypatch, jax_show)
    port_drawn = _recorded_drawings(monkeypatch, show)
    argv = ['--dataset', 'cocokp', '--cocokp-val-annotations', ann_file,
            '--cocokp-val-image-dir', image_dir, '--eval-loader-warmup', '0',
            '--coco-eval-long-edge', '129', '--eval-show-final-image',
            '--eval-show-final-ground-truth', *FLAGS]
    for side in ('jax', 'port'):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        out = ['--output', str(tmp_path / side / 'eval')]
        with restored_statics(*openpifpaf_tpu.datasets.DATAMODULES.values(),
                              *datasets.datamodules().values()):
            if side == 'jax':
                _run_jax(monkeypatch, jax_eval_cli.main, [*argv, *out])
            else:
                eval_cli.main([*argv, *out, '--device', 'cpu'])
    # the predictions, then the ground truth in grey
    for drawn in (jax_drawn, port_drawn):
        assert [kw for _, kw in drawn] == [{}, {'color': 'grey'}]
        assert len(drawn[1][0]) > 0
    assert_pose_gate(list(pose_rows(port_drawn[0][0])),
                     list(pose_rows(jax_drawn[0][0])))
    name = 'cocokp-eval-final-image.png'
    _assert_close_images(PIL.Image.open(tmp_path / 'port' / name),
                         PIL.Image.open(tmp_path / 'jax' / name), name)


def test_draw_poses_equals_jax(tmp_path):
    jax_draw_poses.main(str(tmp_path / 'jax'))
    draw_poses.main(str(tmp_path / 'port'))
    names = sorted(os.listdir(tmp_path / 'jax'))
    assert names == sorted(
        [f'{n}.png' for n, _ in draw_poses.skeleton_figures()]
        + ['skeleton_overview.png'])
    assert sorted(os.listdir(tmp_path / 'port')) == names
    for name in names:
        np.testing.assert_array_equal(
            np.asarray(PIL.Image.open(tmp_path / 'port' / name)),
            np.asarray(PIL.Image.open(tmp_path / 'jax' / name)),
            err_msg=name)


#: every drawing flag of the predict CLI
PREDICT_DRAW_FLAGS = ['-o', 'out/', *SHOW_FLAGS, *DEBUG_INDICES_FLAGS]


def test_predict_cli_parses_every_drawing_flag_as_jax(monkeypatch):
    from openpifpaf_tpu import visualizer as jax_visualizer
    from openpifpaf_tpu_torch import visualizer
    monkeypatch.setattr(sys, 'argv', ['jax', 'image.jpg',
                                      *PREDICT_DRAW_FLAGS])
    ref = vars(jax_predict.cli())
    out = vars(predict.cli(['image.jpg', *PREDICT_DRAW_FLAGS]))
    for key, value in ref.items():
        if key in out and key != 'xla_compilation_cache':
            assert out[key] == value, key
    # the flag's name is JAX's; in the port it is the kernel build directory
    assert out['xla_compilation_cache'] == compile_cache.DEFAULT_DIR
    drawing = {'image_output', 'show', 'save_all', 'debug_indices',
               'white_overlay', 'show_decoding_order', 'video_fps'}
    assert drawing <= set(out)
    assert visualizer.Base.all_indices == jax_visualizer.Base.all_indices \
        == [('cif', 0, 'all'), ('caf', 1, 'confidence')]
    assert decoder.CifCaf.export_decoding_order
    assert show.KeypointPainter.show_joint_confidences
    parsed = predict.cli(['image.jpg', '-o'])
    assert parsed.image_output is True and not parsed.show


@pytest.mark.parametrize('argv', [
    ['--video-output'], ['--video-output', 'v.mp4', '--separate-debug-ax'],
    ['--show']], ids=['default_name', 'named', 'show'])
def test_video_cli_parses_the_drawing_flags(argv):
    args = video.cli(['--source', 'a.jpg', *argv, '--device', 'cpu'])
    if argv[0] == '--show':
        assert args.show and args.video_output is None
    else:
        assert args.video_output == (argv[1] if len(argv) > 1
                                     else 'a.jpg.pifpaf.mp4')
        assert args.separate_debug_ax == ('--separate-debug-ax' in argv)


def test_saved_json_unchanged_by_drawing(models, tmp_path, monkeypatch):
    """``-o`` with ``--json-output``: the JSON is what ``--json-output``
    alone writes."""
    names = _write_images(str(tmp_path / 'in'), 1, seed=4)
    _serve_with(monkeypatch, models, predict)
    out = {}
    for label, extra in (('plain', []), ('drawn', ['-o', str(tmp_path)])):
        os.makedirs(tmp_path / label)
        predict.main([*names, '--json-output', str(tmp_path / label),
                      '--device', 'cpu', *FLAGS, *extra])
        with open(tmp_path / label / 'image0.jpg.predictions.json') as f:
            out[label] = json.load(f)
    assert out['plain'] == out['drawn'] and out['plain']
    # 10 inches wide at the minimum dpi (50): the image is narrower than
    # 500 px
    width, _ = PIL.Image.open(tmp_path / 'image0.jpg.predictions.jpg').size
    assert width == 500
