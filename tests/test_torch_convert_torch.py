"""The port's reference-checkpoint converter against the JAX package's and
against the reference-layout module itself.

``tests/torch_ref.py`` builds models with the reference's module tree and
dotted names; they are pickled as the reference saves checkpoints (whole
module, ``{'model': shell, 'epoch': 3, 'meta': {...}}``) and go through
three routes on the same numpy input:

  - the ``torch_ref`` module's own forward;
  - the JAX package's ``convert_checkpoint`` and the flax forward, under
    float32 matmul precision;
  - the port's ``convert_checkpoint`` and the port's forward.

Tolerances: the port against ``torch_ref`` within 1e-5 of each output's
largest value (float32 convolutions in one framework, the port's in
``channels_last``), 1e-4 in train mode, where the BatchNorms normalise
by the statistics of one small frame pair and so amplify the summation
order; the port against JAX within 1e-4 of each output's largest value,
the float32 tolerance of the port's other JAX parity tests. The backbone's name and
the head metas recovered from the pickle must equal JAX's. Then the slice
as a whole: ``Predictor(checkpoint='ref.pkl')`` against the JAX package's
``Predictor`` on the same file (poses under the pose gate), and
``train --checkpoint ref.pkl --device cpu`` for one step against the JAX
trainer started from JAX's conversion of the same file.
"""

import functools
import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

import openpifpaf_tpu
import torch_ref
from openpifpaf_tpu.decoder.cifcaf import CifCaf as JaxCifCaf
from openpifpaf_tpu.models import convert_torch as jax_convert
from openpifpaf_tpu.models import factory as jax_factory
from openpifpaf_tpu.models.shell import Shell as JaxShell, \
    assign_strides as jax_assign_strides
from openpifpaf_tpu.models.tracking import TrackingShell as JaxTrackingShell, \
    TBaseSingleImage as JaxTBaseSingleImage, Tcaf as JaxTcaf
from openpifpaf_tpu.plugins.coco.cocokp import CocoKp as JaxCocoKp
from openpifpaf_tpu.training import checkpoint as jax_checkpoint
from openpifpaf_tpu.training import losses as jax_losses
from openpifpaf_tpu.training import optimize as jax_optimize
from openpifpaf_tpu.training.trainer import Trainer as JaxTrainer
from openpifpaf_tpu_torch import train
from openpifpaf_tpu_torch.decoder import CifCaf as TorchCifCaf
from openpifpaf_tpu_torch.logger import JsonFormatter
from openpifpaf_tpu_torch.models import convert_jax, convert_torch
from openpifpaf_tpu_torch.models.tracking import TrackingShell
from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp
from openpifpaf_tpu_torch.plugins.coco.constants import cocokp_head_metas
from openpifpaf_tpu_torch.predictor import Predictor
from openpifpaf_tpu_torch.training import checkpoint

from torch_port_helpers import assert_pose_gate, jax_f32, one_torch_thread, \
    optimizer_args, pose_rows, raise_confidences, reference_k16, \
    restored_statics, save_reference_checkpoint, write_synthetic_coco

BACKBONES = ['shufflenetv2k16', 'resnet18', 'resnet50', 'resnext50',
             'mobilenetv2', 'mobilenetv3large', 'mobilenetv3small',
             'squeezenet']
#: port vs torch_ref, and port vs JAX: share of each output's largest value
TORCH_RTOL = 1e-5
TORCH_TRAIN_RTOL = 1e-4
JAX_RTOL = 1e-4
#: decode thresholds at which random-weight fields keep poses
THRESHOLDS = {'seed_threshold': 0.05, 'keypoint_threshold_nms': 0.05,
              'instance_threshold': 0.001}
META_FIELDS = ('name', 'dataset', 'keypoints', 'skeleton', 'sigmas',
               'base_stride', 'upsample_stride', 'head_index')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


def assert_close_to(ours, ref, rtol, label):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (label, ours.shape, ref.shape)
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=rtol * float(np.abs(ref).max()),
                               err_msg=label)


def assert_metas_equal(ours, ref):
    assert [type(m).__name__ for m in ours] == \
        [type(m).__name__ for m in ref]
    for o, r in zip(ours, ref):
        for name in META_FIELDS:
            if hasattr(r, name):
                assert getattr(o, name) == getattr(r, name), name


def port_model(path, **kwargs):
    model, meta = checkpoint.load_shell(path, **kwargs)
    return model.eval(), meta


def raw_port_fields(model, image, train=False):
    """Raw head outputs (B, F, C, H, W) of the port's model on NCHW
    ``image``; the backbone's BatchNorm in eval mode unless ``train``."""
    with torch.no_grad():
        x = torch.from_numpy(image.transpose(0, 2, 3, 1))
        return [f.numpy() for f in model.heads(
            model.backbone(x, train), train=True)]


def jax_raw_fields(base_name, metas, variables, image):
    """The flax backbone in eval mode, the heads' raw outputs."""
    base_net = jax_factory.BASE_FACTORIES[base_name]()
    jax_assign_strides(metas, base_net.stride)
    heads = [jax_factory.HEADS[type(m)](meta=m) for m in metas]
    with jax_f32():
        feats = base_net.apply(
            {'params': variables['params']['base_net'],
             'batch_stats': variables['batch_stats']['base_net']},
            image.transpose(0, 2, 3, 1), train=False)
        return [np.asarray(head.apply(
            {'params': variables['params'][f'head_nets_{i}']}, feats,
            train=True)) for i, head in enumerate(heads)]


@pytest.mark.parametrize('base_name', BACKBONES)
def test_backbone_matches_torch_ref_and_jax(tmp_path, base_name):
    torch.manual_seed(42)
    shell = torch_ref.build_shell(base_name)
    torch_ref.randomize_batch_norm_stats(shell)
    shell.eval()
    path = save_reference_checkpoint(str(tmp_path / 'ref.pkl'), shell,
                                     basenet=base_name)
    image = np.random.RandomState(7).randn(1, 3, 65, 97).astype(np.float32)
    with torch.no_grad():
        ref = [f.numpy() for f in shell(torch.from_numpy(image))]

    detected, metas, state_dict, epoch = convert_torch.convert_checkpoint(path)
    jax_name, jax_metas, variables, jax_epoch = \
        jax_convert.convert_checkpoint(path)
    assert (detected, epoch) == (jax_name, jax_epoch) == (base_name, 3)
    model, meta = port_model(path)
    assert meta['base_name'] == base_name and meta['epoch'] == 3
    for name, value in model.state_dict().items():
        assert torch.equal(value, state_dict[name]), name
    ours = raw_port_fields(model, image)
    theirs = jax_raw_fields(base_name, jax_metas, variables, image)
    assert_metas_equal(model.head_metas, jax_metas)
    for i, (o, r, j) in enumerate(zip(ours, ref, theirs)):
        assert_close_to(o, r, TORCH_RTOL, f'{base_name} head {i} vs torch_ref')
        assert_close_to(o, j, JAX_RTOL, f'{base_name} head {i} vs JAX')


def test_shapes_detect_each_backbone_as_jax(tmp_path):
    """Without ``args`` in the meta the backbone is told by its weights,
    as JAX tells it."""
    for base_name in BACKBONES:
        torch.manual_seed(0)
        path = save_reference_checkpoint(str(tmp_path / f'{base_name}.pkl'),
                                         torch_ref.build_shell(base_name))
        flat, _, meta, _ = convert_torch.load_torch_checkpoint(path)
        jax_flat, _, jax_meta, _ = jax_convert.load_torch_checkpoint(path)
        assert convert_torch.detect_base_name(flat, meta) == \
            jax_convert.detect_base_name(jax_flat, jax_meta) == base_name


def test_tracking_shell_matches_torch_ref_and_jax(tmp_path):
    """A tshufflenetv2k16 checkpoint (the ``TrackingBase`` wrapper,
    ``TBaseSingleImage`` and ``Tcaf`` heads) in train mode (BatchNorm over
    the batch) on one frame pair."""
    torch.manual_seed(11)
    shell = torch_ref.build_tracking_shell()
    shell.train()
    path = save_reference_checkpoint(str(tmp_path / 'tracking.pkl'), shell)
    images = np.random.RandomState(2).randn(2, 3, 65, 65).astype(np.float32)
    with torch.no_grad():
        ref = [f.numpy() for f in shell(torch.from_numpy(images))]

    model, meta = port_model(path)
    assert isinstance(model, TrackingShell)
    jax_name, jax_metas, variables, _ = jax_convert.convert_checkpoint(path)
    assert meta['base_name'] == jax_name == 'tshufflenetv2k16'
    assert [type(m).__name__ for m in model.head_metas] == \
        ['TSingleImageCif', 'TSingleImageCaf', 'Tcaf']
    ours = raw_port_fields(model, images, train=True)

    base_net = jax_factory.BASE_FACTORIES[jax_name]()
    jax_assign_strides(jax_metas, base_net.stride)
    assert_metas_equal(model.head_metas, jax_metas)
    jax_model = JaxTrackingShell(base_net=base_net, head_nets=tuple(
        JaxTcaf(meta=m) if isinstance(m, openpifpaf_tpu.headmeta.Tcaf)
        else JaxTBaseSingleImage(meta=m) for m in jax_metas))
    with jax_f32():
        theirs, _ = jax_model.apply(variables, images.transpose(0, 2, 3, 1),
                                    train=True, mutable=['batch_stats'])
    for i, (o, r, j) in enumerate(zip(ours, ref, theirs)):
        assert_close_to(o, r, TORCH_TRAIN_RTOL,
                        f'tracking head {i} vs torch_ref')
        assert_close_to(o, j, JAX_RTOL, f'tracking head {i} vs JAX')


def test_cf3_heads_match_reference_inference_and_jax(tmp_path):
    """CompositeField3 heads convert to the CompositeField4 layout and the
    port's inference output equals the reference's own v4-style output."""
    torch.manual_seed(7)
    shell = torch_ref.build_shell('resnet18',
                                  head_cls=torch_ref.CompositeField3)
    torch_ref.randomize_batch_norm_stats(shell)
    shell.eval()
    path = save_reference_checkpoint(str(tmp_path / 'cf3.pkl'), shell,
                                     basenet='resnet18')
    image = np.random.RandomState(3).randn(1, 3, 65, 97).astype(np.float32)
    with torch.no_grad():
        feats = shell.base_net(torch.from_numpy(image))
        ref = [hn.forward_inference_v4(feats).numpy()
               for hn in shell.head_nets]

    model, _ = port_model(path)
    with torch.no_grad():
        ours = [f.numpy() for f in model(torch.from_numpy(
            image.transpose(0, 2, 3, 1)))]
    jax_name, jax_metas, variables, _ = jax_convert.convert_checkpoint(path)
    base_net = jax_factory.BASE_FACTORIES[jax_name]()
    jax_assign_strides(jax_metas, base_net.stride)
    jax_model = JaxShell(base_net=base_net, head_nets=tuple(
        jax_factory.HEADS[type(m)](meta=m) for m in jax_metas))
    with jax_f32():
        theirs = jax_model.apply(variables, image.transpose(0, 2, 3, 1),
                                 train=False)
    assert_metas_equal(model.head_metas, jax_metas)
    for i, (o, r, j) in enumerate(zip(ours, ref, theirs)):
        assert_close_to(o, r, TORCH_RTOL, f'CF3 head {i} vs torch_ref')
        assert_close_to(o, j, JAX_RTOL, f'CF3 head {i} vs JAX')


def test_state_dict_only_checkpoint(tmp_path):
    """A bare state dict: the backbone told by its weights, the heads from
    the requested metas; the weights are JAX's conversion, exactly."""
    torch.manual_seed(0)
    shell = torch_ref.build_shell('shufflenetv2k16')
    torch_ref.randomize_batch_norm_stats(shell)
    path = str(tmp_path / 'sd.pkl')
    torch.save({'model': shell.state_dict(), 'epoch': 1, 'meta': {}}, path)

    with pytest.raises(ValueError, match='no recoverable head metas'):
        convert_torch.convert_checkpoint(path)
    base_name, metas, state_dict, epoch = convert_torch.convert_checkpoint(
        path, head_metas=cocokp_head_metas())
    jax_name, _, variables, _ = jax_convert.convert_checkpoint(
        path, head_metas=openpifpaf_tpu.datasets.factory('cocokp').head_metas)
    assert (base_name, epoch) == (jax_name, 1) == ('shufflenetv2k16', 1)
    assert [m.name for m in metas] == ['cif', 'caf']
    bridged = convert_jax.state_dict_from_jax(variables)
    assert set(bridged) == set(state_dict)
    for name, value in bridged.items():
        assert torch.equal(value, state_dict[name]), name

    model, meta = port_model(path, head_metas=cocokp_head_metas())
    image = np.random.RandomState(1).randn(1, 3, 65, 97).astype(np.float32)
    shell.eval()
    with torch.no_grad():
        ref = [f.numpy() for f in shell(torch.from_numpy(image))]
    assert meta['epoch'] == 1
    for i, (o, r) in enumerate(zip(raw_port_fields(model, image), ref)):
        assert_close_to(o, r, TORCH_RTOL, f'state dict head {i}')


# -- the slice as a whole ----------------------------------------------------

def k16_with_raised_confidences(path):
    """A full-width reference-layout k16 pickle whose confidence channels
    are raised by 2, so that random weights keep poses."""
    return save_reference_checkpoint(
        path, raise_confidences(reference_k16(seed=21, bn_seed=3)),
        basenet='shufflenetv2k16')


def test_predictor_of_reference_pickle_matches_jax(tmp_path):
    path = k16_with_raised_confidences(str(tmp_path / 'ref.pkl'))
    image = np.random.RandomState(5).randint(0, 256, (97, 129, 3),
                                             dtype=np.uint8)
    saved = {(cls, k): getattr(cls, k) for cls in (JaxCifCaf, TorchCifCaf)
             for k in THRESHOLDS}
    for cls, k in saved:
        setattr(cls, k, THRESHOLDS[k])
    try:
        port = Predictor(checkpoint=path, device='cpu')
        with jax_f32():
            jax_predictor = openpifpaf_tpu.Predictor(checkpoint=path)
    finally:
        for (cls, k), value in saved.items():
            setattr(cls, k, value)
    jax_predictor.pipeline_decode = False
    jax_predictor.backbone_engine = 'flax'
    assert [m.name for m in port.head_metas] == ['cif', 'caf']

    ours = port.numpy_image(image)[0]
    with jax_f32():
        ref = jax_predictor.numpy_image(image)[0]
    assert len(ref) > 0
    assert_pose_gate(pose_rows(ours)[..., :3], pose_rows(ref)[..., :3])


def _train_datamodule(cls, coco):
    ann_file, image_dir = coco
    return cls(train_annotations=ann_file, val_annotations=ann_file,
               train_image_dir=image_dir, val_image_dir=image_dir,
               square_edge=97, batch_size=2)


def test_train_from_reference_pickle_matches_jax(tmp_path, request):
    """``train --checkpoint ref.pkl --device cpu`` resumes at the pickle's
    epoch and takes one step as the JAX trainer does from JAX's
    conversion: the logged loss (rtol 1e-4) and the EMA parameters and
    BatchNorm statistics (10% of each tensor's update plus 1e-3 of the
    largest, rtol 2e-6, the trainer tests' tolerance)."""
    torch.manual_seed(4)
    shell = torch_ref.build_shell('resnet18')
    torch_ref.randomize_batch_norm_stats(shell, seed=5)
    path = save_reference_checkpoint(str(tmp_path / 'ref.pkl'), shell.eval(),
                                     basenet='resnet18')
    coco = write_synthetic_coco(str(tmp_path / 'coco'), n_images=4,
                                image_hw=(97, 129), seed=2)
    ann_file, image_dir = coco
    root = logging.getLogger('')
    request.addfinalizer(functools.partial(root.setLevel, root.level))
    handlers = list(root.handlers)
    request.addfinalizer(lambda: setattr(root, 'handlers', handlers))
    root.setLevel(logging.INFO)

    out = str(tmp_path / 'port' / 'model')
    os.makedirs(os.path.dirname(out))
    np.random.seed(3)
    with restored_statics(CocoKp):
        trainer = train.main([
            '--dataset', 'cocokp', '--checkpoint', path,
            '--cocokp-train-annotations', ann_file,
            '--cocokp-val-annotations', ann_file,
            '--cocokp-train-image-dir', image_dir,
            '--cocokp-val-image-dir', image_dir,
            '--cocokp-square-edge', '97', '--batch-size', '2',
            '--epochs', '4', '--train-batches', '1', '--val-batches', '1',
            '--log-interval', '1', '--device', 'cpu', '--output', out])
    assert trainer.epochs == 4
    root.handlers = list(handlers)  # the train CLI's log file ends here

    datamodule = _train_datamodule(JaxCocoKp, coco)
    jax_model, variables = jax_checkpoint.load_shell(
        path, head_metas=datamodule.head_metas)
    assert jax_checkpoint.LAST_META['epoch'] == 3
    variables = jax.tree_util.tree_map(np.asarray, variables)
    train_loader = datamodule.train_loader()
    optimizer, schedule = jax_optimize.factory_optimizer(
        optimizer_args(), training_batches_per_epoch=len(train_loader))
    jax_trainer = JaxTrainer(
        jax_model, jax_losses.Factory().factory(datamodule.head_metas),
        optimizer, schedule, str(tmp_path / 'jax-model'),
        variables=variables)
    jax_trainer.epochs = 4
    jax_trainer.n_train_batches = 1
    jax_trainer.n_val_batches = 1
    jax_log = str(tmp_path / 'jax-model.log')
    handler = logging.FileHandler(jax_log, mode='w')
    handler.setFormatter(JsonFormatter())
    handler.setLevel(logging.INFO)
    root.addHandler(handler)
    np.random.seed(3)
    try:
        with jax_f32():
            jax_trainer.loop(train_loader, datamodule.val_loader(), 3)
    finally:
        root.removeHandler(handler)
        handler.close()

    ours_steps, jax_steps = (
        [line for line in map(json.loads, open(log))
         if line.get('type') == 'train'] for log in (out + '.log', jax_log))
    assert [line['epoch'] for line in ours_steps] == \
        [line['epoch'] for line in jax_steps] == [3]
    np.testing.assert_allclose(ours_steps[0]['loss'], jax_steps[0]['loss'],
                               rtol=1e-4)

    state = jax_trainer.state
    ref = convert_jax.state_dict_from_jax(
        {'params': state.ema_params, 'batch_stats': state.batch_stats})
    start = convert_jax.state_dict_from_jax(variables)
    loaded, meta = checkpoint.load_shell(out)
    assert meta['epoch'] == 4 and meta['base_name'] == 'resnet18'
    ours = loaded.state_dict()
    names = [n for n in ref if not n.endswith('num_batches_tracked')]
    floor = max(float((ref[n] - start[n]).abs().max()) for n in names)
    assert floor > 0
    for name in names:
        update = float((ref[name] - start[name]).abs().max())
        np.testing.assert_allclose(ours[name].numpy(), ref[name].numpy(),
                                   rtol=2e-6, atol=0.1 * update + 1e-3 * floor,
                                   err_msg=name)
