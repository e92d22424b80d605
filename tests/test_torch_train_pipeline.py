"""The port's cocokp train pipeline against the JAX package's.

A synthetic COCO keypoint set (``write_synthetic_coco``) is read by both
packages' ``CocoKp`` data modules with augmentation on. With the global
``np.random`` seeded alike, the two train loaders must give the same
batches for two epochs, bit for bit: the shuffled order, the augmented
images, the CIF/CAF targets (NaN where NaN) and the metas.
"""

import numpy as np
import pytest

from openpifpaf_tpu.models.shell import assign_strides as jax_assign_strides
from openpifpaf_tpu.plugins.coco.cocokp import CocoKp as JaxCocoKp
from openpifpaf_tpu_torch.models.shell import assign_strides
from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp

from torch_port_helpers import write_synthetic_coco

SEED = 7


@pytest.fixture(scope='module')
def coco(tmp_path_factory):
    return write_synthetic_coco(str(tmp_path_factory.mktemp('coco')),
                                n_images=8, image_hw=(113, 129), seed=1)


def _batches(module_cls, assign, coco, epochs=2, **config):
    ann_file, image_dir = coco
    datamodule = module_cls(train_annotations=ann_file,
                            train_image_dir=image_dir, square_edge=97,
                            batch_size=2, **config)
    assign(datamodule.head_metas, 16)
    loader = datamodule.train_loader()
    np.random.seed(SEED)
    out = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        out.extend(loader)
    return out


def _comparable(meta):
    meta = dict(meta)
    swap = meta.pop('horizontal_swap', None)
    if swap is not None:
        meta['horizontal_swap'] = swap.permutation.tolist()
    return meta


CONFIGS = {
    'default': {},
    'blur_rotate_extended': {'blur': 0.5, 'orientation_invariant': 0.3,
                             'extended_scale': True},
    'with_dense': {'with_dense': True},
}


@pytest.mark.parametrize('config', sorted(CONFIGS))
def test_train_batches_equal_jax(coco, config):
    ours = _batches(CocoKp, assign_strides, coco, **CONFIGS[config])
    ref = _batches(JaxCocoKp, jax_assign_strides, coco, **CONFIGS[config])
    assert len(ours) == len(ref) == 8
    n_heads = 3 if config == 'with_dense' else 2
    flipped = 0
    for (images, targets, metas), (r_images, r_targets, r_metas) in zip(
            ours, ref):
        assert images.shape == (2, 97, 97, 3) and images.dtype == np.float32
        np.testing.assert_array_equal(images, r_images)
        assert len(targets) == len(r_targets) == n_heads
        for t, r in zip(targets, r_targets):
            assert t.shape == r.shape and t.dtype == r.dtype
            np.testing.assert_array_equal(t, r)
        assert [m['image_id'] for m in metas] == \
            [m['image_id'] for m in r_metas]
        for m, r in zip(metas, r_metas):
            m, r = _comparable(m), _comparable(r)
            assert sorted(m) == sorted(r)
            for key in m:
                np.testing.assert_equal(m[key], r[key], err_msg=key)
            flipped += m['hflip']
    # the augmentations ran: some samples flipped, the order shuffled
    assert 0 < flipped < 16
    order = [m['image_id'] for _, _, metas in ours for m in metas]
    assert order[:8] != sorted(order[:8]) and order[:8] != order[8:]


def test_loader_order_is_seeded_by_epoch(coco):
    """The shuffle is ``RandomState(seed + epoch)``, as in the JAX
    loader, whatever the global ``np.random`` state."""
    ann_file, image_dir = coco
    orders = []
    for module_cls, assign in ((CocoKp, assign_strides),
                               (JaxCocoKp, jax_assign_strides)):
        datamodule = module_cls(train_annotations=ann_file,
                                train_image_dir=image_dir, batch_size=2)
        assign(datamodule.head_metas, 16)
        loader = datamodule.train_loader()
        epochs = []
        for epoch in range(2):
            loader.set_epoch(epoch)
            epochs.append(loader._indices().tolist())
        orders.append(epochs)
    assert orders[0] == orders[1]
    assert orders[0][0] != orders[0][1]


def test_loader_workers_keep_the_order(coco):
    """With worker processes (spawned: each draws its own augmentations)
    the loader yields the same samples in the same order."""
    ann_file, image_dir = coco
    orders = []
    for workers in (0, 2):
        datamodule = CocoKp(train_annotations=ann_file,
                            train_image_dir=image_dir, square_edge=97,
                            batch_size=2)
        datamodule.loader_workers = workers
        assign_strides(datamodule.head_metas, 16)
        batches = list(datamodule.train_loader())
        assert all(images.shape == (2, 97, 97, 3)
                   for images, _, _ in batches)
        orders.append([m['image_id'] for _, _, metas in batches
                       for m in metas])
    assert orders[0] == orders[1] and len(orders[0]) == 8
