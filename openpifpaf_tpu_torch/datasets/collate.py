"""Collate functions (copy of ``openpifpaf_tpu/datasets/collate.py``).

Batches are plain numpy arrays on the host; the trainer and the
Predictor move them to the device.
Images within a batch must share a (padded) resolution; the transforms
pipeline guarantees this for training crops, and the Predictor pads to the
batch maximum for free-size inputs.
"""

import numpy as np


def pad_images_to_max(images):
    """Stack images (H, W, 3) to a common padded shape."""
    hmax = max(im.shape[0] for im in images)
    wmax = max(im.shape[1] for im in images)
    out = np.zeros((len(images), hmax, wmax, images[0].shape[2]),
                   dtype=np.float32)
    for i, im in enumerate(images):
        out[i, :im.shape[0], :im.shape[1]] = im
    return out


def collate_images_anns_meta(batch):
    anns = [b[-2] for b in batch]
    metas = [b[-1] for b in batch]
    if len(batch[0]) == 4:
        raw_images = [b[0] for b in batch]
        images = pad_images_to_max([np.asarray(b[1]) for b in batch])
        return raw_images, images, anns, metas
    images = pad_images_to_max([np.asarray(b[0]) for b in batch])
    return images, anns, metas


def collate_images_targets_meta(batch):
    images = np.stack([np.asarray(b[0]) for b in batch])
    targets = [
        np.stack([np.asarray(b[1][i]) for b in batch])
        for i in range(len(batch[0][1]))
    ]
    metas = [b[2] for b in batch]
    return images, targets, metas
