"""CifDet decoder (port of ``openpifpaf_tpu/decoder/cifdet.py``): the
detection decode of :mod:`..ops.decode_cifdet` on the fields' device, its
flags, and the tensor -> ``AnnotationDet`` conversion on the host."""

import argparse
import logging
import time
from typing import List

import numpy as np
import torch

from .. import headmeta
from ..annotation import AnnotationDet
from ..ops.decode_cifdet import CifDetDecoderConfig, build_cifdet_decoder
from .base import Decoder

LOG = logging.getLogger(__name__)


class CifDet(Decoder):
    iou_threshold = 0.5
    instance_threshold = 0.15
    seed_threshold = 0.2
    cifhr_threshold = 0.3
    nms_by_category = True
    suppression = 0.1
    n_detections = 120

    def __init__(self, head_metas: List[headmeta.CifDet]):
        super().__init__()
        self.metas = head_metas
        self.config = CifDetDecoderConfig(
            iou_threshold=self.iou_threshold,
            seed_threshold=self.seed_threshold,
            cifhr_threshold=self.cifhr_threshold,
            instance_threshold=self.instance_threshold,
            nms_by_category=self.nms_by_category,
            suppression=self.suppression,
            n_detections=self.n_detections,
        )

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser):
        group = parser.add_argument_group('CifDet decoder')
        group.add_argument('--cifdet-iou-threshold', type=float,
                           default=cls.iou_threshold)

    @classmethod
    def configure(cls, args: argparse.Namespace):
        cls.iou_threshold = args.cifdet_iou_threshold
        # the decoders' shared thresholds, where the CLI has them
        if getattr(args, 'seed_threshold', None) is not None:
            cls.seed_threshold = args.seed_threshold
        if getattr(args, 'instance_threshold', None) is not None:
            cls.instance_threshold = args.instance_threshold

    @classmethod
    def factory(cls, head_metas):
        return [cls([meta]) for meta in head_metas
                if isinstance(meta, headmeta.CifDet)]

    def batch_decode(self, fields_batch):
        """fields_batch: list over head indices of (B, F, 6, H, W) tensors;
        one list of ``AnnotationDet`` per image, by descending score."""
        cifdet = torch.as_tensor(fields_batch[self.metas[0].head_index],
                                 dtype=torch.float32)
        start = time.perf_counter()
        out = build_cifdet_decoder(stride=self.metas[0].stride,
                                   config=self.config)(cifdet)
        floats = torch.cat([out['score'][..., None], out['box']],
                           dim=-1).cpu().numpy()
        ints = torch.stack([out['category'], out['keep'].long()],
                           dim=-1).cpu().numpy()
        self.last_decoder_time = time.perf_counter() - start

        batch_annotations = []
        for i in range(cifdet.shape[0]):
            score = floats[i, :, 0]
            annotations = []
            # numpy's default sort, as the JAX decoder's host loop has it
            order = np.argsort(-score)
            for j in order:
                if not ints[i, j, 1]:
                    continue
                box = floats[i, j, 1:].copy()
                box[2:] -= box[:2]  # xyxy -> xywh
                ann = AnnotationDet(self.metas[0].categories)
                ann.set(int(ints[i, j, 0]), float(score[j]), box)
                annotations.append(ann)
            batch_annotations.append(annotations)
        return batch_annotations

    def __call__(self, fields):
        return self.batch_decode([f[None] for f in fields])[0]
