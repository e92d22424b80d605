"""PoseTrack2018 and PoseTrack2017 dataset readers (copy of
``openpifpaf_tpu/plugins/posetrack/datasets.py``), without the reference's
pysparkling dependency: plain glob + json of per-sequence
annotation files, grouped into frame groups."""

import copy
import glob
import json
import logging
import os
import random

import numpy as np
import PIL.Image

LOG = logging.getLogger(__name__)


class Posetrack2018:
    def __init__(self, annotation_files, data_root, *, preprocess,
                 group=None, only_annotated=False, max_per_sequence=None):
        if group is None:
            group = (0,)
        self.group = group
        self.preprocess = preprocess
        self.data_root = data_root
        self.only_annotated = only_annotated
        self.max_per_sequence = max_per_sequence

        self.sequences = {}
        for file_name in sorted(glob.glob(annotation_files)):
            with open(file_name, 'r') as f:
                self.sequences[file_name] = json.load(f)

        self.annotations = []
        for file_name, raw in self.sequences.items():
            self.annotations.extend(self.group_annotations(file_name, raw))

        LOG.info('sequences = %d, annotations = %d',
                 len(self.sequences), len(self.annotations))

    def group_annotations(self, file_name, raw_annotation):
        all_images = raw_annotation['images']
        all_annotations = raw_annotation.get('annotations', [])
        by_image_id = {}
        for ann in all_annotations:
            by_image_id.setdefault(ann['image_id'], []).append(ann)

        frame_groups = self.group
        if not isinstance(frame_groups[0], (tuple, list)):
            frame_groups = [frame_groups]

        groups = []
        for i in range(len(all_images)):
            for this_group in frame_groups:
                if any(i + gi < 0 for gi in this_group):
                    continue
                image_groups = [all_images[i + gi] for gi in this_group]
                groups.append([
                    {
                        'annotation_file': file_name,
                        'image': image,
                        'annotations': by_image_id.get(image['frame_id'], []),
                    }
                    for image in image_groups
                ])

        if self.only_annotated:
            groups = [g for g in groups if all(s['annotations'] for s in g)]
        if self.max_per_sequence and len(groups) > self.max_per_sequence:
            groups = random.choices(groups, k=self.max_per_sequence)
        return groups

    @staticmethod
    def _ignore_region_crowds(image_info):
        """Posetrack ignore regions become crowd annotations (reference
        ``normalize_transform.py:17-36``)."""
        ignore_regions = list(zip(image_info.get('ignore_regions_x', []),
                                  image_info.get('ignore_regions_y', [])))
        return [
            {
                'bbox': [min(xs), min(ys),
                         max(xs) - min(xs), max(ys) - min(ys)],
                'keypoints': [(x, y, 0.0) for x, y in zip(xs, ys)],
                'iscrowd': True,
                'track_id': -1,
            }
            for xs, ys in ignore_regions if xs and ys
        ]

    def __getitem__(self, index):
        group = self.annotations[index]

        images, anns, metas = [], [], []
        for group_i, data in enumerate(group):
            local_file_path = os.path.join(
                self.data_root, data['image']['file_name'])
            with open(local_file_path, 'rb') as f:
                images.append(PIL.Image.open(f).convert('RGB'))
            w, h = images[-1].size

            frame_anns = copy.deepcopy(data['annotations'])
            frame_anns += self._ignore_region_crowds(data['image'])
            for ann in frame_anns:
                if 'keypoints' in ann:
                    kps = np.asarray(
                        ann['keypoints'], dtype=np.float32).reshape(-1, 3)
                    # posetrack marks annotated keypoints v=1; treat as
                    # visible, and zero out-of-frame bad data
                    # (reference normalize_transform.py:44-56)
                    kps[kps[:, 2] > 0.0, 2] = 2.0
                    kps[kps[:, 0] < 0.0, 2] = 0.0
                    kps[kps[:, 1] < 0.0, 2] = 0.0
                    kps[kps[:, 0] > w - 1, 2] = 0.0
                    kps[kps[:, 1] > h - 1, 2] = 0.0
                    ann['keypoints'] = kps
                if 'bbox' in ann:
                    ann['bbox'] = np.asarray(ann['bbox'], dtype=np.float32)
                if 'bbox_head' in ann:
                    ann['bbox_head'] = np.asarray(
                        ann['bbox_head'], dtype=np.float32)
                ann.setdefault('iscrowd', False)
            anns.append(frame_anns)

            metas.append({
                'dataset_index': index,
                'image_id': data['image']['frame_id'],
                'file_name': data['image']['file_name'],
                'local_file_path': local_file_path,
                'annotation_file': data['annotation_file'],
                'group_i': group_i,
            })

        images, anns, metas = self.preprocess(images, anns, metas)
        return images, anns, metas

    def __len__(self):
        return len(self.annotations)


class Posetrack2017:
    """PoseTrack2017 dataset reader (reference ``datasets.py:122-244``):
    the old ``annolist`` per-sequence format. Eval-only — ground truth is
    evaluated externally (poseval), so annotations are empty and only the
    image references are used."""

    def __init__(self, annotation_files, data_root, *, preprocess,
                 group=None, only_annotated=False, max_per_sequence=None):
        if group is None:
            group = (0,)
        self.group = group
        self.preprocess = preprocess
        self.data_root = data_root
        self.only_annotated = only_annotated
        self.max_per_sequence = max_per_sequence

        self.sequences = {}
        for file_name in sorted(glob.glob(annotation_files)):
            with open(file_name, 'r') as f:
                self.sequences[file_name] = json.load(f)

        self.annotations = []
        for file_name, raw in self.sequences.items():
            self.annotations.extend(self.group_annotations(file_name, raw))

        LOG.info('sequences = %d, annotations = %d',
                 len(self.sequences), len(self.annotations))

    def meta_images(self):
        return {
            file_name: [i['image'][0]['name'] for i in raw['annolist']]
            for file_name, raw in self.sequences.items()
        }

    def meta_categories(self):
        return {
            file_name: [{'supercategory': 'person', 'id': 1,
                         'name': 'person'}]
            for file_name in self.sequences
        }

    def group_annotations(self, file_name, raw_annotation):
        all_annotations = raw_annotation.get('annolist', [])

        groups = []
        start_frame = 0 if not self.only_annotated else 12
        for i in range(start_frame, len(all_annotations)):
            this_group = self.group
            if (isinstance(this_group, (tuple, list))
                    and this_group and isinstance(this_group[0],
                                                  (tuple, list))):
                this_group = random.choice(this_group)

            group = []
            for gi in this_group:
                frame_id = (i + gi if i + gi >= 0
                            else i - 4 if i - 4 >= 0 else i)
                entry = all_annotations[frame_id]
                group.append({
                    'annotation_file': file_name,
                    'image': {
                        'frame_id': frame_id,
                        'file_name': entry['image'][0]['name'],
                    },
                    'annotations': [],
                })
            groups.append(group)

        if self.only_annotated:
            groups = [g for g in groups if all(s['annotations'] for s in g)]
        if self.max_per_sequence and len(groups) > self.max_per_sequence:
            groups = random.choices(groups, k=self.max_per_sequence)
        return groups

    def __getitem__(self, index):
        group = self.annotations[index]

        images, anns, metas = [], [], []
        for group_i, data in enumerate(group):
            local_file_path = os.path.join(
                self.data_root, data['image']['file_name'])
            with open(local_file_path, 'rb') as f:
                images.append(PIL.Image.open(f).convert('RGB'))
            anns.append([])
            metas.append({
                'dataset_index': index,
                'image_id': data['image']['frame_id'],
                'file_name': data['image']['file_name'],
                'local_file_path': local_file_path,
                'annotation_file': data['annotation_file'],
                'group_i': group_i,
            })

        images, anns, metas = self.preprocess(images, anns, metas)
        return images, anns, metas

    def __len__(self):
        return len(self.annotations)
