"""Convert the Animal-Pose VOC-style release (PASCAL2011 part-1 XMLs +
part-2 custom XMLs) into COCO-format keypoint JSON.

Copy of ``openpifpaf_tpu/plugins/animalpose/voc_to_coco.py``. Usage:

    python -m openpifpaf_tpu_torch.plugins.animalpose.voc_to_coco \
        --dir-data data-animalpose --dir-out data-animalpose \
        --train-list train.txt --val-list val.txt
"""

import argparse
import glob
import json
import logging
import os
import shutil
import time
import xml.etree.ElementTree as ET

import numpy as np
import PIL.Image

from . import ANIMAL_KEYPOINTS, ANIMAL_SKELETON

LOG = logging.getLogger(__name__)

#: species of the raw release (preprocessing only)
CATEGORIES = ['cat', 'cow', 'dog', 'sheep', 'horse']

#: keypoint names used by the part-2 annotations, index-aligned with
#: ANIMAL_KEYPOINTS (reference constants.py:52-74)
ALTERNATIVE_NAMES = [
    'Nose', 'L_Eye', 'R_Eye', 'L_EarBase', 'R_EarBase', 'Throat',
    'TailBase', 'Withers', 'L_F_Elbow', 'R_F_Elbow', 'L_B_Elbow',
    'R_B_Elbow', 'L_F_Knee', 'R_F_Knee', 'L_B_Knee', 'R_B_Knee',
    'L_F_Paw', 'R_F_Paw', 'L_B_Paw', 'R_B_Paw',
]


def name_mapping():
    """Both naming schemes map onto 0..n-1."""
    mapping = {}
    for i, name in enumerate(ANIMAL_KEYPOINTS):
        mapping[name] = i
    for i, name in enumerate(ALTERNATIVE_NAMES):
        mapping[name] = i
    return mapping


def cli():
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--dir-data', '--dir_data', dest='dir_data',
                        default='data-animalpose')
    parser.add_argument('--dir-out', '--dir_out', dest='dir_out',
                        default='data-animalpose')
    parser.add_argument('--train-list', default=None,
                        help='txt file with one training image name per '
                             'line (defaults to <dir-data>/train.txt)')
    parser.add_argument('--val-list', default=None,
                        help='txt file with one validation image name per '
                             'line (defaults to <dir-data>/val.txt)')
    parser.add_argument('--sample', action='store_true',
                        help='only process the first 50 images')
    return parser.parse_args()


class VocToCoco:
    sample = False

    def __init__(self, dir_dataset, dir_out, *,
                 train_list=None, val_list=None):
        self.dir_dataset = dir_dataset
        self.dir_images_1 = os.path.join(
            dir_dataset, 'TrainVal', 'VOCdevkit', 'VOC2011', 'JPEGImages')
        self.dir_images_2 = os.path.join(
            dir_dataset, 'animalpose_image_part2')
        self.dir_annotations_1 = os.path.join(
            dir_dataset, 'PASCAL2011_animal_annotation')
        self.dir_annotations_2 = os.path.join(dir_dataset, 'animalpose_anno2')
        self.train_list = train_list or os.path.join(dir_dataset, 'train.txt')
        self.val_list = val_list or os.path.join(dir_dataset, 'val.txt')

        self.dir_out_im = os.path.join(dir_out, 'images')
        self.dir_out_ann = os.path.join(dir_out, 'annotations')
        os.makedirs(os.path.join(self.dir_out_im, 'train'), exist_ok=True)
        os.makedirs(os.path.join(self.dir_out_im, 'val'), exist_ok=True)
        os.makedirs(self.dir_out_ann, exist_ok=True)

        self.map_names = name_mapping()
        self.n_kps = len(ANIMAL_KEYPOINTS)

    def process(self):
        for phase, metadata in self._split_train_val().items():
            if self.sample:
                metadata = metadata[:50]
            blob = self._empty_json()
            n_instances = 0
            kp_counts = np.zeros(self.n_kps, dtype=int)

            for im_path, im_id, xml_paths in metadata:
                self._image_entry(im_path, im_id, blob)
                for xml_path in xml_paths:
                    kp_counts += self._instance_entry(xml_path, im_id, blob)
                    n_instances += 1
                shutil.copyfile(im_path, os.path.join(
                    self.dir_out_im, phase, os.path.basename(im_path)))

            name = f'animal_keypoints_{self.n_kps}_'
            if self.sample:
                name += 'sample_'
            out_path = os.path.join(self.dir_out_ann, name + phase + '.json')
            with open(out_path, 'w') as f:
                json.dump(blob, f)
            LOG.info('phase %s: %d instances, avg keypoints %.1f/%d -> %s',
                     phase, n_instances,
                     kp_counts.sum() / max(1, n_instances), self.n_kps,
                     out_path)

    def _split_train_val(self):
        lists = {}
        with open(self.train_list, 'r') as f:
            lists['train'] = f.read().splitlines()
        with open(self.val_list, 'r') as f:
            lists['val'] = f.read().splitlines()
        overlap = set(lists['train']) & set(lists['val'])
        assert not overlap, f'train/val intersection not empty: {overlap}'

        splits = {'train': [], 'val': []}
        for phase, names in lists.items():
            for name in names:
                if not name.strip():
                    continue
                basename = os.path.splitext(name)[0]
                if name[:2] == '20':  # Pascal-style names: 2011_000123.jpg
                    date, id_str = basename.split(sep='_')
                    im_id = int(str(int(date)) + str(int(id_str)))
                    ann_folder = self.dir_annotations_1
                    im_path = os.path.join(self.dir_images_1, name)
                else:  # part-2 names: cow13.jpg
                    idx_cat, cat = self._map_category(basename[:2])
                    im_id = int(str(999) + str(idx_cat) + basename[2:])
                    ann_folder = self.dir_annotations_2
                    im_path = os.path.join(self.dir_images_2, cat, name)
                splits[phase].append(
                    (im_path, im_id, self._find_annotations(im_path,
                                                            ann_folder)))
            LOG.info('read %d %s images', len(splits[phase]), phase)
        return splits

    @staticmethod
    def _map_category(cat_prefix):
        for idx, cat in enumerate(CATEGORIES):
            if cat_prefix in cat:
                return idx + 1, cat  # categories starting from one
        raise ValueError(f'unknown category prefix {cat_prefix!r}')

    @staticmethod
    def _find_annotations(im_path, ann_folder):
        base = os.path.splitext(os.path.basename(im_path))[0]
        xml_paths = []
        for cat in CATEGORIES:
            root = os.path.join(ann_folder, cat, base)
            # [_,.] avoids matching cow130 for cow13
            xml_paths.extend(glob.glob(root + '[_,.]*xml'))
        assert xml_paths, 'no annotations for ' + im_path
        return xml_paths

    @staticmethod
    def _image_entry(im_path, im_id, blob):
        with PIL.Image.open(im_path) as im:
            width, height = im.size
        blob['images'].append({
            'coco_url': 'unknown',
            'file_name': os.path.basename(im_path),
            'id': im_id, 'license': 1, 'date_captured': 'unknown',
            'width': width, 'height': height,
        })

    def _instance_entry(self, xml_path, im_id, blob):
        root = ET.parse(xml_path).getroot()
        box_obj = root.findall('visible_bounds')
        assert len(box_obj) <= 1, 'one instance per annotation file'

        x_min = round(float(box_obj[0].attrib['xmin'])) - 1
        width = round(float(box_obj[0].attrib['width']))
        height = round(float(box_obj[0].attrib['height']))
        try:
            y_min = round(float(box_obj[0].attrib['ymin'])) - 1
        except KeyError:
            # part-1 files mislabel ymin as xmax
            y_min = round(float(box_obj[0].attrib['xmax'])) - 1
        box = [x_min, y_min, width, height]

        kp_obj = root.findall('keypoints')
        assert len(kp_obj) <= 1, 'one instance per annotation file'

        kps_out = np.zeros((self.n_kps, 3))
        counts = np.zeros(self.n_kps, dtype=int)
        for kp in kp_obj[0].findall('keypoint'):
            n = self.map_names.get(kp.attrib['name'])
            if n is not None and kp.attrib['visible'] == '1':
                kps_out[n] = (float(kp.attrib['x']), float(kp.attrib['y']), 2)
                counts[n] += 1

        blob['annotations'].append({
            'image_id': im_id, 'category_id': 1, 'iscrowd': 0, 'id': im_id,
            'area': box[2] * box[3], 'bbox': box,
            'num_keypoints': int(counts.sum()),
            'keypoints': list(kps_out.reshape(-1)),
            'segmentation': [],
        })
        return counts

    @staticmethod
    def _empty_json():
        return {
            'info': {
                'url': 'https://github.com/openpifpaf/openpifpaf',
                'date_created': time.strftime(
                    '%a, %d %b %Y %H:%M:%S +0000', time.localtime()),
                'description': 'Animalpose dataset with MS-COCO format',
            },
            'categories': [{
                'name': 'animal', 'id': 1, 'supercategory': 'animal',
                'skeleton': ANIMAL_SKELETON, 'keypoints': [],
            }],
            'images': [],
            'annotations': [],
        }


def main():
    args = cli()
    VocToCoco.sample = args.sample
    converter = VocToCoco(args.dir_data, args.dir_out,
                          train_list=args.train_list, val_list=args.val_list)
    converter.process()


if __name__ == '__main__':
    main()
