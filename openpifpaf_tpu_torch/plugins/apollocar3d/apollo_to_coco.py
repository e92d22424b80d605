"""Convert the raw ApolloCar3D release (per-car keypoint txt files +
ignore masks) into COCO-format keypoint JSON, in both the 24- and the
66-keypoint configuration.

Copy of ``openpifpaf_tpu/plugins/apollocar3d/apollo_to_coco.py``. Usage:

    python -m openpifpaf_tpu_torch.plugins.apollocar3d.apollo_to_coco \
        --dir-data data-apollocar3d/train --dir-out data-apollocar3d
"""

import argparse
import glob
import json
import logging
import os
import shutil
import time

import numpy as np
import PIL.Image

from . import (CAR_KEYPOINTS_24, CAR_SKELETON_24,
               CAR_KEYPOINTS_66, CAR_SKELETON_66)

LOG = logging.getLogger(__name__)

#: indices of the 66-keypoint set kept in the 24-keypoint configuration
#: (reference constants.py:56-57)
KPS_MAPPING = [49, 8, 57, 0, 52, 5, 11, 7, 20, 23, 24, 33, 25, 32, 28,
               29, 46, 34, 37, 50, 65, 64, 9, 48]


def cli():
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--dir-data', '--dir_data', dest='dir_data',
                        default='data-apollocar3d/train')
    parser.add_argument('--dir-out', '--dir_out', dest='dir_out',
                        default='data-apollocar3d')
    parser.add_argument('--sample', action='store_true',
                        help='only process the first 50 images')
    parser.add_argument('--single-sample', '--single_sample',
                        dest='single_sample', action='store_true',
                        help='only process the first image')
    parser.add_argument('--split-images', '--split_images',
                        dest='split_images', action='store_true',
                        help='copy images into train/val split folders')
    parser.add_argument('--histogram', action='store_true',
                        help='show a per-keypoint annotation-count '
                             'histogram after each phase')
    return parser.parse_args()


class ApolloToCoco:
    sample = False
    single_sample = False
    split_images = False
    histogram = False

    def __init__(self, dir_dataset, dir_out):
        assert os.path.isdir(dir_dataset), 'dataset directory not found'
        self.dir_dataset = dir_dataset
        self.dir_mask = os.path.join(dir_dataset, 'ignore_mask')
        assert os.path.isdir(self.dir_mask), \
            'crowd annotations not found: ' + self.dir_mask

        self.dir_out_im = os.path.join(dir_out, 'images')
        self.dir_out_ann = os.path.join(dir_out, 'annotations')
        os.makedirs(self.dir_out_im, exist_ok=True)
        os.makedirs(self.dir_out_ann, exist_ok=True)

        # 66-kp index -> 24-kp index (missing = dropped)
        self.map_24 = {orig: i for i, orig in enumerate(KPS_MAPPING)}

        self.splits = {}
        for name in ('train', 'val'):
            list_name = ('train-list.txt' if name == 'train'
                         else 'validation-list.txt')
            path = os.path.join(self.dir_dataset, 'split', list_name)
            with open(path, 'r', encoding='utf8') as f:
                lines = f.readlines()
            self.splits[name] = [
                os.path.join(self.dir_dataset, 'images', line.strip())
                for line in lines if line.strip()]
            assert self.splits[name], 'specified split is empty: ' + path

    def process(self):
        for phase, im_paths in self.splits.items():
            json_24 = self._empty_json(24)
            json_66 = self._empty_json(66)
            n_instances = 0
            kp_counts = np.zeros(66, dtype=int)

            if self.sample:
                im_paths = im_paths[:50]
            if self.single_sample:
                im_paths = self.splits['train'][:1]
            if self.split_images:
                phase_dir = os.path.join(self.dir_out_im, phase)
                os.makedirs(phase_dir, exist_ok=True)

            for count, im_path in enumerate(im_paths, start=1):
                im_size, im_name, im_id = self._image_entry(
                    im_path, json_24, json_66)

                for txt_path in sorted(glob.glob(os.path.join(
                        self.dir_dataset, 'keypoints', im_name,
                        im_name + '*.txt'))):
                    data = np.loadtxt(txt_path, delimiter='\t', ndmin=2)
                    self._instance_entries(data, txt_path, im_size, im_id,
                                           json_24, json_66)
                    for kp_index in data[:, 0]:
                        kp_counts[int(kp_index)] += 1
                    n_instances += 1

                if self.split_images:
                    shutil.copyfile(im_path, os.path.join(
                        self.dir_out_im, phase, os.path.basename(im_path)))

                self._mask_entries(
                    os.path.join(self.dir_mask, im_name + '.jpg'),
                    im_id, json_24, json_66)

                if count % 1000 == 0:
                    LOG.info('parsed %d images', count)

            for blob, n_kp in ((json_24, 24), (json_66, 66)):
                name = f'apollo_keypoints_{n_kp}_'
                if self.sample:
                    name += 'sample_'
                elif self.single_sample:
                    name += 'single_sample_'
                out_path = os.path.join(self.dir_out_ann,
                                        name + phase + '.json')
                with open(out_path, 'w', encoding='utf8') as f:
                    json.dump(blob, f)
            LOG.info('phase %s: %d instances, avg keypoints %.1f/66',
                     phase, n_instances,
                     kp_counts.sum() / max(1, n_instances))
            if self.histogram:
                show_histogram(kp_counts)

    @staticmethod
    def _empty_json(n_kp):
        return {
            'info': {
                'url': 'https://github.com/openpifpaf/openpifpaf',
                'date_created': time.strftime(
                    '%a, %d %b %Y %H:%M:%S +0000', time.localtime()),
                'description': ('ApolloCar3D dataset in MS-COCO format '
                                f'with {n_kp} keypoints'),
            },
            'categories': [{
                'name': 'car', 'id': 1, 'supercategory': 'car',
                'skeleton': (CAR_SKELETON_24 if n_kp == 24
                             else CAR_SKELETON_66),
                'keypoints': (CAR_KEYPOINTS_24 if n_kp == 24
                              else CAR_KEYPOINTS_66),
            }],
            'images': [],
            'annotations': [],
        }

    @staticmethod
    def _image_entry(im_path, json_24, json_66):
        file_name = os.path.basename(im_path)
        im_name = os.path.splitext(file_name)[0]
        im_id = int(im_name.split(sep='_')[1])
        with PIL.Image.open(im_path) as im:
            width, height = im.size
        entry = {
            'coco_url': 'unknown', 'file_name': file_name, 'id': im_id,
            'license': 1, 'date_captured': 'unknown',
            'width': width, 'height': height,
        }
        json_24['images'].append(entry)
        json_66['images'].append(entry)
        return (width, height), im_name, im_id

    def _instance_entries(self, all_kps, txt_path, im_size, im_id,
                          json_24, json_66):
        # box from keypoint extent, enlarged by 10% each side
        x0, y0 = np.min(all_kps[:, 1]), np.min(all_kps[:, 2])
        x1, y1 = np.max(all_kps[:, 1]), np.max(all_kps[:, 2])
        w, h = x1 - x0, y1 - y0
        x_o, y_o = max(x0 - 0.1 * w, 0), max(y0 - 0.1 * h, 0)
        x_i = min(x0 + 1.1 * w, im_size[0])
        y_i = min(y0 + 1.1 * h, im_size[1])
        box = [int(x_o), int(y_o), int(x_i - x_o), int(y_i - y_o)]

        txt_id = os.path.splitext(txt_path.split(sep='_')[-1])[0]
        car_id = int(str(im_id) + str(int(txt_id)))

        for blob, n_kp in ((json_24, 24), (json_66, 66)):
            kps_out = np.zeros((n_kp, 3))
            cnt = 0
            for kp in all_kps:
                orig = int(kp[0])
                n = self.map_24.get(orig) if n_kp == 24 else orig
                if n is None:
                    continue
                kps_out[n] = (kp[1], kp[2], 2)
                cnt += 1
            blob['annotations'].append({
                'image_id': im_id, 'category_id': 1, 'iscrowd': 0,
                'id': car_id, 'area': box[2] * box[3], 'bbox': box,
                'num_keypoints': cnt,
                'keypoints': list(kps_out.reshape(-1)),
                'segmentation': [],
            })

    @staticmethod
    def _mask_entries(mask_path, im_id, json_24, json_66):
        """Ignore-mask blobs become crowd annotations."""
        import cv2

        assert os.path.isfile(mask_path), mask_path
        im_gray = cv2.imread(mask_path, cv2.IMREAD_GRAYSCALE)
        blur = cv2.GaussianBlur(im_gray, (0, 0), sigmaX=3, sigmaY=3,
                                borderType=cv2.BORDER_DEFAULT)
        contours, _ = cv2.findContours(blur, cv2.RETR_TREE,
                                       cv2.CHAIN_APPROX_NONE)
        for idx, mask in enumerate(contours):
            box = cv2.boundingRect(mask)
            entry = {
                'image_id': im_id, 'category_id': 1, 'iscrowd': 1,
                'id': int(f'{im_id}00{idx}'),
                'area': box[2] * box[3], 'bbox': box,
                'num_keypoints': 0, 'keypoints': [], 'segmentation': [],
            }
            json_24['annotations'].append(entry)
            json_66['annotations'].append(entry)


def show_histogram(kp_counts):
    """Bar chart of per-keypoint annotation counts (reference
    apollo_to_coco.py:308-315)."""
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        LOG.warning('matplotlib not available: keypoint counts = %s',
                    kp_counts.tolist())
        return
    bins = np.arange(len(kp_counts))
    plt.figure()
    plt.title('Distribution of the keypoints')
    plt.bar(bins, np.asarray(kp_counts))
    plt.xticks(np.arange(len(kp_counts), step=5))
    plt.show()


def main():
    args = cli()
    ApolloToCoco.sample = args.sample
    ApolloToCoco.single_sample = args.single_sample
    ApolloToCoco.split_images = args.split_images
    ApolloToCoco.histogram = args.histogram
    converter = ApolloToCoco(args.dir_data, args.dir_out)
    converter.process()


if __name__ == '__main__':
    main()
