"""Duplicate a still image into a synthetic tracking pair (semantics of
reference ``transforms/pair/image_to_tracking.py``): each annotation gets
a track id shared by both frames; downstream pair augmentations then
de-correlate the two frames."""

import copy

from ..preprocess import Preprocess


class ImageToTracking(Preprocess):
    def __call__(self, image, anns, meta):
        group = []
        for group_i in range(2):
            frame_anns = copy.deepcopy(anns)
            for track_id, ann in enumerate(frame_anns):
                ann['track_id'] = track_id
            frame_meta = copy.deepcopy(meta)
            frame_meta['group_i'] = group_i
            group.append((image, frame_anns, frame_meta))
        return tuple(list(column) for column in zip(*group))
