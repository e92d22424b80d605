"""COCO keypoint constants and head metas."""
