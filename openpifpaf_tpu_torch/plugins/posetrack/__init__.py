"""PoseTrack plugin of the port (copy of ``openpifpaf_tpu/plugins/posetrack``
without ``draw_poses.py``, which needs ``show/``, ROADMAP A13): the
``cocokpst`` data module (tracking training from still COCO images),
``posetrack2018`` (the video dataset: train, val and eval) and
``posetrack2017`` (eval only, old annolist format), the PoseTrack metric
and the tracking benchmark wrapper. ``datasets.factory`` registers the
three data modules."""
