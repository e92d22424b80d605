"""Dataset plugins of the port, each with a ``register()`` that
``openpifpaf_tpu_torch/plugin.py`` calls: coco (cocokp), posetrack
(cocokpst, posetrack2018, posetrack2017) and the keypoint plugins built on
``datasets/kp_module.py`` (wholebody, crowdpose, animal, apollo)."""
