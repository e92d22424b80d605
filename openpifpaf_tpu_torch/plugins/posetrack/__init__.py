"""PoseTrack plugin of the port (copy of ``openpifpaf_tpu/plugins/posetrack``
without ``draw_poses.py``, which needs ``show/``, ROADMAP A13): the
``cocokpst`` data module (tracking training from still COCO images),
``posetrack2018`` (the video dataset: train, val and eval) and
``posetrack2017`` (eval only, old annolist format), the PoseTrack metric
and the tracking benchmark wrapper. ``register()`` registers the three
data modules."""


def register():
    from ...datasets.factory import DATAMODULES
    from .cocokpst import CocoKpSt
    from .posetrack2017 import Posetrack2017
    from .posetrack2018 import Posetrack2018
    DATAMODULES['cocokpst'] = CocoKpSt
    DATAMODULES['posetrack2018'] = Posetrack2018
    DATAMODULES['posetrack2017'] = Posetrack2017
