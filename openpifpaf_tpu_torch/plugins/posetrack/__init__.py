"""PoseTrack plugin of the port (copy of ``openpifpaf_tpu/plugins/posetrack``):
the ``cocokpst`` data module (tracking training from still COCO images),
``posetrack2018`` (the video dataset: train, val and eval) and
``posetrack2017`` (eval only, old annolist format), the PoseTrack metric
and the tracking benchmark wrapper. ``register()`` registers the three
data modules and the published tracking checkpoint names."""


def register():
    from ...datasets.factory import DATAMODULES
    from .cocokpst import CocoKpSt
    from .posetrack2017 import Posetrack2017
    from .posetrack2018 import Posetrack2018
    DATAMODULES['cocokpst'] = CocoKpSt
    DATAMODULES['posetrack2018'] = Posetrack2018
    DATAMODULES['posetrack2017'] = Posetrack2017
    _register_checkpoints()


def _register_checkpoints():
    from ...models import factory as models_factory
    models_factory.CHECKPOINT_URLS['tshufflenetv2k16'] = \
        models_factory.PRETRAINED_UNAVAILABLE
    models_factory.CHECKPOINT_URLS['tshufflenetv2k30'] = (
        'http://github.com/openpifpaf/torchhub/releases/download/v0.12.10/'
        'tshufflenetv2k30-210628-075118-posetrack2018-cocokpst-'
        'slurm668247-o25-3d734bb8.pkl')
