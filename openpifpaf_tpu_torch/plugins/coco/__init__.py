"""COCO plugin: the keypoint (cocokp) and detection (cocodet) data modules,
their constants and head metas."""


def register():
    from ...datasets.factory import DATAMODULES
    from .cocodet import CocoDet
    from .cocokp import CocoKp
    DATAMODULES['cocokp'] = CocoKp
    DATAMODULES['cocodet'] = CocoDet
