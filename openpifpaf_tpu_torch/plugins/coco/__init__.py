"""COCO plugin: the cocokp data module, its constants and head metas. The
cocodet data module is not ported yet (ROADMAP A9)."""


def register():
    from ...datasets.factory import DATAMODULES
    from .cocokp import CocoKp
    DATAMODULES['cocokp'] = CocoKp
