"""COCO plugin: the keypoint (cocokp) and detection (cocodet) data modules,
their constants and head metas, and the published cocokp and cocodet
checkpoint names."""

_HUB12 = ('http://github.com/vita-epfl/openpifpaf-torchhub/releases/'
          'download/')
_HUB13 = 'http://github.com/openpifpaf/torchhub/releases/download/v0.13/'


def register():
    from ...datasets.factory import DATAMODULES
    from .cocodet import CocoDet
    from .cocokp import CocoKp
    DATAMODULES['cocokp'] = CocoKp
    DATAMODULES['cocodet'] = CocoDet
    _register_checkpoints()


def _register_checkpoints():
    """The reference's published checkpoints (``.pkl`` files that convert
    on load, ``models/convert_torch.py``)."""
    from ...models import factory as models_factory
    urls = models_factory.CHECKPOINT_URLS
    unavailable = models_factory.PRETRAINED_UNAVAILABLE
    urls['mobilenetv2'] = (
        _HUB12 + 'v0.12a5/mobilenetv2-201112-193315-cocokp-1728a9f5.pkl')
    urls['mobilenetv3small'] = (
        _HUB13 + 'mobilenetv3small-210822-213409-cocokp-slurm726252-'
        'edge513-o10s-803b24ae.pkl')
    urls['mobilenetv3large'] = (
        _HUB13 + 'mobilenetv3large-210820-184901-cocokp-slurm725985-'
        'edge513-o10s-6c76cbfb.pkl')
    urls['resnet18'] = unavailable
    urls['resnet50'] = (
        _HUB13 + 'resnet50-210830-150728-cocokp-slurm728641-edge513-'
        'o10s-ecd30da4.pkl')
    urls['resnet101'] = unavailable
    urls['resnet152'] = unavailable
    urls['shufflenetv2x1'] = unavailable
    urls['shufflenetv2x2'] = unavailable
    urls['shufflenetv2k16'] = (
        _HUB13 + 'shufflenetv2k16-210820-232500-cocokp-slurm726069-'
        'edge513-o10s-7189450a.pkl')
    urls['shufflenetv2k16-withdense'] = (
        _HUB12 + 'v0.12b4/shufflenetv2k16-210221-131426-cocokp-'
        'o10s-627d901e.pkl')
    urls['shufflenetv2k30'] = (
        _HUB13 + 'shufflenetv2k30-210821-003923-cocokp-slurm726072-'
        'edge513-o10s-5fe1c400.pkl')
    urls['shufflenetv2k44'] = unavailable
    urls['mobilenetv3small-cocodet'] = (
        _HUB13 + 'mobilenetv3small-210822-215020-cocodet-'
        'slurm726253-5f2c894f.pkl')
    urls['resnet18-cocodet'] = (
        _HUB12 + 'v0.12.10/resnet18-210526-031303-cocodet-'
        'slurm610002-1faf5801.pkl')
