"""Dataset registry and factory (counterpart of
``openpifpaf_tpu/datasets/factory.py``). The port has the cocokp, cocokpst,
posetrack2018 and posetrack2017 data modules. Still missing: the keypoint
plugins built on ``KpDataModule`` (wholebody, crowdpose, animalpose,
apollocar3d) and plugin discovery (ROADMAP A16), cocodet, cifar10 and
nuscenes (ROADMAP A9), and multi-dataset training, the ``cocokp-cocodet``
names (ROADMAP A11)."""


def datamodules():
    """name -> DataModule class."""
    from ..plugins.coco.cocokp import CocoKp
    from ..plugins.posetrack.cocokpst import CocoKpSt
    from ..plugins.posetrack.posetrack2017 import Posetrack2017
    from ..plugins.posetrack.posetrack2018 import Posetrack2018
    return {'cocokp': CocoKp, 'cocokpst': CocoKpSt,
            'posetrack2018': Posetrack2018, 'posetrack2017': Posetrack2017}


def factory(dataset_name: str):
    if '-' in dataset_name:
        raise NotImplementedError(
            f'multi-dataset training ({dataset_name!r}) is not yet ported '
            'to PyTorch (ROADMAP A11)')
    modules = datamodules()
    if dataset_name not in modules:
        raise ValueError(f'dataset {dataset_name!r} unknown; '
                         f'available: {sorted(modules)}')
    return modules[dataset_name]()
