"""Dataset registry and factory (counterpart of
``openpifpaf_tpu/datasets/factory.py``). The port has the cocokp and
cocokpst data modules; the JAX package's other plugins and multi-dataset
training (``cocokp-cocodet`` names) are not ported yet (ROADMAP A11)."""


def datamodules():
    """name -> DataModule class."""
    from ..plugins.coco.cocokp import CocoKp
    from ..plugins.posetrack.cocokpst import CocoKpSt
    return {'cocokp': CocoKp, 'cocokpst': CocoKpSt}


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
