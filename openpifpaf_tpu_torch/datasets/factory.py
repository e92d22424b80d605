"""Dataset registry and factory (counterpart of
``openpifpaf_tpu/datasets/factory.py``). ``DATAMODULES`` is filled by
plugin discovery (``openpifpaf_tpu_torch/plugin.py``) on first use, not at
import. Multi-dataset training, the ``cocokp-cocodet`` names, is not ported
yet (ROADMAP A11)."""

DATAMODULES = {}


def datamodules():
    """name -> DataModule class, every plugin registered."""
    from .. import plugin
    plugin.register()
    return DATAMODULES


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
