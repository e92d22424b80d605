"""Dataset registry and factory (counterpart of
``openpifpaf_tpu/datasets/factory.py``). ``DATAMODULES`` is filled by
plugin discovery (``openpifpaf_tpu_torch/plugin.py``) on first use, not at
import. ``a-b`` names a :class:`MultiDataModule` of the datasets ``a`` and
``b``, in that order."""

DATAMODULES = {}


def datamodules():
    """name -> DataModule class, every plugin registered."""
    from .. import plugin
    plugin.register()
    return DATAMODULES


def factory(dataset_name: str):
    if '-' in dataset_name:
        from .multimodule import MultiDataModule
        return MultiDataModule([factory(n) for n in dataset_name.split('-')])

    modules = datamodules()
    if dataset_name not in modules:
        raise ValueError(f'dataset {dataset_name!r} unknown; '
                         f'available: {sorted(modules)}')
    return modules[dataset_name]()
