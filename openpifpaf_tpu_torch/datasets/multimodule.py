"""MultiDataModule (copy of ``openpifpaf_tpu/datasets/multimodule.py``):
the data modules of ``--dataset a-b`` side by side, their heads
concatenated in order."""

from .module import DataModule
from .multiloader import MultiLoader


class ConcatenatedLists:
    def __init__(self, lists):
        self.lists = lists

    def __iter__(self):
        for l in self.lists:
            yield from l

    def __getitem__(self, index):
        for l in self.lists:
            if index < len(l):
                return l[index]
            index -= len(l)
        raise IndexError

    def __len__(self):
        return sum(len(l) for l in self.lists)


class MultiDataModule(DataModule):
    """The JAX package sets ``--batch-size`` and ``--loader-workers`` on
    this object only, so its datasets keep the class defaults (batch 1);
    here the two settings pass on to every dataset."""

    #: --dataset-weights: round-robin sampling weights per dataset
    weights = None

    def __init__(self, datamodules):
        self.datamodules = datamodules
        self.head_metas = list(ConcatenatedLists(
            [dm.head_metas for dm in datamodules]))

    @property
    def batch_size(self):
        return self.datamodules[0].batch_size

    @batch_size.setter
    def batch_size(self, value):
        for dm in self.datamodules:
            dm.batch_size = value

    @property
    def loader_workers(self):
        return self.datamodules[0].loader_workers

    @loader_workers.setter
    def loader_workers(self, value):
        for dm in self.datamodules:
            dm.loader_workers = value

    def metrics(self):
        return [m for dm in self.datamodules for m in dm.metrics()]

    def train_loader(self):
        return MultiLoader([dm.train_loader() for dm in self.datamodules],
                           len(self.head_metas), weights=self.weights)

    def val_loader(self):
        return MultiLoader([dm.val_loader() for dm in self.datamodules],
                           len(self.head_metas), weights=self.weights)

    def eval_loader(self):
        raise NotImplementedError('use the individual datamodules for eval')
