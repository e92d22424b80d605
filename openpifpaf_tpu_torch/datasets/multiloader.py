"""MultiLoader (copy of ``openpifpaf_tpu/datasets/multiloader.py``):
weighted round-robin over several dataset loaders. Each dataset's targets
are placed into its global head slots; the other heads get None.

A loader of weight 0 is never picked. The JAX package's loop runs while
any loader has batches left, so once the others are done it picks the
first (exhausted) loader forever; here the epoch ends when every loader
of positive weight is done."""

import logging

LOG = logging.getLogger(__name__)


class MultiLoader:
    def __init__(self, loaders, n_heads, *, weights=None):
        self.loaders = loaders
        self.n_heads = n_heads

        if weights is None:
            weights = [1.0 for _ in loaders]
        assert len(weights) == len(loaders)
        total = sum(weights)
        self.weights = [w / total for w in weights]

    def set_epoch(self, epoch):
        for loader in self.loaders:
            if hasattr(loader, 'set_epoch'):
                loader.set_epoch(epoch)

    def __len__(self):
        return sum(len(l) for l in self.loaders)

    def _expand_targets(self, targets, metas):
        """Place this dataset's targets into the global head slots."""
        out = [None] * self.n_heads
        head_indices = metas[0].get('head_indices', range(len(targets)))
        for t, head_i in zip(targets, head_indices):
            out[head_i] = t
        return out

    def order(self):
        """The loader index of each batch :meth:`__iter__` yields, in
        order, when every loader gives ``len(loader)`` batches."""
        remaining = self._remaining()
        order = []
        while any(r > 0 for r in remaining):
            loader_i = self._pick(remaining)
            remaining[loader_i] -= 1
            order.append(loader_i)
        return order

    def _pick(self, remaining):
        """The loader that is most behind its share; the first one wins a
        tie, as Python's ``max`` does."""
        total_remaining = sum(remaining)
        shares = [
            r / total_remaining / w if w > 0 else 0.0
            for r, w in zip(remaining, self.weights)
        ]
        return max(range(len(self.loaders)), key=lambda i: shares[i])

    def _remaining(self):
        return [len(l) if w > 0 else 0
                for l, w in zip(self.loaders, self.weights)]

    def __iter__(self):
        iterators = [iter(l) for l in self.loaders]
        remaining = self._remaining()

        while any(r > 0 for r in remaining):
            loader_i = self._pick(remaining)
            try:
                images, targets, metas = next(iterators[loader_i])
            except StopIteration:
                remaining[loader_i] = 0
                continue
            remaining[loader_i] -= 1
            yield images, self._expand_targets(targets, metas), metas
