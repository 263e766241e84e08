"""Data loading: the JAX package's ``runtime/dataloader.py``
(``RepeatingLoader`` and ``DeepSpeedDataLoader``), pure numpy. Batches are
numpy trees (dict-of-arrays, sequence datasets with ``__getitem__`` /
``__len__``, or any iterable); the engine stacks ``gradient_accumulation_steps``
of them into ``[gas, ...]`` leaves and moves them to its device.

Under data parallelism the loader walks the JAX package's global batches
(``batch_size`` = micro x dp) and yields rank ``dp_rank``'s rows of each,
``[dp_rank micro, (dp_rank + 1) micro)``: the rows the JAX engine's
``batch_spec`` puts on that rank's device.
"""

import numpy as np


class RepeatingLoader:
    """Wraps an iterator to restart on StopIteration
    (reference runtime/dataloader.py RepeatingLoader)."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __len__(self):
        return len(self.loader)

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


def _default_collate(samples):
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(np.stack([s[i] for s in samples])
                           for i in range(len(first)))
    return np.stack(samples)


class DeepSpeedDataLoader:

    def __init__(self, dataset, batch_size, collate_fn=None, shuffle=False,
                 drop_last=True, seed=0, num_local_io_workers=None,
                 data_sampler=None, dp_rank=0, dp_world=1):
        if batch_size % dp_world:
            raise ValueError(f"batch size {batch_size} does not divide over "
                             f"{dp_world} data-parallel ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.dp_rank, self.dp_world = dp_rank, dp_world
        self.collate_fn = collate_fn or _default_collate
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.data_sampler = data_sampler
        self._rng = np.random.default_rng(seed)
        self.epoch = 0

    def _batch_sampler(self):
        """A step-driven batch sampler (DeepSpeedDataSampler) yields whole
        global index batches and knows each rank's slice; a torch-style
        sampler yields one index per next() and is finite."""
        if self.data_sampler is not None and \
                hasattr(self.data_sampler, "local_indices"):
            return self.data_sampler
        return None

    def _indices(self):
        if self.data_sampler is not None:  # torch-style per-sample sampler
            return np.asarray(list(iter(self.data_sampler))).reshape(-1)
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        return idx

    def _iter_sampler(self):
        """Step-driven sampler (DeepSpeedDataSampler): an UNBOUNDED iterator
        of global index batches; this loader yields this rank's local slice
        lazily — never materialize it (it does not terminate). One epoch
        here = len(dataset)//batch_size steps."""
        sampler = self._batch_sampler()
        it = iter(sampler)
        for _ in range(len(self)):
            global_idx = np.asarray(next(it)).reshape(-1)
            sel = sampler.local_indices(global_idx)
            yield self.collate_fn([self.dataset[int(i)] for i in sel])
        self.epoch += 1

    def __len__(self):
        sampler = self._batch_sampler()
        if sampler is not None:
            # one epoch = dataset coverage at the sampler's GLOBAL batch
            return max(1, len(self.dataset) // sampler.batch_size)
        if self.data_sampler is not None:
            # torch-style per-sample sampler: its index count rules
            try:
                n = len(self.data_sampler)
            except TypeError:
                n = len(self.dataset)
        else:
            n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        if self._batch_sampler() is not None:
            yield from self._iter_sampler()
            return
        if isinstance(self.dataset, dict):
            yield from self._iter_dict()
            return
        idx = self._indices()
        # batch count from the INDICES actually drawn — a torch-style
        # sampler may cover more or fewer samples than the dataset
        n_batches = (len(idx) // self.batch_size if self.drop_last
                     else (len(idx) + self.batch_size - 1) // self.batch_size)
        for b in range(n_batches):
            sel = self._rows(idx[b * self.batch_size:(b + 1) * self.batch_size])
            samples = [self.dataset[int(i)] for i in sel]
            yield self.collate_fn(samples)
        self.epoch += 1

    def _rows(self, sel):
        """This rank's rows of a global batch's indices."""
        if self.dp_world == 1:
            return sel
        micro = self.batch_size // self.dp_world
        return sel[self.dp_rank * micro:(self.dp_rank + 1) * micro]

    def _iter_dict(self):
        keys = list(self.dataset.keys())
        n = len(self.dataset[keys[0]])
        idx = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(idx)
        n_batches = (n // self.batch_size if self.drop_last
                     else (n + self.batch_size - 1) // self.batch_size)
        for b in range(n_batches):
            sel = self._rows(idx[b * self.batch_size:(b + 1) * self.batch_size])
            yield {k: np.asarray(v)[sel] for k, v in self.dataset.items()}
        self.epoch += 1
