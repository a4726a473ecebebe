"""Seeded dataset splits (a copy of the JAX package's ``data/splits.py``),
reproducing the reference's index semantics exactly
(lie_vae/experiments/utils.py:10-34): numpy seed 0 permutation with state
save/restore, slices [offset - length : offset] in the order given — so a
(valid, test, train) split selects the same examples as the reference."""
from itertools import accumulate

import numpy as np


class Subset:
    """Index-remapped view with attribute passthrough to the parent
    (reference: Subset, experiments/utils.py:10-22)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)

    def gather(self, indices):
        return self.dataset.gather(self.indices[np.asarray(indices)])

    def __getattr__(self, item):
        return getattr(self.dataset, item)


def random_split(dataset, lengths):
    """Reference: random_split, experiments/utils.py:25-34."""
    if sum(lengths) != len(dataset):
        raise ValueError(f"split lengths {lengths} do not sum to the "
                         f"dataset's {len(dataset)} items")
    state = np.random.get_state()
    np.random.seed(0)
    indices = np.random.permutation(sum(lengths))
    np.random.set_state(state)
    return [Subset(dataset, indices[offset - length:offset])
            for offset, length in zip(accumulate(lengths), lengths)]
