"""The seeds of one run, drawn from ``--seed`` (any whole number, past
32 bits too): the env's, the trainer's (action noise,
minibatch order, initial episode lengths), the weights' and the one that
draws the env steps the check follows. The same
``--seed`` gives the same four."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Seeds:
    env: int
    train: int
    weights: int
    traffic: int


def from_seed(seed):
    words = np.random.SeedSequence(int(seed) % 2 ** 63).generate_state(4)
    # below 2**31 - 8: the port adds small offsets to the trainer's seed
    # and numpy's legacy generators take 32 bits
    env, train, weights, traffic = (int(w) % (2 ** 31 - 8) for w in words)
    return Seeds(env=env, train=train, weights=weights, traffic=traffic)
