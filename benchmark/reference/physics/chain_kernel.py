"""The reference's stand-in for the port's kernel wrapper: every launch
runs the plain chain step (chain_step.run_decimation_chain) on whatever
device its tensors are on. Its constant table is empty."""
from __future__ import annotations

import numpy as np

from benchmark.reference.physics import chain_step


def const_table(cc):
    return np.zeros(0, np.float32)


def run_decimation(cc, *args, anchors=None, cv=None, consts=None):
    return chain_step.run_decimation_chain(cc, *args, cv=cv,
                                           anchors=anchors)
