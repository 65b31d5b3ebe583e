"""Pieces the loops share: the seeded sample of answers kept for the
comparison, the grouping of every answer by the batch it answered, and the
labels a traced window carries."""

from __future__ import annotations

import contextlib
import hashlib
import random
import traceback
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from cardbench.harness import log


class Reservoir:
    """A uniform sample of at most ``size`` of the items offered, drawn
    from ``seed`` (reservoir sampling: the window's length need not be
    known)."""

    def __init__(self, size: int, seed: int):
        self.size = int(size)
        self.rng = random.Random(seed)
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
            return
        j = self.rng.randrange(self.seen)
        if j < self.size:
            self.items[j] = item


def group_answers(answers: List[Tuple[int, np.ndarray]]
                  ) -> Dict[int, List[Tuple[np.ndarray, int]]]:
    """Per batch of the pool, each distinct answer and how many times it
    came back."""
    out: Dict[int, Dict[bytes, list]] = defaultdict(dict)
    for b, ids in answers:
        key = hashlib.blake2b(ids.tobytes(), digest_size=16).digest()
        slot = out[b].setdefault(key, [ids, 0])
        slot[1] += 1
    return {b: [(ids, n) for ids, n in d.values()] for b, d in out.items()}


def p95(values) -> float:
    """The 95th percentile (numpy's linear rule); 0 for no values."""
    return float(np.percentile(values, 95)) if len(values) else 0.0


def labeller(on: bool):
    """``label(name)``: a profiler range on the host's timeline in a traced
    window, nothing otherwise."""
    if not on:
        return lambda name: contextlib.nullcontext()
    import torch

    return torch.profiler.record_function


class Failures:
    """Requests that raised: counted, the first few logged whole."""

    LOGGED = 3

    def __init__(self):
        self.count = 0

    def add(self, what: str) -> None:
        self.count += 1
        if self.count <= self.LOGGED:
            log(f"{what} failed:\n{traceback.format_exc()}")
