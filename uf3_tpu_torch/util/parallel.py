"""
Host task-pool helpers without pandas: scatter dataset batches to a
concurrent.futures executor and gather and merge the results.

Counterpart of ``uf3_tpu/util/parallel.py``: ``ProgressText``,
``progress_iter``, ``split_dataframe`` (over ``data.io.Dataset``, the
same ``np.linspace`` bounds), ``batch_submit``, ``gather_and_merge``
(``FeatureTable``s concatenated by rows, dicts merged, arrays
concatenated) and ``get_executor``.  The executor's workers start by
``spawn``: a worker forked from a process that has used the CUDA card
cannot use it, and the host featurizer it serves never touches the
card, so spawning costs only each worker's start-up (its imports).
"""

import multiprocessing
import sys
import time
from concurrent import futures as cf
from typing import Callable, List

import numpy as np

from uf3_tpu_torch.representation.process import FeatureTable


class ProgressText:
    """Timestamped text progress counter (tqdm-free)."""

    def __init__(self, iterable, total=None, frequency=10):
        self.iterable = iterable
        self.total = total if total is not None else len(iterable)
        self.frequency = frequency

    def __iter__(self):
        start = time.time()
        interval = max(1, self.total // self.frequency)
        for i, item in enumerate(self.iterable):
            if i % interval == 0:
                elapsed = time.time() - start
                print(f"[{elapsed:8.1f}s] {i}/{self.total}",
                      file=sys.stderr)
            yield item


def progress_iter(iterable, total=None, style=None):
    """Wrap an iterable with an optional progress indicator."""
    if style in (None, False, "none"):
        return iterable
    if style == "bar":
        try:
            from tqdm import tqdm
            return tqdm(iterable, total=total)
        except ImportError:
            pass
    return ProgressText(iterable, total=total)


def split_dataframe(df, n_batches: int) -> List:
    """``df`` (a ``Dataset``) in at most ``n_batches`` consecutive,
    non-empty batches, as the reference splits a DataFrame."""
    n_batches = min(n_batches, max(1, len(df)))
    bounds = np.linspace(0, len(df), n_batches + 1).astype(int)
    return [df.take(range(bounds[i], bounds[i + 1]))
            for i in range(n_batches) if bounds[i] < bounds[i + 1]]


def batch_submit(func: Callable, batches: List, client, **kwargs) -> List:
    """Submit one task per batch to a concurrent.futures-style executor."""
    return [client.submit(func, batch, **kwargs) for batch in batches]


def gather_and_merge(future_list: List, client=None, cancel: bool = False,
                     progress=None):
    """Collect futures in the order they finish and merge the results:
    ``FeatureTable``s by rows, dicts by key, arrays by rows; an empty
    ``FeatureTable`` where there is none."""
    results = [future.result() for future in cf.as_completed(future_list)]
    if not results:
        return FeatureTable([], [], np.zeros((0, 0)))
    first = results[0]
    if isinstance(first, FeatureTable):
        return FeatureTable([key for r in results for key in r.index],
                            first.columns,
                            np.concatenate([r.values for r in results]))
    if isinstance(first, dict):
        merged = {}
        for result in results:
            merged.update(result)
        return merged
    return np.concatenate(results)


def get_executor(n_workers: int = 4):
    """Process-pool executor for featurization batches, its workers
    started by ``spawn``."""
    return cf.ProcessPoolExecutor(
        max_workers=n_workers,
        mp_context=multiprocessing.get_context("spawn"))
