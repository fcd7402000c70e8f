"""Dataset sampling — the port's copy of ``vido_slam_tpu/data/samplers.py``
(maskrcnn_benchmark's data/samplers/{distributed.py,
grouped_batch_sampler.py,iteration_based_batch_sampler.py}) as plain index
functions in numpy: the returned index arrays feed
``CocoDetectionDataset.batch``. Equal to the JAX package's functions on
the same arguments (tests/test_torch_train_data.py).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


def shard_epoch(
    n: int,
    num_replicas: int,
    rank: int,
    shuffle: bool = True,
    seed: int = 0,
) -> np.ndarray:
    """DistributedSampler semantics (distributed.py:10-63): a deterministic
    seed-driven permutation, padded by wrap-around so every replica gets
    ceil(n / num_replicas) samples, then strided assignment by rank... the
    reference uses contiguous block assignment (indices[offset:offset+num]),
    which is what we reproduce."""
    if shuffle:
        g = np.random.RandomState(seed)
        indices = g.permutation(n)
    else:
        indices = np.arange(n)
    num_samples = -(-n // num_replicas)
    total = num_samples * num_replicas
    indices = np.concatenate([indices, indices[: total - n]])
    offset = num_samples * rank
    return indices[offset: offset + num_samples]


def grouped_batches(
    aspect_ratios: Sequence[float],
    indices: Sequence[int],
    batch_size: int,
    drop_uneven: bool = False,
) -> List[np.ndarray]:
    """GroupedBatchSampler counterpart: batches contain only samples from
    the same aspect-ratio group (landscape vs portrait — the reference
    groups by the [1] threshold list, grouped_batch_sampler.py), preserving
    the incoming order within each group."""
    indices = np.asarray(indices)
    groups = (np.asarray([aspect_ratios[i] for i in indices]) >= 1.0)
    batches: List[np.ndarray] = []
    for gval in (False, True):
        sel = indices[groups == gval]
        for s in range(0, len(sel), batch_size):
            b = sel[s: s + batch_size]
            if drop_uneven and len(b) < batch_size:
                continue
            batches.append(b)
    return batches


def iteration_batches(
    batches: List[np.ndarray],
    num_iterations: int,
    start_iter: int = 0,
) -> Iterator[np.ndarray]:
    """IterationBasedBatchSampler counterpart: cycle the epoch's batches
    until `num_iterations` total have been yielded."""
    it = start_iter
    while it < num_iterations:
        for b in batches:
            if it >= num_iterations:
                return
            it += 1
            yield b
