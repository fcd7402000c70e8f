"""Device -> host copy of a tree of tensors (tuples and NamedTuples) as one
transfer: the leaves' bytes are packed into one buffer on the device, copied
once and split back into numpy arrays of the same dtypes and shapes.

``to_host`` waits for the copy. ``to_host_async`` enqueues it on the current
stream into a pinned host buffer and returns a ``HostCopy`` whose ``get()``
waits for it, so that the host can do other work (record the previous frame)
while the device finishes this one: the pipelined tracker's counterpart of
the JAX package's ``copy_to_host_async``. A copy from the card into pageable
memory would be synchronous, so the buffers are pinned, and they are reused:
pinning a fresh buffer every frame costs milliseconds. Each byte size keeps
a pool that grows to the number of copies in flight at once (two for the
one-frame pipeline, four for two frames a call); a buffer goes back to its
pool only when ``get()`` has waited for its copy and unpacked it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def _leaves(tree, out):
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    else:
        for x in tree:
            _leaves(x, out)
    return out


def _rebuild(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    items = [_rebuild(x, it) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def _pack(leaves):
    """The leaves as one flat uint8 tensor on their device, and each leaf's
    byte count."""
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in leaves]
    return torch.cat(flat), [b.numel() for b in flat]


def _unpack(buf: np.ndarray, leaves, sizes) -> List[np.ndarray]:
    arrays, off = [], 0
    for t, n in zip(leaves, sizes):
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        arrays.append(buf[off:off + n].view(dtype).reshape(t.shape).copy())
        off += n
    return arrays


def to_host(tree):
    """The tree with every tensor replaced by a numpy array."""
    leaves = _leaves(tree, [])
    if all(t.device.type == "cpu" for t in leaves):
        arrays = [t.numpy() for t in leaves]
    else:
        packed, sizes = _pack(leaves)
        arrays = _unpack(packed.cpu().numpy(), leaves, sizes)
    return _rebuild(tree, iter(arrays))


# free pinned buffers by (device, byte size)
_POOL: Dict[Tuple[str, int], List[torch.Tensor]] = {}


def _pinned(key) -> torch.Tensor:
    free = _POOL.setdefault(key, [])
    buf = free.pop() if free else torch.empty(key[1], dtype=torch.uint8,
                                              pin_memory=True)
    assert buf.is_pinned()
    return buf


class HostCopy:
    """A device -> host copy in flight; ``get()`` waits for it and returns
    the tree with numpy arrays (the same object on every call)."""

    def __init__(self, tree):
        self._tree = tree
        leaves = _leaves(tree, [])
        self._result = None
        if all(t.device.type == "cpu" for t in leaves):
            self._result = to_host(tree)
            return
        self._leaves = leaves
        packed, self._sizes = _pack(leaves)
        self._key = (str(packed.device), packed.numel())
        self._buf = _pinned(self._key)
        self._buf.copy_(packed, non_blocking=True)
        # the packed source stays referenced until the copy is read
        self._packed = packed
        self._event = torch.cuda.Event()
        self._event.record()

    def get(self):
        if self._result is None:
            self._event.synchronize()
            arrays = _unpack(self._buf.numpy(), self._leaves, self._sizes)
            _POOL[self._key].append(self._buf)
            self._buf = self._packed = self._leaves = None
            self._result = _rebuild(self._tree, iter(arrays))
        self._tree = None
        return self._result


def to_host_async(tree) -> HostCopy:
    """Enqueue the copy of ``tree`` to the host on the current stream; on
    the CPU the arrays are taken at once."""
    return HostCopy(tree)
