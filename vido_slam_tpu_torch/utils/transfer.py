"""Device -> host copy of a tree of tensors (tuples and NamedTuples) as one
transfer: the leaves' bytes are packed into one buffer on the device, copied
once and split back into numpy arrays of the same dtypes and shapes."""

from __future__ import annotations

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


def to_host(tree):
    """The tree with every tensor replaced by a numpy array."""
    leaves = _leaves(tree, [])
    if all(t.device.type == "cpu" for t in leaves):
        arrays = [t.numpy() for t in leaves]
    else:
        flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in leaves]
        buf = torch.cat(flat).cpu().numpy()
        arrays, off = [], 0
        for t, b in zip(leaves, flat):
            n = b.numel()
            dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
            arrays.append(buf[off:off + n].view(dtype).reshape(t.shape).copy())
            off += n
    return _rebuild(tree, iter(arrays))
