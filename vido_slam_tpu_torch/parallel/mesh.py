"""A (dp, tp) process mesh on ``torch.distributed`` — counterpart of
``vido_slam_tpu/parallel/mesh.py``.

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with the
axes ``dp`` (data parallel over the batch, the reference's DDP) and ``tp``
(parameters sharded over conv output channels), and GSPMD inserts the
collectives. Here each rank is one process with one device: rank r sits at
``(r // tp, r % tp)``, as ``np.asarray(devices).reshape(dp, tp)`` places
device r. Its ``dp_group`` holds the ranks of its tp column (the same
``tp_rank``, every dp rank), over which gradients are averaged and results
gathered; its ``tp_group`` holds the ranks of its dp row, over which
parameter shards are gathered.

Backends: NCCL on ``cuda`` (a card a rank), gloo on the CPU.
``init_distributed`` starts the default group from torchrun's variables or
from a ``file://`` store; only it and the CLIs read those variables.
``spawn`` runs a function on n local ranks, each in a fresh process.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vido_slam_tpu_torch.convert import jax_axes
from vido_slam_tpu_torch.utils.device import resolve_device

# a collective that waits longer than this raises instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)


class Mesh:
    """This rank's place in a (dp, tp) mesh over the default process group:
    ``world_size``, ``rank``, ``dp``, ``tp``, ``dp_rank``, ``tp_rank``, the
    groups ``dp_group`` (its tp column) and ``tp_group`` (its dp row), and
    the ``device`` its tensors live on. Every rank must build the same mesh
    at the same point (``torch.distributed.new_group`` is collective)."""

    def __init__(self, dp: int, tp: int, device: torch.device):
        self.world_size = dist.get_world_size()
        self.rank = dist.get_rank()
        if dp * tp != self.world_size:
            raise ValueError(f"mesh {dp}x{tp} != {self.world_size} ranks")
        self.dp, self.tp = dp, tp
        self.dp_rank, self.tp_rank = divmod(self.rank, tp)
        self.device = device
        for t in range(tp):
            g = dist.new_group([d * tp + t for d in range(dp)])
            if t == self.tp_rank:
                self.dp_group = g
        for d in range(dp):
            g = dist.new_group([d * tp + t for t in range(tp)])
            if d == self.dp_rank:
                self.tp_group = g

    @property
    def shape(self) -> Dict[str, int]:
        """{"dp": dp, "tp": tp}, as ``jax.sharding.Mesh.shape``."""
        return {"dp": self.dp, "tp": self.tp}

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.dp}, tp={self.tp}, rank={self.rank}, "
                f"device={self.device})")


def _card(device) -> torch.device:
    """``device`` resolved, a card given its index (the current one)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def init_distributed(device=None, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Start the default process group and return this rank's device.

    With no ``init_method``, the group comes from torchrun's variables
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``); without them it is one rank on an in-process store.
    A ``file://`` ``init_method`` needs ``rank`` and ``world_size`` (the
    local rank is then the rank). NCCL for ``cuda`` (the default) on card
    ``cuda:LOCAL_RANK``, which must exist; gloo for ``cpu``."""
    if dist.is_initialized():
        raise RuntimeError("the default process group is already initialised")
    env = os.environ
    dev = resolve_device(device)
    if init_method is None and "WORLD_SIZE" in env:
        init_method = "env://"
        rank, world_size = int(env["RANK"]), int(env["WORLD_SIZE"])
        local_rank = int(env.get("LOCAL_RANK", rank))
    elif init_method is None:
        rank, world_size, local_rank = 0, 1, 0
    else:
        if rank is None or world_size is None:
            raise ValueError(f"{init_method}: pass rank and world_size")
        local_rank = rank
    if dev.type == "cuda":
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank}: LOCAL_RANK {local_rank}, but this host has "
                f"{torch.cuda.device_count()} CUDA device(s); NCCL needs a "
                f"card a rank")
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = dict(backend=backend, rank=rank, world_size=world_size,
              timeout=TIMEOUT)
    if init_method is not None:
        dist.init_process_group(init_method=init_method, **kw)
    else:
        dist.init_process_group(store=dist.HashStore(), **kw)
    return dev


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: Optional[int] = None, device=None) -> Mesh:
    """Factorise the ranks into a (dp, tp) mesh as the JAX package does
    (mesh.py:29-45): by default everything goes to dp; given one of dp and
    tp, the other is what divides the rest. Needs an initialised default
    process group of ``n_devices`` ranks (default: all of them). ``device``:
    this rank's; by default the one ``init_distributed`` chose with the
    group's backend (the current card for NCCL, the CPU for gloo)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process "
                           "group: call init_distributed() (or run under "
                           "torchrun) first")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} devices over {world} ranks: the "
                         f"world size must be the device count")
    if dp is None and tp is None:
        dp, tp = n, 1
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    backend = dist.get_backend()
    if device is None:
        device = "cuda" if backend == "nccl" else "cpu"
    dev = _card(device)
    if (backend == "nccl") != (dev.type == "cuda"):
        raise ValueError(f"a {dev.type} mesh over a {backend} group")
    return Mesh(dp, tp, dev)


def param_spec(name: str, value: torch.Tensor, tp: int) -> Optional[int]:
    """The torch dim that ``tp`` shards, or None (replicated): the JAX
    package's rule (mesh.py:48-58) applied to the tensor's JAX layout — a
    4-D kernel's dim 3, a 2-D weight's dim 1, a 1-D tensor's dim 0, each
    when tp divides it — mapped back through ``convert.jax_axes``. So the
    same elements are sharded: dim 0 of every 4-D tensor (a Conv2d's cout,
    and a ConvTranspose2d's cin, JAX's dim 3 there) and of a Linear's
    weight."""
    jax_dim = {4: 3, 2: 1, 1: 0}.get(value.ndim)
    if jax_dim is None:
        return None
    d = jax_axes(name, value.ndim)[jax_dim]
    return d if value.shape[d] % tp == 0 else None


def shard_params(params: Dict[str, torch.Tensor],
                 mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's tp shard of each tensor (a detached copy on the mesh's
    device): block ``tp_rank`` of ``param_spec``'s dim, or the whole tensor
    where it replicates."""
    out = {}
    for k, v in params.items():
        d = param_spec(k, v, mesh.tp)
        if d is not None:
            n = v.shape[d] // mesh.tp
            v = v.narrow(d, mesh.tp_rank * n, n)
        out[k] = v.detach().to(mesh.device).clone()
    return out


def gather_params(shards: Dict[str, torch.Tensor], mesh: Mesh,
                  out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """All-gather the tp shards back into the whole tensors ``out`` (in
    place; same keys, whole shapes), one collective a dtype. Returns
    ``out``."""
    with torch.no_grad():
        split = {}
        for k, s in shards.items():
            d = param_spec(k, out[k], mesh.tp)
            if mesh.tp == 1 or d is None:
                out[k].copy_(s)
            else:
                split.setdefault(s.dtype, []).append((k, d))
        for keys in split.values():
            flat = torch.cat([shards[k].reshape(-1) for k, _ in keys])
            parts = [torch.empty_like(flat) for _ in range(mesh.tp)]
            dist.all_gather(parts, flat, group=mesh.tp_group)
            at = 0
            for k, d in keys:
                s = shards[k]
                out[k].copy_(torch.cat([p[at:at + s.numel()].view(s.shape)
                                        for p in parts], d))
                at += s.numel()
    return out


def _tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts, tuples (named too) and
    lists; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh: Mesh):
    """This dp rank's contiguous rows ``[dp_rank B/dp, (dp_rank + 1) B/dp)``
    of every array or tensor of ``batch`` (nested dicts and tuples), as
    ``P("dp")`` places them. Raises unless dp divides each leading size."""
    def rows(x):
        B = x.shape[0]
        if B % mesh.dp:
            raise ValueError(f"a batch of {B} does not divide over "
                             f"dp={mesh.dp}")
        n = B // mesh.dp
        return x[mesh.dp_rank * n:(mesh.dp_rank + 1) * n]
    return _tree_map(rows, batch)


def gather_batch(tree, mesh: Mesh):
    """The inverse of ``shard_batch``: every tensor of ``tree``
    all-gathered over the dp group and stacked along dim 0 in dp order, on
    every rank (the tp ranks of a dp row hold the same rows; each dp row's
    rows come once). Tensors come back on the mesh's device."""
    def gather(x):
        x = x.to(mesh.device).contiguous()
        if mesh.dp == 1:
            return x
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x
        parts = [torch.empty_like(wire) for _ in range(mesh.dp)]
        dist.all_gather(parts, wire, group=mesh.dp_group)
        return torch.cat(parts).to(x.dtype)
    return _tree_map(gather, tree)


def dp_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of ``x`` over the dp group: the sum over the dp ranks,
    divided by dp (the identity for dp 1)."""
    if mesh.dp == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, group=mesh.dp_group)
    return x / mesh.dp


def _rank_main(rank: int, fn: Callable, n: int, device: str, tmp: str,
               args: tuple) -> None:
    if device == "cpu":
        torch.set_num_threads(1)
    init_distributed(device, f"file://{os.path.join(tmp, 'store')}", rank, n)
    try:
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn: Callable, n: int, *args, device: str = "cpu") -> list:
    """Run ``fn(*args)`` on n local ranks, each a fresh process (``spawn``)
    in one default group over a ``file://`` store in a temporary directory
    (gloo on the CPU, one thread a rank; NCCL on ``cuda``, a card a rank).
    ``fn`` must be importable by name; it builds its mesh with
    ``make_mesh``. Returns each rank's return value, in rank order; a rank
    that raises makes this raise."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(fn, n, device, tmp, args),
                           nprocs=n, start_method="spawn")
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
