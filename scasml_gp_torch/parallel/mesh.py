"""Device meshes over ``torch.distributed``, and the collectives they use.

Port of ``scasml_gp_tpu/parallel/mesh.py``.  The JAX package runs one
process over a ``Mesh`` of devices partitioned by GSPMD; here one process
runs per card (NCCL between cards, gloo between CPU processes) and every
rank runs the same program.  The workload's two parallel axes:

- ``data``: the test batch of the Picard rollouts.  Each rank rolls out its
  rows (picard/mlp.py ``_PicardBase``) and the ranks of the data axis
  gather the outputs.
- ``model``: the training rows of the GP.  Each rank evaluates the
  posterior against its slice of the stacked training rows and the ranks of
  the model axis add the partial sums (gp/posterior.py ``shard_dom``); the
  dense trainer assembles a row block of the Gram and gathers it, the dual-CG
  trainer keeps its row block of K (gp/distributed.py).

Ranks are laid out row-major, ``rank = data_index * model + model_index``,
as the JAX package reshapes its devices to (data, model).  With one rank the
mesh is 1 x 1, needs no process group, and every collective is the identity.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class Mesh:
    """A ('data', 'model') layout of the ranks of the default process group.

    ``data_group`` holds the ranks with this rank's model index (they split
    the batch), ``model_group`` the ranks with its data index (they split
    the training rows); either is None where its axis has one rank."""

    def __init__(self, data: int, model: int, rank: int = 0,
                 data_group=None, model_group=None):
        self.data, self.model = int(data), int(model)
        self.rank = int(rank)
        self.data_index, self.model_index = divmod(self.rank, self.model)
        self.data_group, self.model_group = data_group, model_group

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, rank={self.rank})")


def check_mesh(mesh):
    """``mesh`` itself, which must be None or a :class:`Mesh`."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a scasml_gp_torch.parallel.mesh.Mesh "
                        f"(make_mesh), got {type(mesh).__name__}")
    return mesh


def world() -> Tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(data: int = -1, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """2-D ('data', 'model') mesh over the ranks; data=-1 uses all the ranks
    that remain.  Every rank must call it, with the same arguments: it
    creates the process groups of both axes.  ``devices`` is accepted for
    the JAX signature; each rank owns its own device here."""
    del devices
    rank, n = world()
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data*model} > {n} devices")
    if data * model < n:
        raise ValueError(f"mesh {data}x{model} leaves {n - data * model} of {n} "
                         "ranks out; every rank runs the same program, so the "
                         "mesh must hold them all")
    data_group = model_group = None
    if data > 1:
        # one group per model index; every rank creates every group
        for mi in range(model):
            g = dist.new_group([di * model + mi for di in range(data)])
            if rank % model == mi:
                data_group = g
    if model > 1:
        for di in range(data):
            g = dist.new_group([di * model + mi for mi in range(model)])
            if rank // model == di:
                model_group = g
    return Mesh(data, model, rank, data_group, model_group)


def split_range(n: int, parts: int, index: int) -> Tuple[int, int]:
    """Rows [lo, hi) of part ``index`` when n rows are split over ``parts``
    ranks as evenly as contiguous blocks allow."""
    return index * n // parts, (index + 1) * n // parts


def batch_sharding(mesh: Mesh, n: int) -> Tuple[int, int]:
    """The rows [lo, hi) of a batch of n that this rank rolls out: its block
    of the 'data' axis, or all n (replicated) when the batch does not divide
    the axis, as the JAX package falls back to replication."""
    if mesh.data <= 1 or n % mesh.data:
        return 0, n
    return split_range(n, mesh.data, mesh.data_index)


def train_point_sharding(mesh: Mesh, m: int) -> Tuple[int, int]:
    """The training rows [lo, hi) of m that this rank's 'model' index owns."""
    return split_range(m, mesh.model, mesh.model_index)


def replicated(mesh: Mesh, n: int) -> Tuple[int, int]:
    """Every rank holds all n rows."""
    return 0, n


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a batch sharded over 'data'."""
    lo, hi = batch_sharding(mesh, x.shape[0])
    return x[lo:hi]


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0):
    """Pad an axis with zeros to a multiple; returns (padded, n)."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis), n


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Join the default process group.  A no-op for one process.  Without
    arguments it reads a ``torchrun`` launch (WORLD_SIZE, RANK,
    MASTER_ADDR/MASTER_PORT); otherwise ``coordinator`` is "host:port" of
    rank 0.  ``backend`` defaults to NCCL where CUDA is available and gloo
    elsewhere."""
    if dist.is_initialized():
        return
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
        if num_processes <= 1:
            return
        init_method, process_id = "env://", int(os.environ["RANK"])
    else:
        if num_processes <= 1:
            return
        init_method = f"tcp://{coordinator}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(num_processes), rank=int(process_id))


def rank_device(device=None) -> torch.device:
    """The device a rank runs on: ``device`` as given, except that a bare
    ``cuda`` (or None) becomes ``cuda:<LOCAL_RANK>``, one card per rank."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", world()[0])))
    return dev


def _stage(t: torch.Tensor, group) -> Tuple[torch.Tensor, bool]:
    """gloo moves CUDA tensors through host memory: the tensor the collective
    takes, and whether it was copied there."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu(), True
    return t, False


def all_gather_rows(t: torch.Tensor, group, counts: Sequence[int]) -> torch.Tensor:
    """The group's tensors concatenated along dim 0 in rank order; rank i of
    the group contributes ``counts[i]`` rows (rows past them are padding of
    the collective and dropped).  The identity without a group."""
    if group is None:
        return t
    width = max(counts)
    src, staged = _stage(t.contiguous(), group)
    if src.shape[0] < width:
        src = torch.cat([src, src.new_zeros((width - src.shape[0],) + src.shape[1:])])
    parts: List[torch.Tensor] = [torch.empty_like(src) for _ in counts]
    dist.all_gather(parts, src, group=group)
    out = torch.cat([p[:c] for p, c in zip(parts, counts)])
    return out.to(t.device) if staged else out


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum over the group's ranks (every rank gets the same
    bits); the identity without a group."""
    if group is None:
        return t
    src, staged = _stage(t.contiguous(), group)
    if not staged:
        src = src.clone()
    dist.all_reduce(src, op=dist.ReduceOp.SUM, group=group)
    return src.to(t.device) if staged else src
