"""Process groups for data-parallel training (counterpart of
`pmf_tpu/parallel/mesh.py`).

pmf_tpu trains one global batch over the `data` axis of a device mesh, and
XLA puts in the reductions that make it one program: global-batch BN
statistics, loss terms over the whole batch, summed gradients and
confusion matrices. The port runs one process a device (torchrun's layout,
the reference's `torch.distributed.launch`), each with `batch_size[0]`
samples of the global batch, and makes the same step explicit: the
reductions are the collectives of `parallel/collectives.py`, over NCCL on
the card and gloo on the CPU.

`make_mesh` lays the processes out as pmf_tpu's (`data`, `model`) device
mesh: rank i at data index i // M and model index i % M. The M ranks of a
model group hold the same samples (pmf_tpu's `shard_batch` replicates the
batch over `model`); while the mesh's `RowSplit` (`parallel/spatial.py`) is
in force they split those samples' image rows between them, the
counterpart of `spatial_batch_sharding`.
"""
from __future__ import annotations

import datetime
import os
from contextvars import ContextVar
from dataclasses import dataclass

import torch
import torch.distributed as dist


def world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) when none is
    up."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _launch_env() -> tuple[str, int, int, int] | None:
    """(init_method, rank, world, local rank) from torchrun's environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) or pmf_tpu's
    (COORDINATOR_ADDRESS host:port, PROCESS_COUNT, PROCESS_ID; one process
    a device here, its local rank LOCAL_RANK or 0); None when neither is
    set."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        return ("env://", int(env["RANK"]), int(env["WORLD_SIZE"]),
                int(env.get("LOCAL_RANK", 0)))
    if all(k in env for k in ("COORDINATOR_ADDRESS", "PROCESS_COUNT", "PROCESS_ID")):
        return (f"tcp://{env['COORDINATOR_ADDRESS']}", int(env["PROCESS_ID"]),
                int(env["PROCESS_COUNT"]), int(env.get("LOCAL_RANK", 0)))
    return None


def init_distributed(device: torch.device | str = "cuda",
                     timeout_s: float = 1800.0) -> tuple[int, int]:
    """Join the process group that the launcher's environment describes:
    NCCL with `cuda:LOCAL_RANK` bound as the current device when `device`
    is a CUDA device, gloo on the CPU. Returns (rank, world size). With no
    launcher variables set it starts nothing and returns (0, 1); with a
    group already up it returns that group's."""
    if dist.is_available() and dist.is_initialized():
        return world()
    launch = _launch_env()
    if launch is None:
        return 0, 1
    init_method, rank, size, local_rank = launch
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(local_rank)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init_method, rank=rank,
                            world_size=size, timeout=datetime.timedelta(seconds=timeout_s))
    return rank, size


def check_mesh(mesh_data: int, mesh_model: int, world_size: int) -> None:
    """The config's mesh against the processes that run it: `mesh_model` = M
    divides the world size, and `mesh_data` is -1 (the rest) or world / M."""
    if mesh_model < 1 or world_size % mesh_model:
        raise ValueError(f"mesh_model={mesh_model} does not divide the {world_size} processes")
    if mesh_data not in (-1, world_size // mesh_model):
        raise ValueError(f"mesh_data={mesh_data} but {world_size} processes run at "
                         f"mesh_model={mesh_model}: set it to -1 or {world_size // mesh_model}")


@dataclass(frozen=True)
class Mesh:
    """The processes as a (data, model) grid: this rank's place in it and the
    process group of its model axis (None when `model` is 1)."""
    data: int
    model: int
    rank: int
    model_group: object = None

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def split(self):
        """A fresh `spatial.RowSplit` over this rank's model group, to put in
        force with `with` around one step."""
        from .spatial import RowSplit

        return RowSplit(self)


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The (data, model) grid of the process group (counterpart of
    `pmf_tpu/parallel/mesh.py: make_mesh`); data = -1 takes world / model.
    Every process must call it, in the same order as its other group calls:
    it creates one process group a model row."""
    rank, size = world()
    check_mesh(data, model, size)
    groups = [None] * (size // model)
    if model > 1:
        groups = [dist.new_group(list(range(d * model, (d + 1) * model)))
                  for d in range(size // model)]
    return Mesh(size // model, model, rank, groups[rank // model])


# the mesh whose row split is in force (parallel/spatial.py: RowSplit)
_ACTIVE: ContextVar = ContextVar("pmf_tpu_torch_row_split", default=None)


def data_world() -> tuple[int, int]:
    """(data index, data size): the rank's row of the global batch and the
    count of rows while a row split is in force, else `world()`. The ranks
    of a model group draw as one."""
    split = _ACTIVE.get()
    if split is None:
        return world()
    return split.mesh.data_index, split.mesh.data


def shutdown() -> None:
    """Leave the process group, if one is up."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
