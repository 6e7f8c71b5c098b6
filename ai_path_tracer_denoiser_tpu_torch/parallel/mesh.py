"""The device mesh over ``torch.distributed`` (counterpart of parallel/mesh.py).

One process per device.  ``make_mesh`` joins the process group (or starts
one) and returns a ``DeviceMesh`` with the JAX package's two axes:

  * ``data``    -- sequences of a batch (data-parallel training) and pixel
                   tiles (tile-parallel rendering);
  * ``spatial`` -- rows of a frame (the denoiser with halo exchange).

Collectives run over ``mesh.get_group("data")`` / ``("spatial")``: the
process groups that the train graph's ``axis_name`` / ``spatial_axis``
arguments take.  The backend follows the device asked for: NCCL on the
card (the default), gloo with ``device="cpu"``.  Under ``torchrun
--nproc-per-node N`` the process joins that world (rank r on
``cuda:LOCAL_RANK``); without the launcher's environment it starts a world
of one on a local store, the counterpart of a JAX mesh over one device.
Nothing falls back: if NCCL cannot start on the card, ``make_mesh`` raises.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..utils.device import resolve_device

AXES = ("data", "spatial")
_TIMEOUT = datetime.timedelta(minutes=10)


def init_world(device=None) -> torch.device:
    """Join the launcher's process group, or start a world of one, on the
    backend of ``device`` (default: the card).  Returns this rank's device."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} process group is running; "
                               f"{dev} needs {backend}")
        return dev
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", timeout=_TIMEOUT)
    else:
        store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True, timeout=_TIMEOUT)
        dist.init_process_group(backend, store=store, rank=0, world_size=1,
                                timeout=_TIMEOUT)
    # NCCL makes its communicator at the first collective: make it now, so
    # that a card where it cannot start fails here
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe)
    if float(probe) != dist.get_world_size():
        raise RuntimeError(f"{backend} all-reduce over {dist.get_world_size()} ranks "
                           f"gave {float(probe)}")
    return dev


def destroy() -> None:
    """Leave the process group (tests; the end of a run)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(data: Optional[int] = None, spatial: int = 1,
              devices: Optional[Sequence[int]] = None,
              device=None) -> DeviceMesh:
    """Mesh over ``data x spatial`` of the ranks ``devices`` (default: the
    whole world, in rank order); ``data`` defaults to all remaining ranks.
    ``device``: where this rank runs (default: the card, over NCCL)."""
    dev = init_world(device)
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    if data is None:
        assert len(ranks) % spatial == 0
        data = len(ranks) // spatial
    assert data * spatial <= len(ranks), (
        f"mesh {data}x{spatial} needs {data * spatial} devices, "
        f"have {len(ranks)}")
    grid = torch.tensor(ranks[: data * spatial], dtype=torch.int64).reshape(data, spatial)
    return DeviceMesh(dev.type, grid, mesh_dim_names=AXES)


def data_spec(mesh: DeviceMesh, axis: int = 0) -> Tuple:
    """Placements (one per mesh axis) that split tensor axis ``axis`` over
    ``data`` and replicate it over ``spatial``."""
    return (Shard(axis), Replicate())


def replicated(mesh: DeviceMesh) -> Tuple:
    return (Replicate(), Replicate())


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def all_gather_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along ``dim``, in rank
    order (one all-gather; no gradient)."""
    n = dist.get_world_size(group)
    src = t.detach().movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    with torch.no_grad():
        _gather_single(out, src, group=group)
    return out.movedim(0, dim)


# torch 2.13 (where the CPU tests run) names the call all_gather_single and
# warns on every call of the old name; torch 2.11 (the card's) has only
# all_gather_into_tensor
_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
