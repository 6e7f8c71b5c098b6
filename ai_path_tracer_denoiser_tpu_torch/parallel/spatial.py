"""Spatially sharded denoiser inference: the frame's rows split over
``spatial`` (counterpart of parallel/spatial.py).

Every 3x3 conv exchanges one-row halos with its neighbours
(models/layers.py ``_halo_exchange_rows``, point-to-point sends) instead
of zero padding at the shard edges, and GroupNorm's statistics span the
ranks, so the sharded forward pass is the single-device one.  The local
height must be divisible by 32 (five local max pools): pooling and nearest
upsampling then never cross a shard edge.  The recurrent hidden states are
per rank: they are the rows of this rank.

Each rank takes the whole frame, keeps its rows and hands back the whole
output (one all-gather); the hidden state it returns and takes is its own
rows.  The sequence is a loop over frames carrying the hidden state.
"""
from __future__ import annotations

import torch

from ..models.autoencoder import apply_frame, init_hidden
from ..models.export import model_options_from_params
from .mesh import all_gather_dim, axis_index, axis_size


def _rows(mesh, h: int):
    n_dev = axis_size(mesh, "spatial")
    assert h % n_dev == 0 and (h // n_dev) % 32 == 0, (
        f"H={h} must split into {n_dev} shards divisible by 32")
    local = h // n_dev
    r = axis_index(mesh, "spatial")
    return r * local, (r + 1) * local


def denoise_frame_spatial(params, bn_state, frame: torch.Tensor, mesh,
                          hidden=None, bf16: bool = False):
    """One frame, H sharded over the ``spatial`` mesh axis, in eval mode.

    frame: (N, H, W, 10), the whole frame; returns (out (N, H, W, 3), the
    whole frame on every rank; new_hidden, this rank's rows).
    ``hidden=None`` starts a fresh sequence.
    """
    group = mesh.get_group("spatial")
    lo, hi = _rows(mesh, frame.shape[1])
    x = frame[:, lo:hi].contiguous()
    if hidden is None:
        hidden = init_hidden(x.shape[0], hi - lo, x.shape[2],
                             model_options_from_params(params), device=x.device)
    with torch.no_grad():
        y, new_hidden, _ = apply_frame(params, bn_state, x, hidden, train=False,
                                       bf16=bf16, spatial_axis=group)
        return all_gather_dim(y, group, 1), new_hidden


def denoise_sequence_spatial(params, bn_state, frames: torch.Tensor, mesh,
                             bf16: bool = False) -> torch.Tensor:
    """(T, N, H, W, 10) -> (T, N, H, W, 3), H sharded, hidden carried."""
    _rows(mesh, frames.shape[2])
    hidden, ys = None, []
    for x in frames:
        y, hidden = denoise_frame_spatial(params, bn_state, x, mesh, hidden, bf16)
        ys.append(y)
    return torch.stack(ys)
