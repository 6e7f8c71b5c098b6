"""Motion blur: geometry transform updates (counterpart of
render/motion_blur.py).

The moveGeom kernel + buildTransformationMatrix (pathtrace.cu:308-331,
441-446): every 4th iteration below iteration 3000, each geom's translation
is advanced by ``vel * dt`` and its transform triple is rebuilt, as batched
matrix code over all geoms at once.
"""
from __future__ import annotations

import dataclasses

import torch

from ..scene.structs import Geoms


def _build_matrices(translation: torch.Tensor, rotation_deg: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Batched T @ Rx @ Ry @ Rz @ S, (G, 4, 4)."""
    g = translation.shape[0]
    r = torch.deg2rad(rotation_deg)
    cx, sx = torch.cos(r[:, 0]), torch.sin(r[:, 0])
    cy, sy = torch.cos(r[:, 1]), torch.sin(r[:, 1])
    cz, sz = torch.cos(r[:, 2]), torch.sin(r[:, 2])
    zeros = torch.zeros((g,), dtype=translation.dtype, device=translation.device)
    ones = torch.ones_like(zeros)

    def mat(rows):
        return torch.stack([torch.stack(r_, dim=-1) for r_ in rows], dim=-2)

    rx = mat([[ones, zeros, zeros, zeros],
              [zeros, cx, -sx, zeros],
              [zeros, sx, cx, zeros],
              [zeros, zeros, zeros, ones]])
    ry = mat([[cy, zeros, sy, zeros],
              [zeros, ones, zeros, zeros],
              [-sy, zeros, cy, zeros],
              [zeros, zeros, zeros, ones]])
    rz = mat([[cz, -sz, zeros, zeros],
              [sz, cz, zeros, zeros],
              [zeros, zeros, ones, zeros],
              [zeros, zeros, zeros, ones]])
    t = mat([[ones, zeros, zeros, translation[:, 0]],
             [zeros, ones, zeros, translation[:, 1]],
             [zeros, zeros, ones, translation[:, 2]],
             [zeros, zeros, zeros, ones]])
    s = mat([[scale[:, 0], zeros, zeros, zeros],
             [zeros, scale[:, 1], zeros, zeros],
             [zeros, zeros, scale[:, 2], zeros],
             [zeros, zeros, zeros, ones]])
    return t @ rx @ ry @ rz @ s


def advance_geoms(geoms: Geoms, dt: float = 0.10) -> Geoms:
    """Integrate vel into translation and rebuild the transform triples.

    Geoms with zero velocity are untouched (moveGeom's early-out,
    pathtrace.cu:325-326).
    """
    moving = (geoms.vel != 0.0).any(dim=-1)
    new_translation = torch.where(moving[:, None],
                                  geoms.translation + geoms.vel * dt,
                                  geoms.translation)
    m = _build_matrices(new_translation, geoms.rotation, geoms.scale)
    inv = torch.linalg.inv(m)
    sel = moving[:, None, None]
    return dataclasses.replace(
        geoms, translation=new_translation,
        transform=torch.where(sel, m, geoms.transform),
        inverse_transform=torch.where(sel, inv, geoms.inverse_transform),
        inv_transpose=torch.where(sel, inv.transpose(-1, -2), geoms.inv_transpose))
