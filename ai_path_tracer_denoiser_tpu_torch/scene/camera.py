"""Camera derivation and the orbit camera (counterpart of scene/camera.py).

Reproduces the reference math: FOV / pixel-length derivation
(scene.cpp:143-152), the interactive orbit rebuild with its *unnormalized*
right/up vectors (main.cpp:122-140), and the initial (phi, theta, zoom)
extraction (main.cpp:66-78).  Camera vectors are float32 CPU tensors,
computed in float32 as the JAX package computes them.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .structs import Camera


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def derive_camera(resolution: Tuple[int, int], fovy_deg: float,
                  position, look_at, up) -> Camera:
    """Build a Camera from scene-file fields (RES/FOVY/EYE/LOOKAT/UP).

    loadCamera's FOV convention: ``yscaled = tan(fovy * pi/180)`` — the full
    fovy as the half-angle tangent argument (scene.cpp:142-152).
    """
    w, h = resolution
    yscaled = math.tan(fovy_deg * (math.pi / 180.0))
    xscaled = (yscaled * w) / h
    fovx = math.degrees(math.atan(xscaled))
    position = np.asarray(position, np.float32)
    look_at = np.asarray(look_at, np.float32)
    up = np.asarray(up, np.float32)
    view = look_at - position
    view = view / np.linalg.norm(view)
    right = np.cross(view, up)
    right = right / np.linalg.norm(right)
    pixel_length = np.array([2 * xscaled / w, 2 * yscaled / h], np.float32)
    return Camera(
        position=_f32(position), look_at=_f32(look_at), view=_f32(view),
        up=_f32(up), right=_f32(right),
        fov=_f32([fovx, fovy_deg]), pixel_length=_f32(pixel_length),
        resolution=(int(w), int(h)),
    )


def orbit_params_from_camera(camera: Camera):
    """Extract (phi, theta, zoom) from a camera, as main.cpp:66-78 does."""
    view = camera.view.numpy()
    view_xz = np.array([view[0], 0.0, view[2]])
    view_zy = np.array([0.0, view[1], view[2]])
    phi = math.acos(float(np.dot(view_xz / np.linalg.norm(view_xz), [0, 0, -1])))
    theta = math.acos(float(np.dot(view_zy / np.linalg.norm(view_zy), [0, 1, 0])))
    zoom = float(np.linalg.norm(camera.position.numpy() - camera.look_at.numpy()))
    return phi, theta, zoom


def orbit_camera(camera: Camera, phi: float, theta: float, zoom: float) -> Camera:
    """Rebuild the camera from spherical orbit parameters (main.cpp:126-138).

    position = lookAt + zoom*(sin phi sin theta, cos theta, cos phi sin theta),
    view = -normalize(offset), right = view x (0,1,0) [unnormalized],
    up = right x view [unnormalized].
    """
    offset = torch.tensor([
        zoom * math.sin(phi) * math.sin(theta),
        zoom * math.cos(theta),
        zoom * math.cos(phi) * math.sin(theta),
    ], dtype=torch.float32)
    view = -offset / torch.linalg.vector_norm(offset)
    u = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32)
    right = torch.linalg.cross(view, u)       # NOT normalized (main.cpp:133)
    up = torch.linalg.cross(right, view)      # NOT normalized (main.cpp:134)
    return Camera(
        position=offset + camera.look_at, look_at=camera.look_at, view=view,
        up=up, right=right, fov=camera.fov,
        pixel_length=camera.pixel_length, resolution=camera.resolution,
    )


def orbit_path(camera: Camera, n_frames: int, dphi: float = 0.01,
               dtheta: float = 0.0, dzoom: float = 0.0):
    """Yield cameras along an orbit pan: frame i at phi + dphi i, theta +
    dtheta i (kept inside (1e-3, pi - 1e-3)) and zoom + dzoom i (at least
    0.1), from the camera's own orbit parameters."""
    phi, theta, zoom = orbit_params_from_camera(camera)
    for i in range(n_frames):
        yield orbit_camera(camera, phi + dphi * i,
                           min(max(theta + dtheta * i, 1e-3), math.pi - 1e-3),
                           max(zoom + dzoom * i, 0.1))
