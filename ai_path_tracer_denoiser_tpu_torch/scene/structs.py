"""Scene data model as tensors (counterpart of scene/structs.py).

Struct-of-arrays dataclasses, one tensor per field, on the scene's device
(``Scene.to``).  The camera is the exception: its fourteen floats are
host-side parameters (the JAX megakernel reads them from SMEM scalars, the
CUDA megakernel takes them as kernel arguments), so ``Camera`` stays on
the CPU whatever the scene's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

# Geometry type ids — match the reference enum order (sceneStructs.h:10-13).
SPHERE = 0
CUBE = 1

# Meshes of this many faces or more get a cluster BVH in the JAX package
# (ops/bvh.py), which is not ported yet: the port loads them without a
# hierarchy and refuses to render them (ROADMAP queue B, "ops/bvh.py").
BVH_MIN_FACES = 65


def _t(a, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype)))


@dataclasses.dataclass
class Geoms:
    """SoA of analytic primitives (reference ``Geom``, sceneStructs.h:20-30)."""

    type: torch.Tensor          # (G,) int32, SPHERE/CUBE
    material_id: torch.Tensor   # (G,) int32
    translation: torch.Tensor   # (G, 3) f32
    rotation: torch.Tensor      # (G, 3) f32 — degrees, XYZ order
    scale: torch.Tensor         # (G, 3) f32
    vel: torch.Tensor           # (G, 3) f32 — motion-blur velocity
    transform: torch.Tensor           # (G, 4, 4) f32
    inverse_transform: torch.Tensor   # (G, 4, 4) f32
    inv_transpose: torch.Tensor       # (G, 4, 4) f32
    # Host mirror of ``type``: lets the plain intersector unroll one test
    # per geom instead of evaluating both.
    type_tuple: Tuple[int, ...] = ()

    @property
    def count(self) -> int:
        return self.type.shape[0]

    def to(self, device) -> "Geoms":
        return _to(self, device)


@dataclasses.dataclass
class Materials:
    """SoA material table (reference ``Material``, sceneStructs.h:46-56)."""

    color: torch.Tensor              # (M, 3)
    specular_exponent: torch.Tensor  # (M,)
    specular_color: torch.Tensor     # (M, 3)
    has_reflective: torch.Tensor     # (M,)
    has_refractive: torch.Tensor     # (M,)
    index_of_refraction: torch.Tensor  # (M,)
    emittance: torch.Tensor          # (M,)

    @property
    def count(self) -> int:
        return self.color.shape[0]

    def to(self, device) -> "Materials":
        return _to(self, device)


@dataclasses.dataclass
class MeshData:
    """SoA triangle soup (reference ``Face``, sceneStructs.h:40-44).

    Faces are padded to a multiple; ``valid`` masks the padding and
    ``num_faces`` is the true count.  ``needs_bvh``: the JAX package would
    attach a cluster hierarchy to this mesh (num_faces >= BVH_MIN_FACES);
    the port has none yet and its renderer refuses such meshes.
    """

    vertices: torch.Tensor     # (F, 3, 3) f32 — world-space, pre-transformed
    normals: torch.Tensor      # (F, 3, 3) f32 — unit, per-vertex
    material_id: torch.Tensor  # (F,) int32
    valid: torch.Tensor        # (F,) bool
    aabb_lb: torch.Tensor      # (3,) f32 (reference MeshBoundingBox)
    aabb_ub: torch.Tensor      # (3,) f32
    num_faces: int = 0
    needs_bvh: bool = False

    def to(self, device) -> "MeshData":
        return _to(self, device)


@dataclasses.dataclass
class Camera:
    """Pinhole camera (reference ``Camera``, sceneStructs.h:58-67).

    Always CPU float32 tensors (see the module docstring);
    ``resolution`` is (width, height).
    """

    position: torch.Tensor      # (3,)
    look_at: torch.Tensor       # (3,)
    view: torch.Tensor          # (3,)
    up: torch.Tensor            # (3,)
    right: torch.Tensor         # (3,)
    fov: torch.Tensor           # (2,) degrees (fovx, fovy)
    pixel_length: torch.Tensor  # (2,)
    resolution: Tuple[int, int] = (800, 800)


@dataclasses.dataclass
class Scene:
    """Full scene: geometry + materials + mesh + camera + render state."""

    geoms: Geoms
    materials: Materials
    mesh: MeshData
    camera: Camera
    iterations: int = 5000
    trace_depth: int = 8
    image_name: str = "render"

    @property
    def device(self) -> torch.device:
        return self.geoms.transform.device

    def to(self, device) -> "Scene":
        return dataclasses.replace(self, geoms=self.geoms.to(device),
                                   materials=self.materials.to(device),
                                   mesh=self.mesh.to(device))


def _to(obj, device):
    changes = {f.name: getattr(obj, f.name).to(device)
               for f in dataclasses.fields(obj)
               if isinstance(getattr(obj, f.name), torch.Tensor)}
    return dataclasses.replace(obj, **changes)


# ---------------------------------------------------------------------------
# Transform construction
# ---------------------------------------------------------------------------

def build_transformation_matrix(translation, rotation, scale) -> np.ndarray:
    """T * Rx * Ry * Rz * S with rotations in degrees (utilities.cpp:44-51)."""
    t = np.asarray(translation, np.float64)
    r = np.radians(np.asarray(rotation, np.float64))
    s = np.asarray(scale, np.float64)

    def rot_x(a):
        c, si = math.cos(a), math.sin(a)
        return np.array([[1, 0, 0, 0], [0, c, -si, 0], [0, si, c, 0], [0, 0, 0, 1]], np.float64)

    def rot_y(a):
        c, si = math.cos(a), math.sin(a)
        return np.array([[c, 0, si, 0], [0, 1, 0, 0], [-si, 0, c, 0], [0, 0, 0, 1]], np.float64)

    def rot_z(a):
        c, si = math.cos(a), math.sin(a)
        return np.array([[c, -si, 0, 0], [si, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)

    tm = np.eye(4, dtype=np.float64)
    tm[:3, 3] = t
    sm = np.diag(np.concatenate([s, [1.0]]).astype(np.float64))
    m = tm @ rot_x(r[0]) @ rot_y(r[1]) @ rot_z(r[2]) @ sm
    return m.astype(np.float32)


def geom_matrices(translation, rotation, scale):
    """(transform, inverse, inverse-transpose) triplet for one geom."""
    m = build_transformation_matrix(translation, rotation, scale).astype(np.float64)
    inv = np.linalg.inv(m)
    return (m.astype(np.float32), inv.astype(np.float32),
            inv.T.copy().astype(np.float32))


# ---------------------------------------------------------------------------
# Construction helpers (CPU tensors; ``Scene.to`` moves them)
# ---------------------------------------------------------------------------

def make_geoms(records) -> Geoms:
    """Build a ``Geoms`` SoA from a list of dict records."""
    if not records:
        z3 = np.zeros((0, 3), np.float32)
        z44 = np.zeros((0, 4, 4), np.float32)
        zi = np.zeros((0,), np.int32)
        return Geoms(_t(zi, np.int32), _t(zi, np.int32), _t(z3, np.float32),
                     _t(z3, np.float32), _t(z3, np.float32),
                     _t(z3, np.float32), _t(z44, np.float32),
                     _t(z44, np.float32), _t(z44, np.float32), type_tuple=())
    mats = [geom_matrices(r["translation"], r["rotation"], r["scale"]) for r in records]
    return Geoms(
        type_tuple=tuple(int(r["type"]) for r in records),
        type=_t([r["type"] for r in records], np.int32),
        material_id=_t([r["material_id"] for r in records], np.int32),
        translation=_t([r["translation"] for r in records], np.float32),
        rotation=_t([r["rotation"] for r in records], np.float32),
        scale=_t([r["scale"] for r in records], np.float32),
        vel=_t([r.get("vel", (0, 0, 0)) for r in records], np.float32),
        transform=_t(np.stack([m[0] for m in mats]), np.float32),
        inverse_transform=_t(np.stack([m[1] for m in mats]), np.float32),
        inv_transpose=_t(np.stack([m[2] for m in mats]), np.float32),
    )


def make_materials(records) -> Materials:
    def arr(key, default, width=None):
        a = np.array([r.get(key, default) for r in records], np.float32)
        if width and a.ndim == 1:
            a = np.tile(a[:, None], (1, width))
        return _t(a, np.float32)

    return Materials(
        color=arr("color", (0, 0, 0)),
        specular_exponent=arr("specular_exponent", 0.0),
        specular_color=arr("specular_color", (0, 0, 0)),
        has_reflective=arr("has_reflective", 0.0),
        has_refractive=arr("has_refractive", 0.0),
        index_of_refraction=arr("index_of_refraction", 0.0),
        emittance=arr("emittance", 0.0),
    )


def pad_faces(vertices: np.ndarray, normals: np.ndarray, material_id: np.ndarray,
              multiple: int = 128):
    """Pad the face axis to a multiple with invalid faces."""
    f = vertices.shape[0]
    f_pad = max(multiple, ((f + multiple - 1) // multiple) * multiple)
    pad = f_pad - f
    if pad:
        vertices = np.concatenate([vertices, np.zeros((pad, 3, 3), np.float32)])
        normals = np.concatenate([normals, np.zeros((pad, 3, 3), np.float32)])
        material_id = np.concatenate([material_id, np.full((pad,), -1, np.int32)])
    valid = np.arange(f_pad) < f
    return vertices, normals, material_id, valid


def make_mesh(vertices: np.ndarray, normals: np.ndarray, material_id: np.ndarray,
              multiple: int = 128) -> MeshData:
    """Build padded ``MeshData`` + AABB from world-space triangles.

    The AABB mirrors Scene::update_mesh_box (scene.h:28-44) with the upper
    bound initialised to -inf (see the JAX package's make_mesh).  Faces
    keep file order: no hierarchy is built, so no Morton reorder happens.
    """
    num = int(vertices.shape[0])
    vertices = np.asarray(vertices, np.float32)
    normals = np.asarray(normals, np.float32)
    material_id = np.asarray(material_id, np.int32)
    if num:
        lb = vertices.reshape(-1, 3).min(axis=0)
        ub = vertices.reshape(-1, 3).max(axis=0)
    else:
        lb = np.zeros(3, np.float32)
        ub = np.zeros(3, np.float32)
    v, n, m, valid = pad_faces(vertices, normals, material_id, multiple)
    return MeshData(
        vertices=_t(v, np.float32), normals=_t(n, np.float32),
        material_id=_t(m, np.int32), valid=_t(valid, np.bool_),
        aabb_lb=_t(lb, np.float32), aabb_ub=_t(ub, np.float32),
        num_faces=num, needs_bvh=num >= BVH_MIN_FACES,
    )


def empty_mesh(multiple: int = 128) -> MeshData:
    return make_mesh(np.zeros((0, 3, 3), np.float32),
                     np.zeros((0, 3, 3), np.float32),
                     np.zeros((0,), np.int32), multiple)
