"""Wavefront OBJ triangle loader (counterpart of scene/obj_loader.py).

A numpy copy of the JAX package's pure-Python path (tinyobj's
Scene::loadObj, scene.cpp:259-318): vertices pre-transformed to world
space by the mesh's TRS matrix, file normals normalized or geometric
normals recomputed, polygons triangle-fanned.  The native C++ parser
(utils/native.py) is used when its library is built, as in the JAX
package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _geometric_normal(p0, p1, p2):
    # calculate_geometric_normals (scene.cpp:198-204): normalize(cross(p2-p0, p1-p0))
    n = np.cross(p2 - p0, p1 - p0)
    norm = np.linalg.norm(n)
    return n / norm if norm > 0 else n


def _parse_ref(ref: str):
    comps = ref.split("/")
    ni = int(comps[2]) if len(comps) == 3 and comps[2] else None
    return int(comps[0]), ni


def parse_obj_text(text: str, transform: Optional[np.ndarray] = None,
                   recompute_normals: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Parse OBJ text into (vertices (F,3,3), normals (F,3,3)) world-space f32."""
    positions, normals = [], []
    face_pos_idx, face_nrm_idx = [], []
    for raw in text.split("\n"):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif tag == "vn":
            normals.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif tag == "f":
            refs = [_parse_ref(v) for v in parts[1:]]
            for k in range(1, len(refs) - 1):
                tri = (refs[0], refs[k], refs[k + 1])
                face_pos_idx.append(tuple(r[0] for r in tri))
                face_nrm_idx.append(tuple(r[1] for r in tri)
                                    if all(r[1] is not None for r in tri)
                                    else None)

    pos = np.asarray(positions, np.float64)
    nrm = np.asarray(normals, np.float64) if normals else np.zeros((0, 3))

    def resolve(idx: int, count: int) -> int:
        # OBJ indices are 1-based; negative indices count from the end.
        return idx - 1 if idx > 0 else count + idx

    nf = len(face_pos_idx)
    verts_out = np.zeros((nf, 3, 3), np.float64)
    nrms_out = np.zeros((nf, 3, 3), np.float64)
    transform = np.asarray(np.eye(4) if transform is None else transform,
                           np.float64)
    for f in range(nf):
        p = pos[[resolve(i, len(pos)) for i in face_pos_idx[f]]]
        p_h = np.concatenate([p, np.ones((3, 1))], axis=1) @ transform.T
        verts_out[f] = p_h[:, :3]
        ni = face_nrm_idx[f]
        if ni is not None and not recompute_normals and len(nrm):
            n = nrm[[resolve(i, len(nrm)) for i in ni]]
            lens = np.linalg.norm(n, axis=1, keepdims=True)
            lens[lens == 0] = 1.0
            nrms_out[f] = n / lens
        else:
            g = _geometric_normal(verts_out[f, 0], verts_out[f, 1], verts_out[f, 2])
            nrms_out[f] = np.tile(g, (3, 1))
    return verts_out.astype(np.float32), nrms_out.astype(np.float32)


def load_obj(path: str, transform: Optional[np.ndarray] = None,
             recompute_normals: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Load an OBJ file -> (vertices (F,3,3), normals (F,3,3)), world space."""
    from ..utils import native
    if native.available():
        return native.load_obj(path, transform, recompute_normals)
    with open(path, "r") as f:
        return parse_obj_text(f.read(), transform, recompute_normals)
