"""Parser for the reference's scene text format (counterpart of scene/parser.py).

Grammar (scene.cpp:21-40): a file is a sequence of blocks introduced by
``MATERIAL <id>``, ``OBJECT <id>``, ``CAMERA`` or ``MESH <id>`` header
lines; each block is key/value lines terminated by a blank line.  ``//``
comment lines are tolerated; CRLF endings are handled.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..utils.device import resolve_device
from .camera import derive_camera
from .obj_loader import load_obj
from .structs import (CUBE, SPHERE, Scene, build_transformation_matrix,
                      empty_mesh, make_geoms, make_materials, make_mesh)


def _vec3(tok: List[str]) -> tuple:
    return (float(tok[1]), float(tok[2]), float(tok[3]))


class _Lines:
    def __init__(self, text: str):
        # safeGetline equivalence: normalize CRLF/CR (utilities.cpp:62-92).
        self.lines = text.replace("\r\n", "\n").replace("\r", "\n").split("\n")
        self.i = 0

    def next(self) -> Optional[str]:
        if self.i >= len(self.lines):
            return None
        line = self.lines[self.i]
        self.i += 1
        return line

    def block(self):
        """Token lists of the lines up to the next blank line."""
        while True:
            nxt = self.next()
            if nxt is None or not nxt.strip():
                return
            yield nxt.split()


def _trs(rec, t):
    key = {"TRANS": "translation", "ROTAT": "rotation", "SCALE": "scale",
           "VEL": "vel"}.get(t[0])
    if key is not None:
        rec[key] = _vec3(t)


def parse_scene_text(text: str, base_dir: str = ".",
                     face_pad_multiple: int = 128, device=None) -> Scene:
    """Parse scene text into a ``Scene`` on ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    lines = _Lines(text)
    materials, geoms, mesh_records = [], [], []
    camera = None
    iterations, trace_depth, image_name = 5000, 8, "render"
    mat_keys = {"SPECEX": "specular_exponent", "REFL": "has_reflective",
                "REFR": "has_refractive", "REFRIOR": "index_of_refraction",
                "EMITTANCE": "emittance"}

    while True:
        line = lines.next()
        if line is None:
            break
        line = line.strip()
        if not line or line.startswith("//"):
            continue
        head = line.split()[0]

        if head == "MATERIAL":
            rec = {}
            # Exactly 7 property lines (scene.cpp:171).
            for _ in range(7):
                t = (lines.next() or "").split()
                if not t:
                    continue
                if t[0] == "RGB":
                    rec["color"] = _vec3(t)
                elif t[0] == "SPECRGB":
                    rec["specular_color"] = _vec3(t)
                elif t[0] in mat_keys:
                    rec[mat_keys[t[0]]] = float(t[1])
            materials.append(rec)

        elif head == "OBJECT":
            shape = (lines.next() or "").strip()
            mat_line = (lines.next() or "").split()
            rec = {"type": SPHERE if shape == "sphere" else CUBE,
                   "material_id": int(mat_line[1]),
                   "translation": (0.0, 0.0, 0.0), "rotation": (0.0, 0.0, 0.0),
                   "scale": (1.0, 1.0, 1.0), "vel": (0.0, 0.0, 0.0)}
            for t in lines.block():
                _trs(rec, t)
            geoms.append(rec)

        elif head == "CAMERA":
            res, fovy = (800, 800), 45.0
            eye, look_at, up = (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)
            # 5 static lines (scene.cpp:109) then EYE/LOOKAT/UP until blank.
            for _ in range(5):
                t = (lines.next() or "").split()
                if not t:
                    continue
                if t[0] == "RES":
                    res = (int(t[1]), int(t[2]))
                elif t[0] == "FOVY":
                    fovy = float(t[1])
                elif t[0] == "ITERATIONS":
                    iterations = int(t[1])
                elif t[0] == "DEPTH":
                    trace_depth = int(t[1])
                elif t[0] == "FILE":
                    image_name = t[1]
            for t in lines.block():
                if t[0] == "EYE":
                    eye = _vec3(t)
                elif t[0] == "LOOKAT":
                    look_at = _vec3(t)
                elif t[0] == "UP":
                    up = _vec3(t)
            camera = derive_camera(res, fovy, eye, look_at, up)

        elif head == "MESH":
            rec = {"path": None, "material_id": 0,
                   "translation": (0.0, 0.0, 0.0), "rotation": (0.0, 0.0, 0.0),
                   "scale": (1.0, 1.0, 1.0), "vel": (0.0, 0.0, 0.0)}
            t = (lines.next() or "").split()
            if t and t[0] == "PATH":
                rec["path"] = t[1]
            t = (lines.next() or "").split()
            if t and t[0].lower() == "material":
                rec["material_id"] = int(t[1])
            for t in lines.block():
                _trs(rec, t)
            mesh_records.append(rec)

    if camera is None:
        raise ValueError("scene file has no CAMERA block")

    if mesh_records:
        # One mesh in the reference (scene.cpp:208); several MESH blocks
        # merge into one triangle soup, as in the JAX package.
        all_v, all_n, all_m = [], [], []
        for rec in mesh_records:
            transform = build_transformation_matrix(
                rec["translation"], rec["rotation"], rec["scale"])
            obj_path = rec["path"]
            if not os.path.isabs(obj_path):
                obj_path = os.path.join(base_dir, obj_path)
            v, n = load_obj(obj_path, transform)
            all_v.append(v)
            all_n.append(n)
            all_m.append(np.full((v.shape[0],), rec["material_id"], np.int32))
        mesh = make_mesh(np.concatenate(all_v), np.concatenate(all_n),
                         np.concatenate(all_m), face_pad_multiple)
    else:
        mesh = empty_mesh(face_pad_multiple)

    scene = Scene(geoms=make_geoms(geoms), materials=make_materials(materials),
                  mesh=mesh, camera=camera, iterations=iterations,
                  trace_depth=trace_depth, image_name=image_name)
    return scene.to(device)


def load_scene(path: str, face_pad_multiple: int = 128, device=None) -> Scene:
    """Load a scene file onto ``device`` (default ``cuda``)."""
    with open(path, "r") as f:
        text = f.read()
    return parse_scene_text(text, base_dir=os.path.dirname(os.path.abspath(path)),
                            face_pad_multiple=face_pad_multiple, device=device)
