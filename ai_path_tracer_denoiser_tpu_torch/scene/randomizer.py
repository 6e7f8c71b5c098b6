"""Scene randomizer for training-data generation (counterpart of
scene/randomizer.py; numpy only, so the same seed gives the same text).

Equivalent of Inference/scenes/create_scene.py:10-66: takes a template scene
text and produces randomized variants by mutating material properties (for
material blocks >= ``material_start``), object transforms (for object blocks
>= ``object_start``), and the camera EYE line, with the same distributions:

  REFL ~ U(0,1);  REFR = 0.97 - REFL;  REFRIOR ~ U(0,2)
  EMITTANCE ~ choice([0..4], p=[.8,.05,.05,.05,.05])
  RGB / SPECRGB ~ U(0,1)^3
  TRANS ~ (U(-4,4), U(0,4), U(-4,4));  SCALE ~ U(1,4)^3;  ROTAT ~ U(-45,45)^3
  EYE ~ (U(-2,2), U(2,8), U(8,12))
"""
from __future__ import annotations

import numpy as np


def randomize_scene_text(template: str, rng: np.random.Generator,
                         material_start: int = 5, object_start: int = 7) -> str:
    out_lines = []
    material = 0
    obj = 0
    refl = 0.0
    for x in template.split("\n"):
        stripped = x.strip()
        if material >= material_start and not stripped.startswith("//"):
            if stripped.startswith("REFL"):
                refl = rng.uniform(0, 1)
                x = f"REFL\t{refl}"
            elif stripped.startswith("REFRIOR"):
                x = f"REFRIOR\t{rng.uniform(0, 2)}"
            elif stripped.startswith("REFR"):
                x = f"REFR\t{0.97 - refl}"
            elif stripped.startswith("EMITTANCE"):
                e = rng.choice(np.arange(0, 5), p=[0.8, 0.05, 0.05, 0.05, 0.05])
                x = f"EMITTANCE\t{e}"
            elif stripped.startswith("SPECRGB"):
                x = "SPECRGB\t{} {} {}".format(*rng.uniform(0, 1, 3))
            elif stripped.startswith("RGB"):
                x = "RGB\t{} {} {}".format(*rng.uniform(0, 1, 3))
        if obj >= object_start and not stripped.startswith("//"):
            if stripped.startswith("TRANS"):
                x = "TRANS\t{} {} {}".format(rng.uniform(-4, 4), rng.uniform(0, 4),
                                             rng.uniform(-4, 4))
            elif stripped.startswith("SCALE"):
                x = "SCALE\t{} {} {}".format(*rng.uniform(1, 4, 3))
            elif stripped.startswith("ROTAT"):
                x = "ROTAT\t{} {} {}".format(*rng.uniform(-45, 45, 3))
        if stripped.startswith("EYE"):
            x = "EYE\t{} {} {}".format(rng.uniform(-2, 2), rng.uniform(2, 8),
                                       rng.uniform(8, 12))
        out_lines.append(x)
        if stripped.startswith("MATERIAL"):
            material += 1
        if stripped.startswith("OBJECT"):
            obj += 1
    return "\n".join(out_lines)


def generate_variants(template: str, n: int, seed: int = 0):
    """Yield n randomized scene texts."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield randomize_scene_text(template, rng)
