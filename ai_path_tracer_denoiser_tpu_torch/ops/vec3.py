"""Structure-of-arrays 3-vector math over tensors (counterpart of ops/vec3.py).

A vector field is three same-shaped f32 tensors, so every transform, dot,
cross and normalization is a plain elementwise tensor op — the same
formulation (and the same operation order) as the JAX package and as the
CUDA megakernel's scalar code, which keeps the three within rounding of
each other.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Vec3(NamedTuple):
    """Three same-shaped tensors acting as one vector field."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # -- arithmetic (componentwise; scalars broadcast) --
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    # Write ``vec * tensor`` (Vec3 on the left); __rmul__ serves python
    # scalars only.
    __rmul__ = __mul__

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # -- geometry --
    def dot(self, o: "Vec3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(self.y * o.z - self.z * o.y,
                    self.z * o.x - self.x * o.z,
                    self.x * o.y - self.y * o.x)

    def norm(self) -> torch.Tensor:
        return torch.sqrt(self.dot(self))

    def normalized(self) -> "Vec3":
        inv = torch.rsqrt(self.dot(self))
        return Vec3(self.x * inv, self.y * inv, self.z * inv)

    def normalized_safe(self) -> "Vec3":
        n2 = self.dot(self)
        pos = n2 > 0
        inv = torch.where(pos, torch.rsqrt(torch.where(pos, n2, 1.0)), 1.0)
        return Vec3(self.x * inv, self.y * inv, self.z * inv)

    def abs(self) -> "Vec3":
        return Vec3(self.x.abs(), self.y.abs(), self.z.abs())

    # -- conversions --
    @staticmethod
    def full_like(like: torch.Tensor, value: float) -> "Vec3":
        f = torch.full_like(like, value)
        return Vec3(f, f, f)

    def stack(self) -> torch.Tensor:
        """Vec3 -> (..., 3) tensor."""
        return torch.stack([self.x, self.y, self.z], dim=-1)


def where(cond: torch.Tensor, a: Vec3, b: Vec3) -> Vec3:
    """Componentwise select; ``cond`` has the planes' shape."""
    return Vec3(torch.where(cond, a.x, b.x),
                torch.where(cond, a.y, b.y),
                torch.where(cond, a.z, b.z))


def xform_point(m, p: Vec3) -> Vec3:
    """Apply a (4,4) homogeneous transform (``m[i][j]`` python floats)."""
    return Vec3(m[0][0] * p.x + m[0][1] * p.y + m[0][2] * p.z + m[0][3],
                m[1][0] * p.x + m[1][1] * p.y + m[1][2] * p.z + m[1][3],
                m[2][0] * p.x + m[2][1] * p.y + m[2][2] * p.z + m[2][3])


def xform_dir(m, d: Vec3) -> Vec3:
    """Rotation/scale part only (w=0)."""
    return Vec3(m[0][0] * d.x + m[0][1] * d.y + m[0][2] * d.z,
                m[1][0] * d.x + m[1][1] * d.y + m[1][2] * d.z,
                m[2][0] * d.x + m[2][1] * d.y + m[2][2] * d.z)


def reflect(i: Vec3, n: Vec3) -> Vec3:
    """glm::reflect: I - 2*dot(N,I)*N."""
    return i - n * (2.0 * n.dot(i))
