"""Ray math: SoA vectors, RNG, intersection, BSDF."""
from .rng import (  # noqa: F401
    utilhash,
    seeded_engine,
    lcg_next,
    lcg_uniform,
    uniform_sequence,
    make_seeded_engine,
)
from .intersect import (  # noqa: F401
    box_intersect,
    sphere_intersect,
    triangle_intersect,
    ray_aabb_intersect,
    intersect_scene,
)
from .bsdf import scatter_ray, cosine_hemisphere_direction, schlick  # noqa: F401
