"""The port's renderer against the JAX package's on a mesh scene (20
triangles, within the megakernel's 64-face limit), at the tolerances and
by the method of tests/test_torch_render.py.
"""
import pytest
import torch

from test_torch_render import check_plain_renderer_matches_jax

torch.set_num_threads(2)


@pytest.mark.parametrize("depth,rng_offset", [(8, 11), (3, 0)])
def test_plain_renderer_matches_jax_on_mesh(depth, rng_offset):
    check_plain_renderer_matches_jax("cornell_mesh_icosahedron.txt", depth,
                                     rng_offset)
