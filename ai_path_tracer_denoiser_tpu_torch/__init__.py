"""ai_path_tracer_denoiser_tpu_torch — the PyTorch/CUDA port of the path
tracer + recurrent denoiser, for NVIDIA Hopper (H100).

The JAX package ``ai_path_tracer_denoiser_tpu`` is the reference; this
package mirrors its module tree and function names so each counterpart is
easy to find, and imports nothing of it.  Plain tensor code is PyTorch;
each TPU Pallas kernel on the ported path is a hand-written CUDA C++
kernel under ``csrc/`` (built with nvcc for sm_90a at first use):

  * ``render/cuda_backend.py`` + ``csrc/render_megakernel.cu`` — the
    whole-render megakernel (JAX: render/pallas_backend.py),
  * ``models/conv_kernel.py`` + ``csrc/conv3x3_act.cu`` — the fused
    conv3x3 + bias + LeakyReLU (+ affine), also the forward pass and input
    gradient of every conv in training (``models/layers.py``), and
    ``csrc/conv3x3_rows.cu`` — the row-band variant of the same conv
    (JAX: models/conv_kernel.py),
  * ``render/mesh_kernel_v2p.py``, ``render/mesh_binned.py`` +
    ``csrc/mesh_*.cu`` — the mesh BVH traversal, bin subscription and pair
    intersection (JAX: render/mesh_kernel_v2p.py, render/mesh_binned.py),
  * ``render/mesh_kernel.py``, ``render/mesh_kernel_v3.py`` +
    ``csrc/mesh_bvh_v2.cu``, ``csrc/mesh_bvh_v3.cu`` — the tile-gated and
    the front-to-back traversal (JAX modules of the same names),
  * ``tools/mm_feasibility.py`` + ``csrc/mm_visit_*.cu`` — the visit-cost
    probe's scalar and tensor-core visit (JAX: tools/exp_mm_feasibility.py).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"

from . import config as config  # noqa: E402,F401
