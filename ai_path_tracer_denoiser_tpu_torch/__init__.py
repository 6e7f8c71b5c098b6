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
    conv3x3 + bias + LeakyReLU (+ affine) (JAX: models/conv_kernel.py).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
