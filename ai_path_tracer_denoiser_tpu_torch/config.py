"""Runtime configuration (counterpart of ai_path_tracer_denoiser_tpu/config.py).

Same three frozen dataclasses and the same field meanings.  Options
whose code path is not ported yet (material sort, first-bounce cache,
motion blur) are kept as fields and the renderer raises
``NotImplementedError`` when one is switched on; the JAX package's mesh
BVH knobs come with the mesh slice (ROADMAP queue A, item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Knobs of the path tracer (reference: pathtrace.cu:20-28, interactions.h:4-6)."""

    # --- optimizations (pathtrace.cu:20-23) ---
    # The plain wavefront stops its bounce loop once every path is dead;
    # the megakernel ends each thread's path as soon as it dies.
    stream_compaction: bool = True
    sort_material: bool = False        # not yet ported (ROADMAP queue B)
    cache_first_bounce: bool = False   # not yet ported (ROADMAP queue B)
    # Gate per-ray triangle loops on a ray/AABB test (pathtrace.cu:23, 258).
    ray_culling: bool = True

    # --- effects (pathtrace.cu:25-28) ---
    antialias: bool = True            # sub-pixel jitter, pathtrace.cu:168-173
    motion_blur: bool = False         # not yet ported (ROADMAP queue B)
    denoise: bool = True              # fill + emit the 10-channel G-buffer
    # --- shading variants (interactions.h:4-6) ---
    mesh_normal_view: bool = False    # debug: replace material color by |normal|
    fresnels: bool = True             # Schlick reflect/refract path (default)
    dielectric: bool = False          # PBRT-style Fresnel dielectric path

    # --- G-buffer layout ---
    # The reference's G-buffer is horizontally flipped relative to the
    # render (pathtrace.cu:86, 297-299). True reproduces that.
    flip_horizontal: bool = True

    # --- execution backend ---
    # "auto": the CUDA megakernel (render/cuda_backend.py) when the scene
    #   and options are eligible and the state lives on the card, the plain
    #   PyTorch wavefront otherwise.  "xla" forces the plain wavefront (the
    #   name is kept from the JAX package, where it meant the XLA
    #   wavefront); "pallas" forces the megakernel and errors if ineligible
    #   (on CPU tensors the megakernel's wrapper runs its plain version).
    backend: str = "auto"
    # Max 1-spp iterations per kernel launch (None = 64).
    iters_per_dispatch: Optional[int] = None
    # The JAX megakernel's compile-time scene specialization.  The CUDA
    # kernel reads the scene from a device buffer at run time, so both
    # values run the same kernel.
    pallas_geometry: str = "baked"

    # --- RNG ---
    # "parity": utilhash-seeded minstd LCG (pathtrace.cu:52-56).
    # "fast": utilhash counter RNG keyed on the same triple.
    rng: str = "parity"

    # --- numerics ---
    # Radiance accumulator dtype; bfloat16 routes through the plain
    # wavefront (the megakernel carries f32 planes).
    accum_dtype: str = "float32"

    def __post_init__(self):
        if self.rng not in ("parity", "fast"):
            raise ValueError(f"rng={self.rng!r}")
        if self.accum_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"accum_dtype={self.accum_dtype!r}")
        if self.backend not in ("auto", "xla", "pallas"):
            raise ValueError(f"backend={self.backend!r}")
        if self.pallas_geometry not in ("baked", "operand"):
            raise ValueError(f"pallas_geometry={self.pallas_geometry!r}")
        # Mirrors the asserts at pathtrace.cu:435-436.
        if self.cache_first_bounce and self.antialias:
            raise ValueError(
                "first-bounce cache is incompatible with antialiasing")
        if self.cache_first_bounce and self.motion_blur:
            raise ValueError(
                "first-bounce cache is incompatible with motion blur")


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    """Training hyper-parameters (reference: train.py:41-49, 77, 86).

    A plain copy for the training slice, which is not ported yet.
    """

    lr: float = 1e-3
    lr_step_epochs: int = 25
    lr_gamma: float = 0.2
    epochs: int = 100
    sequence_length: int = 7
    crop_size: int = 256
    batch_size: int = 1
    checkpoint_every_epochs: int = 3
    w_spatial: float = 0.8
    w_gradient: float = 0.1
    w_temporal: float = 0.1
    frame_ramp: Tuple[float, ...] = (0.011, 0.044, 0.135, 0.325, 0.607, 0.882, 1.0)
    seed: int = 0
    bf16_compute: bool = True
    remat_frames: bool = False


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Denoiser architecture (reference: recurrent_autoencoder_model.py:93-117)."""

    in_channels: int = 10
    out_channels: int = 3
    # Encoder widths 10->32->43->57->76->101 (recurrent_autoencoder_model.py:98-107).
    widths: Tuple[int, ...] = (32, 43, 57, 76, 101)
    leaky_slope: float = 0.1
    # "batch": BatchNorm (folds into the convs at inference).
    # "group": GroupNorm(8) — its eval graph is not ported yet.
    norm: str = "batch"
    bn_eps: float = 1e-5
    bn_momentum: float = 0.1

    def __post_init__(self):
        if self.norm not in ("batch", "group"):
            raise ValueError(f"norm={self.norm!r}")


DEFAULT_RENDER = RenderOptions()
DEFAULT_TRAIN = TrainOptions()
DEFAULT_MODEL = ModelOptions()
