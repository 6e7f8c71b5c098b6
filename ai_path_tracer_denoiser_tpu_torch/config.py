"""Runtime configuration (counterpart of ai_path_tracer_denoiser_tpu/config.py).

Same three frozen dataclasses and the same field meanings.
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
    # Stable-sort the path state by hit material after each shade
    # (pathtrace.cu:508-510).  A pure permutation: the image does not change.
    sort_material: bool = False
    # Reuse iteration 1's depth-0 intersection in later iterations
    # (pathtrace.cu:466-476); needs antialias and motion_blur off.
    cache_first_bounce: bool = False
    # Gate per-ray triangle loops on a ray/AABB test (pathtrace.cu:23, 258).
    ray_culling: bool = True
    # Send a mesh that carries a cluster hierarchy (ops/bvh.py, built for
    # meshes over 65 faces) through it instead of the O(faces) scan.
    mesh_bvh: bool = True
    # Carry the secondary bounces' rays sorted by direction octant (and
    # origin cell, below) so that neighbouring rays descend the same nodes.
    # A pure permutation: the image does not change.  Ignored by the binned
    # pipeline, which packs rays itself.
    mesh_octant_sort: bool = True
    # Rays per tile of the tile-gated traversal ("v2") on secondary bounces:
    # its descent-gating granule and CUDA block size, which "v2" checks is
    # a multiple of 128 up to 1024 when it runs.  The other intersections
    # gate per ray, per 128-ray subtile or not at all and ignore it, so any
    # value is accepted here, as in the JAX package.
    mesh_kernel_lanes: int = 1024
    # With mesh_octant_sort, also sort by an origin-cell Morton major key
    # over mesh_sort_cells^3 cells of the batch's own origin bounds
    # (negative: octant-major; 0 = octant only).
    mesh_sort_cells: int = 8
    # BVH intersection: "auto" = "binned" for meshes of 64 bins (of 256
    # faces) or more, else "v2p"; "v2p"/"v2s" = per-ray traversal
    # (render/mesh_kernel_v2p.py, one kernel serves both); "v2" = index-order
    # traversal gated per tile of mesh_kernel_lanes rays
    # (render/mesh_kernel.py); "v3" = front-to-back traversal per 128-ray
    # subtile (render/mesh_kernel_v3.py); "binned" = the pair pipeline
    # (render/mesh_binned.py).  All give the dense scan's result.
    mesh_kernel_impl: str = "auto"

    # --- effects (pathtrace.cu:25-28) ---
    antialias: bool = True            # sub-pixel jitter, pathtrace.cu:168-173
    motion_blur: bool = False         # move geoms by their velocity, pathtrace.cu:441
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
        if self.mesh_kernel_impl not in ("auto", "v2", "v2p", "v2s", "v3",
                                         "binned"):
            raise ValueError(f"mesh_kernel_impl={self.mesh_kernel_impl!r}")
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
    """Training hyper-parameters (reference: train.py:41-49, 77, 86)."""

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
    # "group": GroupNorm(8), stateless (effective groups = gcd(8, C));
    #    such models run the eval graph (models/autoencoder.py:apply_frame).
    norm: str = "batch"
    bn_eps: float = 1e-5
    bn_momentum: float = 0.1

    def __post_init__(self):
        if self.norm not in ("batch", "group"):
            raise ValueError(f"norm={self.norm!r}")

    @staticmethod
    def tpu_friendly() -> "ModelOptions":
        """The JAX package's alternative channel plan, widths rounded up to
        multiples of 8 (kept so that its checkpoints and ``--tpu-friendly``
        carry over)."""
        return ModelOptions(widths=(32, 48, 64, 80, 104))


@dataclasses.dataclass(frozen=True)
class KPCNOptions:
    """The kernel-predicting denoiser (Bako et al. 2017, models/kpcn.py):
    ``layers`` 5x5 convolutions with SAME zero padding, the first
    ``layers`` - 1 ``width`` channels wide with a ReLU, the last
    ``kernel``**2 wide, softmax-weighting the ``kernel`` x ``kernel`` window
    of noisy radiance around each pixel.  All three are the paper's; the
    5x5 taps and the 30 input channels are fixed (``models.kpcn.TAPS``,
    ``models.kpcn.IN_CHANNELS``)."""

    layers: int = 9
    width: int = 100
    kernel: int = 21

    def __post_init__(self):
        if self.kernel % 2 == 0 or not 1 <= self.kernel <= 21:
            raise ValueError(f"kernel={self.kernel}: odd, 1..21")
        if self.layers < 2:
            raise ValueError(f"layers={self.layers}: at least 2")


DEFAULT_RENDER = RenderOptions()
DEFAULT_TRAIN = TrainOptions()
DEFAULT_MODEL = ModelOptions()
