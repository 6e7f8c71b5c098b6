"""Counter-style RNG reproducing the reference's noise pipeline
(counterpart of ops/rng.py).

The reference seeds a minstd LCG per (iter, pixelIndex, depth) with a
bit-mix hash (pathtrace.cu:52-56, intersections.h:12-20) and draws a few
uniforms per bounce — a counter RNG, so no ``torch.Generator`` is involved.
PyTorch has no full uint32 arithmetic, so every value lives in int64 and
is masked back to 32 bits with ``& 0xFFFFFFFF`` after each wrapping step;
the results are bit-identical to the JAX package's uint32 code (tested).
"""
from __future__ import annotations

import torch

from ..utils.timers import host_read

_MASK = 0xFFFFFFFF
# minstd_rand constants
_LCG_A = 48271
_LCG_M = 2147483647          # 2^31 - 1
_LCG_Q = _LCG_M // _LCG_A    # 44488
_LCG_R = _LCG_M % _LCG_A     # 3399
# u = float32(state) * float32(1/M): a float32 multiply, not a division
# (ops/rng.py:110 of the JAX package).
_INV_M = torch.tensor(1.0 / _LCG_M, dtype=torch.float32)
_TWO_M32 = torch.tensor(2.0 ** -32, dtype=torch.float32)


def _u32(a, like=None) -> torch.Tensor:
    """Any integer input -> int64 tensor holding uint32 values, on ``like``'s
    device if it is a tensor (a copy from the host that waits for the
    device's queue: counted as ``sync.rng_scalar``)."""
    if not isinstance(a, torch.Tensor):
        if isinstance(like, torch.Tensor):
            with host_read("rng_scalar"):
                return torch.tensor(int(a) & _MASK, dtype=torch.int64, device=like.device)
        return torch.tensor(int(a) & _MASK, dtype=torch.int64)
    return a.to(torch.int64) & _MASK


def utilhash(a) -> torch.Tensor:
    """Exact port of utilhash (intersections.h:12-20), uint32 wrapping."""
    a = _u32(a)
    a = ((a + 0x7ED55D16) + (a << 12)) & _MASK
    a = ((a ^ 0xC761C23C) ^ (a >> 19)) & _MASK
    a = ((a + 0x165667B1) + (a << 5)) & _MASK
    a = ((a + 0xD3A2646C) ^ (a << 9)) & _MASK
    a = ((a + 0xFD7046C5) + (a << 3)) & _MASK
    a = ((a ^ 0xB55A4F09) ^ (a >> 16)) & _MASK
    return a


def mod_mersenne31(h) -> torch.Tensor:
    """h % (2^31-1) for uint32 h (int64 makes the plain remainder exact)."""
    return _u32(h) % _LCG_M


def make_seeded_engine(iteration, index, depth) -> torch.Tensor:
    """State init matching makeSeededRandomEngine (pathtrace.cu:52-56).

    h = utilhash((1<<31) | (depth<<22) | iter) ^ utilhash(index); the
    state is h % m, or 1 if that is 0.  Returns int64 states in [1, m).
    """
    index = _u32(index)
    iteration = _u32(iteration, index)
    depth = _u32(depth, index)
    h = utilhash((1 << 31) | ((depth << 22) & _MASK) | iteration) ^ utilhash(index)
    state = mod_mersenne31(h)
    return torch.where(state == 0, torch.ones_like(state), state)


# The JAX package's older name for the same function.
seeded_engine = make_seeded_engine


def lcg_next_schrage(state: torch.Tensor) -> torch.Tensor:
    """One minstd step by Schrage's method, whose intermediates all fit in
    int32 (the JAX package's reference form of :func:`lcg_next`): equal to
    it bit for bit over the whole state space."""
    state = state.to(torch.int64)
    hi = state // _LCG_Q
    lo = state - hi * _LCG_Q
    t = _LCG_A * lo - _LCG_R * hi
    return torch.where(t > 0, t, t + _LCG_M)


def lcg_next(state: torch.Tensor) -> torch.Tensor:
    """One minstd step x <- 48271*x mod (2^31-1); exact in int64."""
    return (state.to(torch.int64) * _LCG_A) % _LCG_M


def lcg_uniform(state: torch.Tensor):
    """Draw one uniform float in [0, 1) and return (value, new_state)."""
    new_state = lcg_next(state)
    with host_read("rng_scale"):        # a copy from the host, as above
        inv_m = _INV_M.to(new_state.device)
    u = new_state.to(torch.float32) * inv_m
    return u, new_state


def uniform_sequence(state: torch.Tensor, n: int):
    """Draw n successive uniforms in [0,1); returns (values (n, ...), state)."""
    outs = []
    for _ in range(n):
        u, state = lcg_uniform(state)
        outs.append(u)
    return torch.stack(outs, dim=0), state


def fast_uniforms(iteration, index, depth, n: int) -> torch.Tensor:
    """n uniforms in [0,1) per element, keyed like the parity RNG.

    The JAX package's "fast" mode: utilhash of the (iter, index, depth)
    triple, then one utilhash per draw of ``mixed + 0x9E3779B9 * (i+1)``.
    """
    index = _u32(index)
    iteration = _u32(iteration, index)
    depth = _u32(depth, index)
    mixed = utilhash(((depth << 22) & _MASK) ^ iteration) ^ utilhash(index)
    outs = []
    scale = _TWO_M32.to(index.device)
    for i in range(n):
        bits = utilhash((mixed + ((0x9E3779B9 * (i + 1)) & _MASK)) & _MASK)
        outs.append(bits.to(torch.float32) * scale)
    return torch.stack(outs, dim=0)


def draw_uniforms(iteration, index, depth, n: int, mode: str = "parity"):
    """Unified entry: (n, *index.shape) float32 uniforms in [0,1)."""
    if mode == "parity":
        state = make_seeded_engine(iteration, index, depth)
        vals, _ = uniform_sequence(state, n)
        return vals
    return fast_uniforms(iteration, index, depth, n)
