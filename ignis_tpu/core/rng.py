"""Counter-based per-ray RNG.

Mirrors the *structure* of the reference RNG
(/root/reference/src/artic/core/random.art: FNV-hashed seed from
(sample, iter, frame, x, y, user_seed) feeding a small counter PRNG), giving
deterministic, order-independent streams per pixel sample. The actual
generator here is PCG-RXS-M-XS-32: one uint32 of state per ray, a handful of
integer ops per draw — far cheaper than threefry and adequate for Monte
Carlo rendering.

All functions are elementwise over arbitrarily-shaped uint32 state arrays, so
the whole wavefront advances its RNG in one fused elementwise pass.
"""
from __future__ import annotations

import jax.numpy as jnp

U32 = jnp.uint32

# Python ints, NOT jnp scalars: module-level device arrays become
# jit-captured constants. Weak-typed int literals fold into the uint32 ops
# for free.
_FNV_OFFSET = 0x811C9DC5
_FNV_PRIME = 0x01000193

_PCG_MULT = 747796405
_PCG_INC = 2891336453


def fnv_hash(h, x):
    """One FNV-1a round folding uint32 `x` into hash `h` byte by byte."""
    h = jnp.asarray(h, U32)
    x = jnp.asarray(x, U32)
    for shift in (0, 8, 16, 24):
        h = (h ^ ((x >> shift) & jnp.uint32(0xFF))) * _FNV_PRIME
    return h


def seed(sample, iteration, frame, x, y, user_seed):
    """Build the per-ray stream seed; mirrors create_random_seed structure."""
    h = _FNV_OFFSET
    for v in (user_seed, sample, iteration, frame, x, y):
        h = fnv_hash(h, v)
    return h


def _pcg_step(state):
    # jnp.uint32() at trace time (literals > int32 max overflow weak typing)
    return state * jnp.uint32(_PCG_MULT) + jnp.uint32(_PCG_INC)


def _pcg_output(state):
    word = ((state >> ((state >> jnp.uint32(28)) + jnp.uint32(4))) ^ state) \
        * jnp.uint32(277803737)
    return (word >> jnp.uint32(22)) ^ word


def next_u32(state):
    """Advance state; returns (new_state, uint32 draw)."""
    state = _pcg_step(state)
    return state, _pcg_output(state)


def next_f32(state):
    """Advance state; returns (new_state, float32 in [0, 1))."""
    state, bits = next_u32(state)
    # 24 mantissa-ish bits -> [0,1): exact float32 representable
    return state, (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(1.0 / 16777216.0)


def next_f32_n(state, n: int):
    """Draw n floats; returns (state, [f0, f1, ...])."""
    outs = []
    for _ in range(n):
        state, f = next_f32(state)
        outs.append(f)
    return state, outs
