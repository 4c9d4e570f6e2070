"""Pure-u32 IEEE f16 codec.

No 16-bit dtypes anywhere on device: u16 converts deadlock the XLA CPU
runtime in this environment, kernels prefer 32-bit words, and packing two
halves per u32 word halves sort-payload counts (ops/binning.py). Subnormals
flush to zero; overflow clamps to f16 max; round-half-up.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def f32_to_f16_bits(x: jnp.ndarray) -> jnp.ndarray:
    """f32 -> IEEE f16 bit pattern held in u32 (low 16 bits)."""
    b = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    sign = (b >> jnp.uint32(16)) & jnp.uint32(0x8000)
    exp = ((b >> jnp.uint32(23)) & jnp.uint32(0xFF)).astype(jnp.int32)
    mant = b & jnp.uint32(0x7FFFFF)
    # Round mantissa to 10 bits (half-up), propagating carry into the exponent.
    mant_r = (mant + jnp.uint32(0x1000)) >> jnp.uint32(13)
    carry = (mant_r >> jnp.uint32(10)).astype(jnp.int32)
    mant_h = jnp.where(carry > 0, jnp.uint32(0), mant_r) & jnp.uint32(0x3FF)
    exp_h = exp - 112 + carry
    half = sign | (jnp.clip(exp_h, 0, 30).astype(jnp.uint32) << jnp.uint32(10)) | mant_h
    half = jnp.where(exp_h <= 0, sign, half)          # underflow -> signed 0
    half = jnp.where(exp_h > 30, sign | jnp.uint32(0x7BFF), half)  # clamp to f16 max
    return half


def f16_bits_to_f32(h: jnp.ndarray) -> jnp.ndarray:
    """IEEE f16 bit pattern in u32 -> f32 (subnormals treated as zero)."""
    sign = (h & jnp.uint32(0x8000)) << jnp.uint32(16)
    exp = (h >> jnp.uint32(10)) & jnp.uint32(0x1F)
    mant = h & jnp.uint32(0x3FF)
    f32bits = sign | ((exp + jnp.uint32(112)) << jnp.uint32(23)) | (mant << jnp.uint32(13))
    f32bits = jnp.where(exp == 0, sign, f32bits)
    return jax.lax.bitcast_convert_type(f32bits, jnp.float32)


def pack2xf16(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Two f32 -> one u32 (a in low 16 bits, b in high)."""
    return f32_to_f16_bits(a) | (f32_to_f16_bits(b) << jnp.uint32(16))


def unpack2xf16(w: jnp.ndarray) -> tuple:
    """One u32 -> two f32 (low, high f16 halves)."""
    lo = f16_bits_to_f32(w & jnp.uint32(0xFFFF))
    hi = f16_bits_to_f32(w >> jnp.uint32(16))
    return lo, hi
