"""JAX's default random numbers on the host: threefry2x32 in numpy.

A request's initial noise must be the same on both sides for one seed, so
the port draws it exactly as ``jax.random`` does with JAX's defaults
(``jax_default_prng_impl="threefry2x32"``, 64-bit mode off) and in its
**partitionable** mode (``jax_threefry_partitionable=True``, the default
since JAX 0.5): ``split`` and ``random_bits`` hash a 64-bit iota over the
output shape, its high words as the first counter and its low words as the
second, and ``random_bits`` at 32 bits is the xor of the two hashed words.

- ``PRNGKey(seed)``: key ``(0, seed mod 2**32)`` (64-bit mode off: the
  seed is cut to 32 bits, its high word is 0).
- ``split(key, num)``: ``[num, 2]`` keys, bit for bit.
- ``fold_in(key, data)``: the key hashed with the counter pair ``(0,
  data)`` (``data`` cut to 32 bits), bit for bit.
- ``random_bits(key, shape)``: uint32 words, bit for bit.
- ``uniform(key, shape, lo, hi)``: the top 23 bits of each word OR-ed
  into the exponent of 1.0, minus 1.0, scaled to ``[lo, hi)``, then
  ``max(lo, ·)``: bit for bit.
- ``chain_normals(key, num, shape)``: ``num`` normals along a carried
  key chain (each step splits the carry), the LCM sampler's re-noise.
- ``normal(key, shape)``: ``sqrt(2) · erfinv(u)``, ``u`` uniform on
  ``[nextafter(-1, 0), 1)``, with ``erfinv`` as XLA's float32 ``ErfInv32``
  computes it (Giles' single-precision polynomial, w < 5 and w >= 5
  branches, each Horner step one fused multiply-add, ``log1p`` rounded
  once from float64). XLA's own ``log`` rounds otherwise for some inputs,
  so about one word in a hundred differs from ``jax.random.normal`` by one
  to three float32 ulp (2.4e-7 at most; ``tests/test_torch_prng.py`` holds
  the limit).

Everything runs on the host in uint32/float32 numpy and returns numpy
arrays; the caller copies the result to its device.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)

# XLA's ErfInv32 coefficients (Giles, "Approximating the erfinv function")
_ERFINV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                        0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                        1.50140941], np.float32)
_ERFINV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                        0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                        2.83297682], np.float32)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x0, x1)``
    under ``key`` (two uint32 words)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _iota_2x32(shape: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    idx = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64).reshape(shape)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 (jax.random's name)
    """The raw key of ``jax.random.PRNGKey(seed)``: uint32 ``[2]``."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``'s raw keys: uint32 ``[num, 2]``."""
    b0, b1 = threefry2x32(key, *_iota_2x32((num,)))
    return np.stack([b0, b1], axis=-1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``'s raw key: uint32 ``[2]``."""
    b0, b1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.concatenate([b0, b1])


def random_bits(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.bits(key, shape)`` (uint32 words)."""
    b0, b1 = threefry2x32(key, *_iota_2x32(tuple(shape)))
    return b0 ^ b1


def uniform(key: np.ndarray, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.float32(1.0).view(np.uint32)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, floats * (hi - lo) + lo)


def erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``ErfInv32``: Giles' polynomial, ±inf at ±1."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = (-np.log1p(-(x * x).astype(np.float64))).astype(np.float32)
        lt = w < np.float32(5.0)
        w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
        p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).astype(np.float32)
        w64 = w.astype(np.float64)
        for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
            # one fused multiply-add, as XLA's CPU and GPU code generators emit
            p = (np.where(lt, c_lt, c_ge).astype(np.float64) + p * w64).astype(np.float32)
        out = p * x
        return np.where(np.abs(x) == np.float32(1.0), x * np.float32(np.inf), out)


def normal(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erfinv(u)).astype(np.float32)


def chain_normals(key: np.ndarray, num: int, shape: tuple[int, ...]) -> np.ndarray:
    """``num`` draws along a carried key chain, as a ``lax.scan`` body that
    splits its carry does: ``key, sub = split(key)``, then ``normal(sub,
    shape)``, ``num`` times → ``[num, *shape]`` float32."""
    out = np.empty((num, *shape), np.float32)
    for i in range(num):
        key, sub = split(key)
        out[i] = normal(sub, shape)
    return out
