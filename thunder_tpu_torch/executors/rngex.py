"""Keyed random draws: threefry-2x32 as JAX computes it, and its CUDA kernel.

The counterpart of the JAX package's keyed RNG (``thunder_tpu/executors/
jaxex.py:89-98``: ``jax.random.uniform``/``normal`` of ``fold_in(key,
salt)``). A draw is a pure function of (key, salt, element index), so a
recompute (remat, a backward that rebuilds a mask) gives the same bits, a
staged replay draws afresh from a fresh key that is an ordinary copied input,
and staged and unstaged runs agree. No ``torch.Generator`` is involved.

The bits are JAX's (jax 0.9, ``jax_threefry_partitionable=True``, its
default): ``jax/_src/prng.py`` ``threefry_seed`` (a key is the seed's hi and
lo words), ``_threefry2x32_lowering`` (20 rounds, 5 key injections),
``threefry_fold_in`` (``threefry2x32(key, (0, data))``) and
``_threefry_random_bits_partitionable`` (the counters of element i are the hi
and lo words of its flat row-major index; the bits are ``out0 ^ out1``,
truncated to 8 or 16 bits for narrower draws). ``jax/_src/random.py``
``_uniform`` turns bits into floats: the top ``nmant`` bits of the draw's
``rng_bits`` (8 for bf16, whose ``nmant`` 7 is under 8; 16 for f16; 32 for
f32) become the mantissa of a float in [1, 2), minus 1, times (max − min),
plus min, each rounded in the dtype, then the max with min. ``_normal_real``
is sqrt(2)·erfinv(uniform(nextafter(−1, 0), 1)); erfinv is libm's here and
XLA's polynomial there, so normal draws agree to a few ulps, uniform ones bit
for bit.

A key is a (2,) int64 tensor holding the two uint32 words (torch's uint32 has
only barebones kernels). :func:`draw` is the counted wrapper: on a CPU key it
runs :func:`draw_plain` (torch int64 arithmetic masked to 32 bits), on a CUDA
key it launches ``csrc/rng.cu`` or raises.
"""

from __future__ import annotations

import math

import torch

from thunder_tpu_torch.executors import _build

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# (bits of the float, mantissa bits, bits drawn) per dtype, as jax's _uniform.
_FLOAT_BITS = {torch.float32: (32, 23, 32), torch.float16: (16, 10, 16), torch.bfloat16: (16, 7, 8)}
_UINT_VIEW = {32: torch.int32, 16: torch.int16}
_ONE_BITS = {torch.float32: 0x3F800000, torch.float16: 0x3C00, torch.bfloat16: 0x3F80}


def prng_key_words(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)``'s two words with 64-bit seeds, as the JAX
    package draws (its runtime enables ``jax_enable_x64``,
    ``thunder_tpu/api.py:1458``): the seed's hi and lo words, two's
    complement (a negative seed's hi word is 0xffffffff)."""
    seed = int(seed)
    return (seed >> 32) & M32, seed & M32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of counters (x0, x1) under key (k0, k1): int64 tensors
    (or ints) holding uint32 words; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` on the key's device."""
    k0, k1 = threefry2x32(key[0], key[1], 0, int(data) & M32)
    return torch.stack([k0, k1])


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """The 32 random bits of each of n elements (int64), partitionable mode."""
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[0], key[1], idx >> 32, idx & M32)
    return b0 ^ b1


def _uniform_from_bits(bits: torch.Tensor, dtype: torch.dtype, minval: float, maxval: float) -> torch.Tensor:
    """floats·(max − min) + min, rounded as XLA's CPU backend rounds it (jax
    0.9): f32 as one fused multiply-add (the f64 product of two f32 values is
    exact), f16 in f32 and then to f16, bf16 after each operation."""
    nbits, nmant, rng_bits = _FLOAT_BITS[dtype]
    bits = bits & ((1 << rng_bits) - 1)
    mant = (bits >> (rng_bits - nmant)) | _ONE_BITS[dtype]
    # The word's signed twin holds the same bits (the sign bit is 0 here).
    floats = mant.to(_UINT_VIEW[nbits]).view(dtype) - 1
    # 0-d CPU tensors: operands of a CUDA op without a copy to the device.
    lo = torch.tensor(minval, dtype=dtype)
    span = torch.tensor(maxval, dtype=dtype) - lo
    if dtype == torch.float32:
        scaled = (floats.double() * span.double() + lo.double()).float()
    elif dtype == torch.float16:
        scaled = (floats.float() * span.float() + lo.float()).half()
    else:
        scaled = floats * span + lo
    return torch.maximum(lo, scaled)


def normal_range(dtype: torch.dtype) -> tuple[float, float]:
    """The uniform range a normal draw starts from: (nextafter(−1, 0), 1)."""
    return float(torch.nextafter(torch.tensor(-1.0, dtype=dtype), torch.tensor(0.0, dtype=dtype))), 1.0


def draw_plain(key: torch.Tensor, salt, shape: tuple, dtype: torch.dtype, minval: float = 0.0,
               maxval: float = 1.0, normal: bool = False) -> torch.Tensor:
    """The draw of :func:`draw` in torch arithmetic on the key's device."""
    n = math.prod(shape)
    if normal:
        minval, maxval = normal_range(dtype)
    bits = random_bits(key if salt is None else fold_in(key, salt), n)
    out = _uniform_from_bits(bits, dtype, minval, maxval)
    if normal:
        out = torch.erfinv(out) * torch.tensor(math.sqrt(2), dtype=dtype)
    return out.reshape(shape)


@_build.counted
def draw(key: torch.Tensor, salt, shape: tuple, dtype: torch.dtype, minval: float = 0.0,
         maxval: float = 1.0, normal: bool = False) -> torch.Tensor:
    """Uniform draws in [minval, maxval), or normal draws (``normal=True``),
    of ``shape`` and ``dtype`` (f32, bf16, f16), from ``fold_in(key, salt)``
    (from ``key`` itself when ``salt`` is None): ``jax.random.uniform``/
    ``normal`` of that key. The key is read on the device, never on the
    host."""
    _build.refuse_transformed("rng_draw", key)
    shape = tuple(int(s) for s in shape)
    if dtype not in _FLOAT_BITS:
        raise ValueError(f"rng: draws are f32, bf16 or f16, got {dtype}")
    if tuple(key.shape) != (2,) or key.dtype != torch.int64:
        raise ValueError(f"rng: the key is a (2,) int64 tensor of two uint32 words, got {tuple(key.shape)} {key.dtype}")
    if key.device.type == "cpu":
        return draw_plain(key, salt, shape, dtype, minval, maxval, normal)
    if not key.is_cuda:
        raise ValueError(f"rng: the key must be on a CUDA device or the CPU, got {key.device}")
    out = torch.empty(shape, dtype=dtype, device=key.device)
    if out.numel() == 0:
        return out
    if normal:
        minval, maxval = normal_range(dtype)
    # lo, span and sqrt(2) as values of the dtype, rounded here as the plain
    # version rounds them, and passed exactly as floats.
    lo = torch.tensor(minval, dtype=dtype)
    span = float(torch.tensor(maxval, dtype=dtype) - lo)
    sqrt2 = float(torch.tensor(math.sqrt(2), dtype=dtype))
    key = key.contiguous()
    with torch.cuda.device(key.device):
        status = _build.lib().thunder_rng_draw(
            key.data_ptr(), int(salt is not None), (salt or 0) & M32, out.data_ptr(), out.numel(),
            _build.dtype_code(out), int(normal), float(lo), span, sqrt2, _build.sm_count(key.device.index or 0), _build.stream_of(key),
        )
    _build.check(status, "rng_draw")
    draw.launches += 1
    return out


def key_on(words: tuple[int, int], device: torch.device) -> torch.Tensor:
    """A key tensor holding ``words`` on ``device``. On a card each word is
    filled in by a kernel, with no copy from host memory, so this may run
    inside a CUDA-graph capture, where the words become constants of the
    graph: only keys that are constant by design (``UNIFORM_PHILOX``'s)
    are made so."""
    out = torch.empty(2, dtype=torch.int64, device=device)
    out[0].fill_(words[0])
    out[1].fill_(words[1])
    return out


def host_key(words: tuple[int, int], device: torch.device) -> torch.Tensor:
    """A key tensor copied from the host: a fresh key for each call, made
    outside any capture (a capture refuses a host-to-device copy)."""
    return torch.tensor(words, dtype=torch.int64).to(device)
