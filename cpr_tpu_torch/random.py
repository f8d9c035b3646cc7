"""Counter-based threefry2x32 that matches `jax.random` bit for bit
(kernel K1: plain twin and wrapper).

The stream is the one jax draws with `jax_threefry_partitionable=True`
(the default from jax 0.5 on) and 64-bit mode off, the setting the
reference runs with:

    PRNGKey(s)       = (0, s mod 2**32)
    split(k, n)[i]   = threefry2x32(k, (0, i))
    fold_in(k, d)    = threefry2x32(k, (0, d))
    bits(k, shape)   = x0 ^ x1 of threefry2x32(k, (0, j)), j the flat index
    bits64(k, shape) = (x0 << 32) | x1 of the same block (64-bit draws)
    uniform(k)       = bitcast_f32((bits >> 9) | 0x3f800000) - 1
    uniform(k, f64)  = bitcast_f64((bits64 >> 12) | 0x3ff0...0) - 1
    uniform(k, lo, hi) = max(lo, uniform(k) * (hi - lo) + lo)
    exponential(k)   = -log1p(-uniform(k))
    gumbel(k)        = -log(-log(uniform(k, tiny, 1)))   (mode "low")
    categorical(k, logits) = argmax(gumbel(k, noise shape) + logits)
    permutation(k, n) = rounds of a stable sort of arange(n) by bits

The 64-bit draws are what the JAX package draws under 64-bit mode
(`jax.experimental.enable_x64`, the netsim's float64 clocks): uniform and
exponential with `dtype=torch.float64`. `PRNGKey(seed, x64=True)` is the
64-bit mode's key, (seed >> 32, seed mod 2**32) of the int64 seed.

A key is a tensor `[..., 2]` of 32-bit words, stored as int32 bit
patterns because torch's uint32 has few operations; a leading batch of
keys acts as `jax.vmap` over them. `to_numpy_words`/`from_numpy_words`
cross to numpy's uint32.

On a CUDA tensor every function launches the K1 kernel
(`csrc/random.cu`); on a CPU tensor it runs the plain version below,
which does its arithmetic in int64 masked to 32 bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cpr_tpu_torch import _device

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA

# K1 output modes (csrc/random.cu)
MODE_KEYS, MODE_BITS, MODE_UNIFORM, MODE_EXPONENTIAL = 0, 1, 2, 3
MODE_UNIFORM64, MODE_EXPONENTIAL64 = 4, 5
FLOAT64_MODES = (MODE_UNIFORM64, MODE_EXPONENTIAL64)


# -- plain version ------------------------------------------------------------

def words(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values in int64."""
    return t.to(torch.int64) & M32


def from_words(t: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 bit patterns."""
    return t.to(torch.int32)


def _rotl(x, r):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """20-round threefry2x32 on broadcastable int64 tensors holding
    uint32 values; returns the two output words the same way."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _counters(key, n, offset):
    return (torch.arange(n, dtype=torch.int64, device=key.device)
            + offset) & M32


def uniform_of_bits(b: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> jax.random.uniform's float32 on [0, 1)."""
    return ((b >> 9) & 0x7FFFFF | 0x3F800000).view(torch.float32) - 1.0


def exponential_of_bits(b: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> jax.random.exponential's float32."""
    return -torch.log1p(-uniform_of_bits(b))


def threefry_words(key: torch.Tensor, counters: torch.Tensor):
    """threefry2x32(key, (0, counter)) for keys `[..., 2]` and int64
    counters broadcastable to `key.shape[:-1]`: the two output words as
    uint32 values in int64. Lets a plain version draw from several keys
    in one pass (the words of key k and counter j are those of
    `threefry_plain(k, 1, j)`)."""
    kw = words(key)
    counters = counters & M32
    return threefry2x32(kw[..., 0], kw[..., 1], torch.zeros_like(counters),
                        counters)


def gumbel_of_bits(b: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> jax.random.gumbel's float32 (mode "low")."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.clamp(uniform_of_bits(b) * (1.0 - tiny) + tiny, min=tiny)
    return -torch.log(-torch.log(u))


def uniform64_of_words(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """The two words of a block (uint32 values in int64) -> jax.random.
    uniform's float64 on [0, 1): the top 52 bits of (x0 << 32) | x1 as
    the mantissa, which is exactly mantissa * 2**-52."""
    mant = (x0 << 20) | (x1 >> 12)
    return mant.to(torch.float64) * 2.0 ** -52


def threefry_plain(key: torch.Tensor, n: int, offset: int = 0,
                   mode: int = MODE_KEYS) -> torch.Tensor:
    """Plain twin of the K1 kernel: for each key in `key[..., 2]` and
    j < n, threefry2x32(key, (0, offset + j)); `mode` picks what is
    returned: the pair as a key `[..., n, 2]`, or `[..., n]` bits (int32
    patterns), uniform or exponential float32 draws, or uniform or
    exponential float64 draws of the 64-bit bits."""
    kw = words(key)
    k0, k1 = kw[..., 0:1], kw[..., 1:2]
    x0, x1 = threefry2x32(k0, k1, torch.zeros_like(k0),
                          _counters(key, n, offset))
    if mode == MODE_KEYS:
        return from_words(torch.stack((x0, x1), dim=-1))
    if mode == MODE_UNIFORM64:
        return uniform64_of_words(x0, x1)
    if mode == MODE_EXPONENTIAL64:
        return -torch.log1p(-uniform64_of_words(x0, x1))
    b = from_words(x0 ^ x1)
    if mode == MODE_BITS:
        return b
    if mode == MODE_UNIFORM:
        return uniform_of_bits(b)
    if mode == MODE_EXPONENTIAL:
        return exponential_of_bits(b)
    raise ValueError(f"unknown threefry mode {mode}")


# -- dispatch ------------------------------------------------------------------

def _threefry(key, n, offset, mode):
    _device.check_supported(key, "threefry")
    if key.dtype != torch.int32 or key.shape[-1:] != (2,):
        raise ValueError(
            f"a key is an int32 tensor [..., 2], got {key.dtype} "
            f"{tuple(key.shape)}")
    if not key.is_cuda:
        return threefry_plain(key, n, offset, mode)
    from cpr_tpu_torch import kernels
    batch = key.shape[:-1]
    flat = key.reshape(-1, 2).contiguous()
    if flat.data_ptr() % 8:  # the kernel reads each key as one uint2
        flat = flat.clone()
    out = kernels.threefry(flat, n, offset, mode)
    return out.reshape(*batch, *out.shape[1:])


# -- public jax.random surface -------------------------------------------------

def PRNGKey(seed: int, device=None, x64: bool = False) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` with 64-bit mode off: (0, seed mod 2**32);
    with `x64`, the 64-bit mode's (seed >> 32, seed mod 2**32) of the seed
    as an int64 (a negative seed in two's complement)."""
    dev = _device.resolve(device)
    s = int(seed) & 0xFFFFFFFFFFFFFFFF if x64 else int(seed) & M32
    return from_words(torch.tensor([s >> 32, s & M32],
                                   dtype=torch.int64)).to(dev)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split`: key `[..., 2]` -> `[..., num, 2]`."""
    return _threefry(key, int(num), 0, MODE_KEYS)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in` with a host integer `data`."""
    return _threefry(key, 1, int(data) & M32, MODE_KEYS)[..., 0, :]


def _draw(key, shape, mode):
    shape = tuple(shape)
    n = math.prod(shape)
    out = _threefry(key, n, 0, mode)
    return out.reshape(tuple(key.shape[:-1]) + shape)


def bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """`jax.random.bits` (uint32) as int32 bit patterns."""
    return _draw(key, shape, MODE_BITS)


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """`jax.random.uniform`, float32 (or float64 from 64-bit bits): on
    [0, 1) by default, else `max(minval, u * (maxval - minval) + minval)`
    with both bounds and every step rounded to `dtype`, as jax computes
    it."""
    u = _draw(key, shape, _float_mode(MODE_UNIFORM, dtype))
    if minval == 0.0 and maxval == 1.0:
        return u
    lo = torch.tensor(minval, dtype=dtype, device=u.device)
    hi = torch.tensor(maxval, dtype=dtype, device=u.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


def _float_mode(mode: int, dtype) -> int:
    if dtype == torch.float32:
        return mode
    if dtype == torch.float64:
        return {MODE_UNIFORM: MODE_UNIFORM64,
                MODE_EXPONENTIAL: MODE_EXPONENTIAL64}[mode]
    raise ValueError(f"draws are float32 or float64, not {dtype}")


def gumbel(key: torch.Tensor, shape=()) -> torch.Tensor:
    """`jax.random.gumbel` in its default mode "low", float32:
    -log(-log(uniform(minval=tiny, maxval=1)))."""
    tiny = float(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor, axis: int = -1,
                shape=None) -> torch.Tensor:
    """`jax.random.categorical` with replacement (float32 logits): the
    argmax, first index among equals, of gumbel noise plus the logits.
    The noise plane has `shape` followed by the category axis where
    `shape` is given (jax's layout: sample i of category j is flat
    element i * n + j when `logits` is 1-d), else the shape of `logits`.
    Returns int64 indices."""
    if shape is None:
        noise = gumbel(key, tuple(logits.shape))
        return torch.argmax(noise + logits, dim=axis)
    if logits.dim() != 1:
        raise NotImplementedError(
            "categorical(shape=) is ported for 1-d logits only")
    shape = tuple(shape)
    noise = gumbel(key, (*shape, logits.shape[0]))
    return torch.argmax(noise + logits, dim=-1)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.permutation(key, n)` for an int `n`: jax 0.9.0's
    `_shuffle` (jax/_src/random.py:697-728), rounds of a stable sort of
    `arange(n)` keyed by fresh 32-bit bits, `ceil(3 ln n / ln(2**32 - 1))`
    rounds; each round splits the key and draws the bits from the second
    half. The sort is `torch.sort(stable=True)` on the bits as unsigned
    values; the bits are K1's on a CUDA key. Returns int64 indices."""
    n = int(n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(M32)))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        pair = split(key)
        key, sub = pair[0], pair[1]
        sort_keys = bits(sub, (n,)).to(torch.int64) & M32
        order = torch.sort(sort_keys, stable=True).indices
        x = x[order]
    return x


def exponential(key: torch.Tensor, shape=(),
                dtype=torch.float32) -> torch.Tensor:
    """`jax.random.exponential`, float32 or float64: -log1p(-uniform)."""
    return _draw(key, shape, _float_mode(MODE_EXPONENTIAL, dtype))


# -- numpy crossing ------------------------------------------------------------

def to_numpy_words(key: torch.Tensor) -> np.ndarray:
    """Key words as numpy uint32 (jax's key data layout)."""
    return key.detach().cpu().numpy().view(np.uint32)


def from_numpy_words(arr, device=None) -> torch.Tensor:
    """numpy uint32 key words -> an int32 key tensor on `device`."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32)).view(np.int32)
    return torch.from_numpy(a.copy()).to(_device.resolve(device))
