"""``jax.random``'s threefry2x32 key stream, drawn with PyTorch.

``jax.random`` is counter-based: every number it draws is a threefry2x32
hash of a key and a counter, so the bits are the same on every backend.
This module computes the same hashes with integer tensor operations
(int64 holding uint32 values, masked to 32 bits), on any device, so that
the port can draw the very numbers that the JAX package draws from a key.
It follows JAX's partitionable mode (``jax_threefry_partitionable``, the
default since JAX 0.5.0): ``split`` is the "foldlike" split
(``jax/_src/prng.py::_threefry_split_foldlike``) and the bits of a shape
hash the flattened index of each element.

A key is two uint32 words. On the host it is a tuple of two Python ints
(:func:`prng_key`, :func:`split` and :func:`fold_in` take and give tuples);
on a device an int64 tensor ``[..., 2]``, whose leading dimensions are a
batch of keys (every function takes one key or such a batch, as
``jax.vmap`` would). The samplers (:func:`random_bits`, :func:`uniform`,
:func:`normal`, :func:`randint`, :func:`bernoulli`) take a device key and
give ``key.shape[:-1] + shape``.

Bits, splits, folds, uniforms, Bernoulli draws and integers are bit-equal
to ``jax.random`` on the CPU and on the card (integer work and exactly
rounded float32 arithmetic). ``normal`` takes JAX's route (a uniform on
(-1, 1), then ``sqrt(2) * erfinv``) with XLA's CPU ``erfinv`` (Giles),
``log1p`` and ``log`` (Cephes) and their fused multiply-adds emulated:
within 2 ulp of XLA's (a few draws in 10^5 differ).

flax's dropout keys (:func:`flax_rng`): flax folds a module's path and its
``make_rng`` counter into the key given to ``apply`` through the SHA-1 of
the path (``flax/core/scope.py::_fold_in_static``, without separators: the
default of ``flax_fix_rng_separator``).

:class:`KeyStream` is the JAX supervised train loop's key chain.
"""

from __future__ import annotations

import hashlib
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

HostKey = Tuple[int, int]
Key = Union[HostKey, torch.Tensor]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of the count words ``(x0, x1)`` under the key
    words ``(k0, k1)`` (``jax/_src/prng.py::_threefry2x32_lowering``): 20
    rounds, a key injection every 4. Python ints or int64 tensors holding
    uint32 values, broadcast together; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = (x0 + ks[0]) & MASK, (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int) -> HostKey:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32 bits."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"a threefry seed lies in [0, 2**64), got {seed}")
    return (seed >> 32) & MASK, seed & MASK


def to_device(key: Key, device) -> torch.Tensor:
    """A key (or a list of host keys) as an int64 tensor on ``device``,
    copied without waiting for the device."""
    if isinstance(key, torch.Tensor):
        return key.to(device)
    host = torch.tensor(key, dtype=torch.int64)
    device = torch.device(device)
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def _words(key: torch.Tensor, ndim: int):
    """The key words of a ``[..., 2]`` tensor, shaped to broadcast against
    counts of ``ndim`` trailing dimensions."""
    lead = key.shape[:-1]
    view = lead + (1,) * ndim
    return key[..., 0].reshape(view), key[..., 1].reshape(view)


def _hash(key: torch.Tensor, counts: torch.Tensor):
    """Both output words of the hash of the low count words ``counts``
    (high words 0: fewer than 2**32 counts) under every key of the batch."""
    k0, k1 = _words(key, counts.dim())
    return threefry2x32(k0, k1, torch.zeros_like(counts), counts)


def _iota(shape: Sequence[int], device) -> torch.Tensor:
    n = int(np.prod(shape, dtype=np.int64))
    if n >= 2 ** 32:
        raise NotImplementedError("2**32 counts or more")
    return torch.arange(n, dtype=torch.int64, device=device).reshape(tuple(shape))


def split(key: Key, num: Union[int, Sequence[int]] = 2):
    """``jax.random.split``: ``num`` new keys (an int or a shape). A host
    key gives a list of host keys (``num`` an int); a device key ``[...,
    2]`` gives ``[..., *num, 2]``."""
    shape = (num,) if isinstance(num, int) else tuple(num)
    if not isinstance(key, torch.Tensor):
        if len(shape) != 1:
            raise ValueError("a host key splits into a flat list")
        return [threefry2x32(key[0], key[1], 0, i) for i in range(shape[0])]
    b0, b1 = _hash(key, _iota(shape, key.device))
    return torch.stack([b0, b1], dim=-1)


def fold_in(key: Key, data):
    """``jax.random.fold_in``: the key with the uint32 ``data`` folded in
    (an int, or for a device key an int64 tensor broadcast against its
    batch)."""
    if not isinstance(key, torch.Tensor):
        return threefry2x32(key[0], key[1], 0, int(data) & MASK)
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & MASK
    else:
        data = torch.full_like(key[..., 0], int(data) & MASK)
    b0, b1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([b0, b1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.bits`` of 32 bits: ``[..., *shape]`` int64 holding
    uint32 values (each element hashes its flattened index)."""
    b0, b1 = _hash(key, _iota(shape, key.device))
    return b0 ^ b1


def _f32(value) -> float:
    """``value`` rounded to float32, as a Python float (a scalar operand
    that float32 tensor arithmetic takes exactly, with no copy to the
    device)."""
    return float(np.float32(value))


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from the top 23 bits, as ``jax.random.uniform``
    makes them: the mantissa of a float in [1, 2), minus 1."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform_from_bits(bits: torch.Tensor, minval=0.0, maxval=1.0) -> torch.Tensor:
    """The float32 uniforms on [minval, maxval) that ``jax.random.uniform``
    makes of ``bits``. XLA fuses ``u * span + minval`` into one
    multiply-add, rounded once: here in float64, where the product is exact
    and so is the sum while minval's exponent lies within a few of the
    span's, as in every draw of the port."""
    lo, span = _f32(minval), float(np.float32(maxval) - np.float32(minval))
    return (_unit(bits).double() * span + lo).float().clamp_min(lo)


def uniform(key: torch.Tensor, shape: Sequence[int] = (), minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on [minval, maxval)."""
    return uniform_from_bits(random_bits(key, shape), minval, maxval)


#: XLA's float32 erfinv coefficients (Giles), for w < 5 and w >= 5.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


#: XLA's float32 log1p below |x| = sqrt(2) - 1: Cephes' rational
#: approximation, numerator and denominator from the highest degree.
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (the product is exact in float64)."""
    return (torch.as_tensor(a).double() * b + c).float()


def _horner(coeffs, x: torch.Tensor) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x.double(), _f32(c))
    return p


#: Cephes' float32 log polynomial, from the highest degree.
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
          1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
          3.3333331174E-1)


def log(x: torch.Tensor) -> torch.Tensor:
    """float32 log of positive finite ``x`` as XLA's CPU backend computes
    it (Cephes): the mantissa m in [sqrt(1/2), sqrt(2)), ``m - 1 - (m -
    1)²/2 + (m - 1)³ P(m - 1)`` plus the exponent times ln 2 in two parts."""
    bits = x.clamp_min(_f32(1.17549435e-38)).view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)  # in [1/2, 1)
    low = m < _f32(0.707106781186547524)
    e = e - low.float()
    m = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    x2 = m * m
    x3 = x2 * m
    y = _fma(m, _f32(_LOG_P[0]), _f32(_LOG_P[1]))
    y1 = _fma(m, _f32(_LOG_P[3]), _f32(_LOG_P[4]))
    y2 = _fma(m, _f32(_LOG_P[6]), _f32(_LOG_P[7]))
    y = _fma(y, m.double(), _f32(_LOG_P[2]))
    y1 = _fma(y1, m.double(), _f32(_LOG_P[5]))
    y2 = _fma(y2, m.double(), _f32(_LOG_P[8]))
    y = _fma(y, x3.double(), y1.double())
    y = _fma(y, x3.double(), y2.double()) * x3
    y = y + _f32(-2.12194440e-4) * e
    m = (m - 0.5 * x2) + y
    return m + _f32(0.693359375) * e


def log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 log1p as XLA's CPU backend computes it: ``x - x²/2 + x³
    P(x)/Q(x)`` below sqrt(2) - 1, else :func:`log` of ``1 + x``."""
    x2 = x * x
    small = _fma(-0.5, x2.double(), (x * x2) * (_horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x)))
    return torch.where(x.abs() < _f32(0.41421356237309504880), x + small, log(x + 1.0))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv as XLA computes it: ``w = -log1p(-x²)``, a degree-8
    polynomial in ``w - 2.5`` (w < 5) or ``sqrt(w) - 3``, times ``x``;
    ±inf at ±1."""
    w = -log1p(x * -x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    coeff = [torch.where(small, _f32(a), _f32(b)) for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE)]
    p, w = coeff[0], w.double()
    for c in coeff[1:]:  # XLA's multiply-adds, each rounded once
        p = _fma(p, w, c.double())
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_NORMAL_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))


def normal(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return _f32(np.sqrt(2)) * erfinv(u)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` of int32 on [minval, maxval): two words of
    bits a value, folded into the span by JAX's multiply-and-remainder
    (uint32 arithmetic). Returns int64."""
    keys = split(key)
    return randint_from_bits(random_bits(keys[..., 0, :], shape),
                             random_bits(keys[..., 1, :], shape), minval, maxval)


def randint_from_bits(higher: torch.Tensor, lower: torch.Tensor, minval: int,
                      maxval: int) -> torch.Tensor:
    """The integers on [minval, maxval) that ``jax.random.randint`` makes of
    its two words of bits (int64)."""
    span = int(maxval) - int(minval)
    if not 0 < span < 2 ** 31:
        raise ValueError(f"randint takes a span in (0, 2**31), got [{minval}, {maxval})")
    multiplier = ((2 ** 16 % span) ** 2) % span
    offset = (((higher % span) * multiplier) & MASK) + lower % span
    return int(minval) + (offset & MASK) % span


def bernoulli(key: torch.Tensor, p: float, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.bernoulli`` with a float32 probability ``p``."""
    return uniform(key, shape) < _f32(p)


def _fold_static(path: Sequence[Union[str, int]]) -> int:
    """flax's SHA-1 word of a path's names and counters."""
    m = hashlib.sha1()
    for x in path:
        m.update(x.encode("utf-8") if isinstance(x, str)
                 else int(x).to_bytes((int(x).bit_length() + 7) // 8, byteorder="big"))
    return int.from_bytes(m.digest()[:4], byteorder="big")


def flax_rng(key: Key, path: Sequence[str], counter: int = 1) -> Key:
    """The key that ``make_rng`` gives the module at ``path`` on its
    ``counter``-th call, from the key passed to ``apply``."""
    return fold_in(key, _fold_static(tuple(path) + (counter,)))


class KeyStream:
    """The JAX supervised train loop's step keys, from ``PRNGKey(seed)``.

    ``steps_per_dispatch`` 1 (``jolineedle_tpu/train/supervised.py:346``):
    each iteration takes ``key, step_key = split(key)``. N > 1 (``:365-366``):
    each dispatch of N iterations takes ``key, sub = split(key)`` and its
    iterations take ``split(sub, N)`` in turn (a tail dispatch the first of
    them). The stream's state is (seed, steps_per_dispatch) and the step, so
    it resumes anywhere; it walks the chain on the host."""

    def __init__(self, seed: int, steps_per_dispatch: int = 1):
        if steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch {steps_per_dispatch} < 1")
        self.seed, self.steps_per_dispatch = int(seed), int(steps_per_dispatch)
        self._rewind()

    def _rewind(self):
        self._dispatch, self._key, self._keys = 0, prng_key(self.seed), None

    def step_key(self, step: int) -> HostKey:
        """The key of the 0-based train iteration ``step``."""
        n = self.steps_per_dispatch
        dispatch, offset = divmod(int(step), n)
        if dispatch < self._dispatch - 1:
            self._rewind()
        while self._dispatch <= dispatch:
            self._key, sub = split(self._key)
            self._keys = [sub] if n == 1 else split(sub, n)
            self._dispatch += 1
        return self._keys[offset]

    def state_dict(self) -> dict:
        return {"seed": self.seed, "steps_per_dispatch": self.steps_per_dispatch}
