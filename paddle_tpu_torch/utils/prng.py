"""The `jax.random` draws the JAX package makes, in torch: threefry2x32-20
keys and the bits, uniforms, normals, Bernoulli masks, Gumbel noise and
categorical samples derived from them, as JAX computes them with
`jax_threefry_partitionable` on (its default).

A key is an integer tensor of shape [..., 2] holding two uint32 words (int64
here: CPU torch has no add or shift for uint32).  Leading key dimensions
batch: `bits(keys [S, 2], (V,))` is [S, V], row s the draw of keys[s], as a
`jax.vmap` over the keys would give.  Every function runs on the device of
its key, with plain elementwise integer ops and no host read, so a CUDA
graph can capture it and the host's key schedule (CPU tensors) and the
card's draws share one code path.

Bit for bit equal to JAX: `PRNGKey`, `split`, `fold_in`, `bits`,
`uniform`, `bernoulli` and `categorical`'s indices where no two scores are
within the float rounding below.  `normal` goes through `torch.erfinv` and
`gumbel` through two `torch.log`s, which differ from XLA's in the last bits
of some values.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_SIGN = 0x80000000

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, (int, np.integer)) \
        else tuple(int(d) for d in shape)


def as_key(key, device=None) -> torch.Tensor:
    """A key (a tensor, a numpy array of uint32 such as a JAX key, or a
    pair of ints) as the int64 [..., 2] tensor these functions take."""
    if isinstance(key, torch.Tensor):
        k = key.to(device=device if device is not None else key.device,
                   dtype=torch.int64)
    else:
        k = torch.as_tensor(np.asarray(key).astype(np.int64),
                            device=device)
    if k.shape[-1:] != (2,):
        raise ValueError(f"a key has shape [..., 2], got {tuple(k.shape)}")
    return k & _M32


def _scalar(v, dtype: torch.dtype, device) -> torch.Tensor:
    """A 0-d tensor of `v` on `device`, made there by a fill (a Python
    number copied from the host would be a transfer, which a CUDA graph
    capture refuses)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.full((), v, dtype=dtype, device=device)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed) with x64 off: [0, seed mod 2**32]; a seed
    outside int64 raises OverflowError, as JAX's conversion does."""
    s = int(seed)
    if not -2 ** 63 <= s < 2 ** 63:
        raise OverflowError("Python int too large to convert to C long")
    return torch.tensor([0, s & _M32], dtype=torch.int64, device=device)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Random123; jax/_src/prng.py
    `_threefry2x32_lowering`) on Python ints or on broadcastable int64
    tensors holding uint32 words -> the two output words, of the same
    kind."""
    if isinstance(x0, int) and isinstance(x1, int):
        ks = (k0, k1, k0 ^ k1 ^ _PARITY)
        x0 = (x0 + k0) & _M32
        x1 = (x1 + k1) & _M32
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = (x0 + x1) & _M32
                x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
            x0 = (x0 + ks[(i + 1) % 3]) & _M32
            x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
        return x0, x1
    a, b = _rounds(*(_i32(torch.as_tensor(w)) for w in (k0, k1, x0, x1)))
    return _u32(a), _u32(b)


def _i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 words held in int64 -> int32 tensors of the same bits (the
    wrap made explicit: values of 2**31 and up become negative)."""
    return ((x & _M32) ^ _SIGN).sub_(_SIGN).to(torch.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 words -> their uint32 values held in int64."""
    return x.to(torch.int64) & _M32


def _rounds(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
            x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20 rounds on broadcastable int32 tensors, in place: adds wrap
    mod 2**32 (two's complement), and a rotation's right shift is masked
    to the bits a logical shift would keep.  Half the bytes and fewer ops
    than int64 words masked after every add."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = torch.broadcast_tensors(x0 + k0, x1 + k1)
    x0, x1 = x0.contiguous(), x1.contiguous()
    t = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1)
            torch.bitwise_left_shift(x1, r, out=t)
            x1.bitwise_right_shift_(32 - r).bitwise_and_((1 << r) - 1) \
                .bitwise_or_(t).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3])
        x1.add_(ks[(i + 2) % 3]).add_(i + 1)
    return x0, x1


# elements a CPU hash works on at once: the rounds' temporaries (4 MiB
# each) stay in the cache and each op still spreads over the cores (a
# whole [64, 8, 32000] draw at once runs at memory speed, 64K-element
# chunks on one or two cores)
_CPU_CHUNK = 1 << 20


def _hash(key: torch.Tensor, shape: tuple
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The hash of every element's flat index of `shape` as the counter
    (high, low) (jax/_src/prng.py `iota_2x32_shape`) under keys [*K, 2]
    -> two int32 words [*K, *shape]."""
    key = as_key(key)
    lead = key.shape[:-1]
    k0 = _i32(key[..., 0]).reshape(lead + (1,))
    k1 = _i32(key[..., 1]).reshape(lead + (1,))
    n = int(np.prod(shape, dtype=np.int64))
    if n < 2 ** 31:
        hi = torch.zeros((), dtype=torch.int32, device=key.device)
        lo = torch.arange(n, dtype=torch.int32, device=key.device)
    else:
        idx = torch.arange(n, dtype=torch.int64, device=key.device)
        hi, lo = _i32(idx >> 32), _i32(idx)
    step = max(_CPU_CHUNK // max(int(np.prod(lead, dtype=np.int64)), 1), 1)
    if key.device.type != "cpu" or n <= step:
        a, b = _rounds(k0, k1, hi, lo)
    else:
        parts = [_rounds(k0, k1, hi if hi.dim() == 0 else hi[i:i + step],
                         lo[i:i + step]) for i in range(0, n, step)]
        a = torch.cat([p[0] for p in parts], dim=-1)
        b = torch.cat([p[1] for p in parts], dim=-1)
    return a.reshape(lead + shape), b.reshape(lead + shape)


def _host_words(key: torch.Tensor, counters: range) -> torch.Tensor:
    """The hash of counters (0, i) under one CPU key, in Python integers:
    the host's key schedule (a split per training step) without ~170 tiny
    tensor ops per call."""
    k0, k1 = (int(w) for w in key.tolist())
    out = [threefry2x32(k0, k1, 0, i) for i in counters]
    return torch.tensor(out, dtype=torch.int64)


def split(key, num: Shape = 2) -> torch.Tensor:
    """jax.random.split(key, num) -> [..., *num, 2]: new key i is the hash
    of the counter (0, i), so split(k, n)[i] does not depend on n."""
    key = as_key(key)
    num = _shape(num)
    if key.dim() == 1 and key.device.type == "cpu" and len(num) == 1 \
            and num[0] <= 64:
        return _host_words(key, range(num[0]))
    a, b = _hash(key, num)
    return torch.stack([_u32(a), _u32(b)], dim=-1)


def fold_in(key, data) -> torch.Tensor:
    """jax.random.fold_in(key, data): the hash of the counter (0, data).
    `data` is a uint32 int or an integer tensor that broadcasts against the
    key's leading dimensions (a device tensor keeps it on the device)."""
    key = as_key(key)
    if isinstance(data, torch.Tensor):
        d = _i32(data.to(device=key.device, dtype=torch.int64))
    else:
        d = int(data)
        if not 0 <= d <= _M32:
            raise OverflowError(f"Python integer {d} out of bounds for "
                                f"uint32")
        if key.dim() == 1 and key.device.type == "cpu":
            return _host_words(key, range(d, d + 1))[0]
        d = _scalar(d - (d >> 31 << 32), torch.int32, key.device)
    a, b = _rounds(_i32(key[..., 0]), _i32(key[..., 1]),
                   torch.zeros_like(d), d)
    return torch.stack([_u32(a), _u32(b)], dim=-1)


def bits(key, shape: Shape = (), device=None) -> torch.Tensor:
    """jax.random.bits(key, shape) (uint32) as int64 [*K, *shape]: the xor
    of the two words hashed from each element's flat index.  Like every
    draw below it runs on `device` (default: the key's)."""
    return _u32(_bits32(as_key(key, device), _shape(shape)))


def _bits32(key, shape: tuple) -> torch.Tensor:
    """`bits` as the int32 words of the same bits."""
    a, b = _hash(key, shape)
    return a ^ b


_FLOAT_LAYOUT = {   # dtype -> (bits drawn, mantissa bits, int view dtype)
    torch.float32: (32, 23, torch.int32),
    torch.float16: (16, 10, torch.int16),
    torch.bfloat16: (8, 7, torch.int16),
}


def _layout(dtype: torch.dtype) -> tuple:
    try:
        return _FLOAT_LAYOUT[dtype]
    except KeyError:
        raise ValueError(f"draws {sorted(map(str, _FLOAT_LAYOUT))}, not "
                         f"{dtype}") from None


def uniform(key, shape: Shape = (), dtype: torch.dtype = torch.float32,
            minval=0.0, maxval=1.0, device=None) -> torch.Tensor:
    """jax.random.uniform: the drawn bits' top mantissa bits under the
    exponent of 1.0, minus 1, scaled to [minval, maxval) with one rounding
    and clamped below at minval (jax/_src/random.py `_uniform`)."""
    rng_bits, nmant, view = _layout(dtype)
    b = _bits32(as_key(key, device), _shape(shape))
    if rng_bits < 32:
        b = b & ((1 << rng_bits) - 1)
    one = int(np.array(1.0, dtype=np.float32).view(np.int32)) \
        if dtype == torch.float32 else \
        int(torch.tensor(1.0, dtype=dtype).view(torch.int16))
    # a logical shift: the arithmetic one's sign bits masked off
    fb = ((b >> (rng_bits - nmant)) & ((1 << nmant) - 1)) | one
    floats = fb.to(view).view(dtype) - _scalar(1.0, dtype, fb.device)
    lo = _scalar(minval, dtype, fb.device)
    if _unit_span(minval, maxval, dtype):
        # hi - lo is 1.0 in dtype ([0, 1), gumbel's [tiny, 1)): the fused
        # product below is floats + lo, one rounding in dtype
        return floats if minval == 0 else torch.maximum(lo, floats + lo)
    hi = _scalar(maxval, dtype, fb.device)
    # floats * (hi - lo) + lo rounded once, as XLA's fused multiply-add
    # rounds it: the float64 product of two float32 values is exact
    scaled = (floats.double() * (hi - lo).double() + lo.double()).to(dtype)
    return torch.maximum(lo, scaled)


def _unit_span(minval, maxval, dtype: torch.dtype) -> bool:
    """Whether maxval - minval, two Python numbers, is 1.0 in dtype."""
    if isinstance(minval, torch.Tensor) or isinstance(maxval, torch.Tensor):
        return False
    return float(torch.tensor(maxval, dtype=dtype)
                 - torch.tensor(minval, dtype=dtype)) == 1.0


def normal(key, shape: Shape = (), dtype: torch.dtype = torch.float32,
           device=None) -> torch.Tensor:
    """jax.random.normal: sqrt(2)·erfinv(u), u uniform on
    [nextafter(-1, 0), 1)."""
    nmant = _layout(dtype)[1]
    u = uniform(key, shape, dtype, -(1.0 - 2.0 ** -(nmant + 1)), 1.0,
                device)
    return torch.erfinv(u) * _scalar(float(np.sqrt(2)), dtype, u.device)


def bernoulli(key, p: float = 0.5, shape: Optional[Shape] = None,
              device=None) -> torch.Tensor:
    """jax.random.bernoulli(key, p, shape) (mode "low"): uniform < p, p
    float32 like JAX's weakly typed Python float."""
    if shape is None:
        shape = tuple(p.shape) if isinstance(p, torch.Tensor) else ()
    u = uniform(key, shape, torch.float32, device=device)
    return u < _scalar(p, torch.float32, u.device)


def gumbel(key, shape: Shape = (), dtype: torch.dtype = torch.float32,
           device=None) -> torch.Tensor:
    """jax.random.gumbel (mode "low"): -log(-log(u)), u uniform on
    [tiny, 1)."""
    u = uniform(key, shape, dtype, torch.finfo(dtype).tiny, 1.0, device)
    return -torch.log(-torch.log(u))


def categorical(key, logits: torch.Tensor, axis: int = -1,
                shape: Optional[Shape] = None) -> torch.Tensor:
    """jax.random.categorical with replacement: argmax over `axis` of
    logits plus Gumbel noise drawn at the shape `shape` prefixes to the
    logits' batch shape, on the logits' device (int64 indices, the first
    maximum on ties)."""
    nd = logits.dim()
    axis = axis % nd
    batch = tuple(d for i, d in enumerate(logits.shape) if i != axis)
    shape = batch if shape is None else _shape(shape)
    if shape[len(shape) - len(batch):] != batch:
        raise ValueError(f"categorical shape {shape} does not end in the "
                         f"logits' batch shape {batch}")
    prefix = shape[:len(shape) - len(batch)]
    logits_shape = list(batch)
    logits_shape.insert(axis, logits.shape[axis])
    noise = gumbel(key, prefix + tuple(logits_shape), logits.dtype,
                   logits.device)
    lead = as_key(key).dim() - 1
    full = noise + logits.reshape((1,) * (lead + len(prefix))
                                  + tuple(logits.shape))
    return torch.argmax(full, dim=lead + len(prefix) + axis)
