"""The reference's float32 transcendentals, reproduced bit for bit.

The tcp loss model draws a geometric retry count j = floor(log u / log p)
(ops/disseminate.py). A u one ulp either side of p^k flips j, and then a
delivery moves by a whole retransmission timeout, so the port's `log` must
give the reference's bits. It cannot use `torch.log`: XLA's CPU backend
does not call a libm. It inlines the Cephes `logf` polynomial and contracts
its multiply-adds into FMAs, and `jnp.log` differs from `torch.log` by an
ulp on about 1.8% of float32 inputs in [1e-12, 1).

`log_f32` is that polynomial, step for step:

    x  = max(x, smallest normal);  x = m * 2^e with m in [0.5, 1)
    if m < 0.70710677: e -= 1, x = m + m - 1   else: x = m - 1
    x2 = x*x;  x3 = x2*x
    y  = p0*x + p1  (two roundings);  y1 = p3*x + p4;  y2 = p6*x + p7
    y  = y*x + p2;   y1 = y1*x + p5;  y2 = y2*x + p8
    y  = y*x3 + y1;  y  = y*x3 + y2
    y  = y*x3 + e*q1                 (the FMA is over y*x3)
    log = ((x - 0.5*x2) + y) + e*q2

Every multiply-add but the first is one FMA; the first, and the last line,
round each step (a search over the 2^8 ways to contract the eight
multiply-adds found exactly this pattern to match). Each FMA is computed
in float64, where the float32 product is exact, and rounded once to
float32. Every step is a separate elementwise op with IEEE
semantics on the CPU and on CUDA alike, so both devices give the same
bytes. Held against `jnp.log` bit for bit on a few million seeded float32
inputs and the edge values (tests/port/test_torch_loss.py). Zero, negative,
infinite and NaN inputs take the IEEE results jnp.log gives them, and a
subnormal input is read as zero, as XLA's CPU backend reads it.

`exp_f32` is XLA-CPU's inlined float32 `exp` (the Cephes `expf`
reduction), read off the LLVM IR and object code that
`XLA_FLAGS=--xla_dump_to=DIR` writes for a jitted `jnp.exp2` / `jnp.exp`:

    x  = min(max(x, -87.8), 88.8)       (NaN passes through)
    n  = min(max(floor(x*log2(e) + 0.5), -127), 127)
    r  = x - n*C1;  r = r - n*C2        (C1 = 0.693359375, C2 = -2.12194440e-4)
    y  = r*p0 + p1;  y = y*r + p2;  y = y*r + p3;  y = y*r + p4;  y = y*r + 0.5
    y  = y*(r*r) + r;  y = y + 1
    exp = y * 2^n                       (2^n built from its exponent bits)

All nine multiply-adds are FMAs (vfmadd / vfnmadd in the object code, in
the scalar and the vectorized loop alike); `r*r`, `y + 1` and the final
scale round on their own. A result below the smallest normal reads as
zero, as XLA's CPU backend flushes it. `exp2_f32(x)` is
`exp_f32(x * ln 2)`, the product rounded to float32 first: that is what
`jnp.exp2` lowers to, so it is exact only up to 2^12 (2^13 gives
8192.0039). Both are held against `jnp.exp` / `jnp.exp2` bit for bit on
millions of seeded float32 inputs and the edge values
(tests/port/test_torch_backoff_exp.py).

`exp2_int` is 2**j for the integer-valued j the tcp model feeds it (0..7),
where `jnp.exp2` is exact.
"""

from __future__ import annotations

import torch

_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
      1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
      3.3333331174e-1)
_Q1 = -2.12194440e-4
_Q2 = 0.693359375
_SQRTHF = 0.70710677
_MIN_NORMAL_BITS = 0x00800000


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """The float32 constant v on like's device."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """float32 a*b + c with one rounding: the float64 product of two
    float32 values is exact, so only the sum rounds (to float64, then to
    float32)."""
    f64 = torch.float64
    return (a.to(f64) * b.to(f64) + c.to(f64)).to(torch.float32)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of a float32 tensor with XLA-CPU's bits (module doc)."""
    if x.dtype != torch.float32:
        raise TypeError(f"log_f32 takes float32, got {x.dtype}")
    i32 = torch.int32
    min_normal = torch.tensor(_MIN_NORMAL_BITS, dtype=i32,
                              device=x.device).view(torch.float32)
    xc = torch.maximum(x, min_normal)
    bits = xc.view(i32)
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    e = ((bits >> 23) & 0xFF).to(torch.float32)
    e = (e - _f32(127.0, x)) + _f32(1.0, x)
    low = m < _f32(_SQRTHF, x)
    e = torch.where(low, e - _f32(1.0, x), e)
    xm = torch.where(low, (m + m) - _f32(1.0, x), m - _f32(1.0, x))
    x2 = xm * xm
    x3 = x2 * xm
    p = [_f32(v, x) for v in _P]
    y = xm * p[0] + p[1]
    y1 = fma_f32(xm, p[3], p[4])
    y2 = fma_f32(xm, p[6], p[7])
    y = fma_f32(y, xm, p[2])
    y1 = fma_f32(y1, xm, p[5])
    y2 = fma_f32(y2, xm, p[8])
    y = fma_f32(y, x3, y1)
    y = fma_f32(y, x3, y2)
    y = fma_f32(y, x3, e * _f32(_Q1, x))
    out = ((xm - x2 * _f32(0.5, x)) + y) + e * _f32(_Q2, x)
    inf = float("inf")
    # XLA treats subnormal inputs as zero
    out = torch.where(x < min_normal, -inf, out)
    out = torch.where(x < 0.0, float("nan"), out)
    out = torch.where(x == inf, inf, out)
    return torch.where(torch.isnan(x), x, out)


# exp's constants, as XLA's CPU backend emits them (all exact float32)
_LN2 = 0.6931471824645996
_EXP_LO, _EXP_HI = -87.80000305175781, 88.80000305175781
_LOG2E = 1.4426950216293335
_C1, _C2 = 0.693359375, -0.00021219444170128554
_EXP_P = (0.00019875691214110702, 0.001398199936375022, 0.008333452045917511,
          0.04166579619050026, 0.1666666567325592, 0.5)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """e**x of a float32 tensor with XLA-CPU's bits (module doc)."""
    if x.dtype != torch.float32:
        raise TypeError(f"exp_f32 takes float32, got {x.dtype}")
    x = torch.minimum(torch.maximum(x, _f32(_EXP_LO, x)), _f32(_EXP_HI, x))
    n = torch.floor(fma_f32(x, _f32(_LOG2E, x), _f32(0.5, x)))
    n = torch.minimum(torch.maximum(n, _f32(-127.0, x)), _f32(127.0, x))
    r = fma_f32(-n, _f32(_C1, x), x)
    r = fma_f32(-n, _f32(_C2, x), r)
    y = fma_f32(r, _f32(_EXP_P[0], x), _f32(_EXP_P[1], x))
    for c in _EXP_P[2:]:
        y = fma_f32(y, r, _f32(c, x))
    y = fma_f32(y, r * r, r) + _f32(1.0, x)
    scale = ((torch.nan_to_num(n, nan=0.0).to(torch.int32) + 127) << 23)
    out = y * scale.view(torch.float32)
    min_normal = torch.tensor(_MIN_NORMAL_BITS, dtype=torch.int32,
                              device=x.device).view(torch.float32)
    return torch.where(out < min_normal, _f32(0.0, x), out)


def exp2_f32(x: torch.Tensor) -> torch.Tensor:
    """2**x of a float32 tensor with XLA-CPU's bits: exp(x * ln 2)."""
    if x.dtype != torch.float32:
        raise TypeError(f"exp2_f32 takes float32, got {x.dtype}")
    return exp_f32(x * _f32(_LN2, x))


def exp2_int(j: torch.Tensor) -> torch.Tensor:
    """2**j for integer-valued float32 j in 0..7 (exact, as jnp.exp2 is
    there); j outside that range (NaN included) gives some power of two in
    it, since the tcp model selects those lanes away."""
    table = torch.tensor([2.0 ** k for k in range(8)], dtype=torch.float32,
                         device=j.device)
    return table[torch.nan_to_num(j, nan=0.0).clamp(0.0, 7.0).long()]


# -- full float32 sums in XLA's CPU order -----------------------------------
#
# XLA's CPU backend rewrites a reduction over a dimension longer than 32 into
# reduce-windows of 32 per reduced dimension (the input padded with zeros,
# the smaller half of the pad in front), repeated until no dimension exceeds
# 32, then one plain reduce. A window whose loop carries a pad test is
# summed in row-major order; the last reduce of a (k, 2) array is
# vectorized by LLVM (its reassociating adds) in a pattern that depends on
# k, read off the reference's object code for every k <= 32 (_PAIR_LANES).
# `sum_f32` reproduces this bit for bit for 1-D sums and for (N, C) sums
# with C > 32 and N <= 1024 (the sums the adversary and flight-recorder
# observables take); elsewhere it keeps the same order, which XLA may
# reassociate (windows without a pad test are vectorized too). Every step
# is an elementwise add, so CPU and CUDA give the same bytes.
_WINDOW = 32
# the final reduce of a (k, 2) array: lanes over rows (row r in lane
# r % lanes, adding its two columns in order; the lanes then sum in halves,
# leftover rows after them in order); 1 = row-major order, 0 = the two row
# sums added (k = 2)
_PAIR_LANES = {2: 0, 4: 4, 8: 8, **{k: 8 for k in range(16, 20)},
               **{k: 4 for k in range(20, 24)},
               **{k: 8 for k in range(24, 33)}}


def _seq_sum(vals) -> torch.Tensor:
    acc = torch.zeros((), dtype=torch.float32, device=vals[0].device)
    for v in vals:
        acc = acc + v
    return acc


def _final_sum(x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 2 and x.shape[1] == 2:
        k = x.shape[0]
        lanes = _PAIR_LANES.get(k, 1)
        if lanes == 0:
            return (x[0, 0] + x[0, 1]) + (x[1, 0] + x[1, 1])
        if lanes > 1:
            m = (k // lanes) * lanes
            acc = torch.zeros((lanes,), dtype=torch.float32, device=x.device)
            for r0 in range(0, m, lanes):
                acc = acc + x[r0:r0 + lanes, 0]
                acc = acc + x[r0:r0 + lanes, 1]
            while acc.shape[0] > 1:
                h = acc.shape[0] // 2
                acc = acc[:h] + acc[h:]
            tail = [x[r, j] for r in range(m, k) for j in range(2)]
            return _seq_sum([acc[0]] + tail) if tail else acc[0]
    flat = x.reshape(-1)
    return _seq_sum([flat[i] for i in range(flat.shape[0])])


def sum_f32(x: torch.Tensor) -> torch.Tensor:
    """jnp.sum of a float32 array (all axes) under jit on XLA's CPU
    backend, as a 0-d float32 tensor (see the order above)."""
    x = x.to(torch.float32)
    if x.dim() == 0:
        return x
    if x.dim() > 2:
        raise ValueError("sum_f32 takes 1-D or 2-D arrays")
    while any(d > _WINDOW for d in x.shape):
        ws = [min(d, _WINDOW) for d in x.shape]
        pad = []
        for d, w in zip(reversed(x.shape), reversed(ws)):
            tot = (-d) % w
            pad += [tot // 2, tot - tot // 2]
        xp = torch.nn.functional.pad(x, pad)
        out = None
        if x.dim() == 1:
            for o in range(ws[0]):
                sl = xp[o::ws[0]]
                out = sl if out is None else out + sl
        else:
            rows = xp.reshape(xp.shape[0] // ws[0], ws[0], -1)
            for o0 in range(ws[0]):
                row = rows[:, o0].reshape(rows.shape[0],
                                          xp.shape[1] // ws[1], ws[1])
                for o1 in range(ws[1]):
                    sl = row[:, :, o1]
                    out = sl if out is None else out + sl
        # the window's accumulator starts at the init value 0.0 (only the
        # sign of an all-zero window could tell)
        x = out + 0.0
    return _final_sum(x)
