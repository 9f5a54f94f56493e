"""Matmul FFT — split-complex FFT as matrix multiplications.

An FFT backend for runtimes without complex dtypes or the XLA FFT op, and
the CPU complex path (see ``ops.fft._use_matmul_complex``).  It expresses
1D FFTs as dense matmuls on *split-complex* data (a trailing component dim
of size 2 holding [re, im]) using the classic four-step Cooley-Tukey
factorization:

    N = A * B, input viewed as v[b, a] = x[a + A*b]:
      1. y[a, k2] = sum_b v[b, a] * W_B^{b k2}        (B-point DFTs, matmul)
      2. z[a, k2] = y[a, k2] * W_N^{a k2}             (twiddle, elementwise)
      3. X[k1*B + k2] = sum_a z[a, k2] * W_A^{a k1}   (A-point DFTs, matmul)

Each complex matmul is 4 real matmuls in float32 with HIGHEST precision
(3 with the Gauss trick).  For N <= DIRECT_THRESHOLD or prime N the full
dense DFT matrix is used.  Arithmetic cost is O(N * (A + B)) per point vs
O(N log N) for a true FFT.

**In-place axis contraction**: every DFT stage contracts the transform
axis *where it lies* via an einsum whose output keeps the surrounding dims
in order — XLA lowers each one to a canonical (batched) dot with no
materialized transpose.

This replaces nothing in the reference (cuFFT is a library call there,
benchmark/benchmark.cu:294-412); on GPUs the main path calls cuFFT through
``jnp.fft`` instead (``ops.fft``, ``split_complex=False``).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import os
from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

# Use a single dense DFT matmul at or below this size (four-step above).
# Env-overridable.
DIRECT_THRESHOLD = None  # resolved lazily

_LETTERS = "abcdefghij"


def _direct_threshold() -> int:
    if DIRECT_THRESHOLD is not None:  # test/monkeypatch override
        return DIRECT_THRESHOLD
    env = os.environ.get("CUDECOMP_TPU_FFT_DIRECT_THRESHOLD")
    if env:
        return int(env)
    return 64


def _auto_threshold() -> int:
    """Axis-length threshold for the ``auto`` precision policy: HIGH at or
    below it, HIGHEST above."""
    return int(os.environ.get("CUDECOMP_TPU_FFT_AUTO_N", "768"))


def _precision(n: int = None):
    """Matmul precision for the DFT contractions.

    float32 data: HIGHEST = full f32; HIGH and DEFAULT trade accuracy for
    speed in a backend-specific way (what each computes on the GPU is
    recorded in PERF.md).  The error grows with the contraction K and the
    number of chained stages.  float64 always uses HIGHEST.

    Env ``CUDECOMP_TPU_FFT_PRECISION``:
      * ``default`` / ``high`` / ``highest`` — one global policy;
      * ``auto`` — per-axis-length policy: HIGH for transform lengths
        ``n <= CUDECOMP_TPU_FFT_AUTO_N`` (default 768), HIGHEST above;
      * unset — HIGHEST (full-f32 parity with cuFFT accuracy).
    """
    ov = _POLICY.get()
    val = (ov or {}).get("precision") or os.environ.get(
        "CUDECOMP_TPU_FFT_PRECISION", "")
    val = val.lower()
    if val == "default":
        return lax.Precision.DEFAULT
    if val == "high":
        return lax.Precision.HIGH
    if val == "highest":
        return lax.Precision.HIGHEST
    if val == "auto":
        if n is not None and n <= _auto_threshold():
            return lax.Precision.HIGH
        return lax.Precision.HIGHEST
    return lax.Precision.HIGHEST


_PREC = None  # resolved per call via _precision(); kept for monkeypatching

# trace-time policy override (plan-level knobs beat the env knobs); a
# ContextVar so nested traces and threads compose correctly
_POLICY = contextvars.ContextVar("cudecomp_tpu_fft_policy", default=None)


@contextlib.contextmanager
def policy(precision: str = None, gauss: bool = None):
    """Override the FFT policy for everything traced inside the block.

    ``precision`` in {"default", "high", "highest", "auto"}; ``gauss``
    toggles the 3-matmul complex multiply.  ``None`` fields defer to the
    enclosing :func:`policy` context if any, else to the env knobs — nested
    contexts compose (an inner ``policy(precision=...)`` inside a
    ``policy(gauss=False)`` block keeps ``gauss=False``).  This is how
    :class:`~cudecomp_tpu.ops.fft.DistributedFFT` pins a per-plan policy
    (the planner analog of cuFFT plan attributes)."""
    base = _POLICY.get() or {}
    new = {"precision": precision, "gauss": gauss}
    tok = _POLICY.set({**base, **{k: v for k, v in new.items()
                                  if v is not None}})
    try:
        yield
    finally:
        _POLICY.reset(tok)


def _factor_overrides():
    """CUDECOMP_TPU_FFT_FACTORS="1024=128x8,512=4x128" per-size overrides.

    Parsed lazily per call (like the other FFT env knobs) so runtime env
    changes take effect and malformed entries warn instead of breaking
    import."""
    out = {}
    spec = os.environ.get("CUDECOMP_TPU_FFT_FACTORS", "")
    for item in spec.split(","):
        if "=" in item and "x" in item:
            try:
                n, ab = item.split("=")
                a, b = ab.split("x")
                out[int(n)] = (int(a), int(b))
            except ValueError:
                from cudecomp_tpu.utils.env import log_warn
                log_warn(f"ignoring malformed CUDECOMP_TPU_FFT_FACTORS "
                         f"entry {item!r}")
    return out


def _best_factorization(n: int):
    """Factor n = A * B with A, B as close as possible (A >= B), unless an
    explicit override is configured for this size."""
    overrides = _factor_overrides()
    if n in overrides:
        a, b = overrides[n]
        if a * b == n:
            return a, b
        # same policy as malformed entries: warn, never break (the user
        # would otherwise benchmark believing their override is active)
        from cudecomp_tpu.utils.env import log_warn
        log_warn(f"CUDECOMP_TPU_FFT_FACTORS override {n}={a}x{b} ignored: "
                 f"product != {n}")
    b = int(math.isqrt(n))
    while n % b:
        b -= 1
    return n // b, b


@lru_cache(maxsize=None)
def _dft_mats(n: int, inverse: bool, dtype_name: str):
    """Dense DFT matrix (cos, sin-signed) as numpy constants."""
    k = np.arange(n)
    ang = 2.0 * np.pi * np.outer(k, k) / n
    sign = 1.0 if inverse else -1.0
    c = np.cos(ang)
    s = sign * np.sin(ang)
    return c.astype(dtype_name), s.astype(dtype_name)


@lru_cache(maxsize=None)
def _twiddle_bk(b: int, a: int, inverse: bool, dtype_name: str):
    """Twiddle W_N^{a k2} laid out as (k2, a) — matching the in-place dim
    order after the B-step (k2 replaces b at the split position)."""
    n = a * b
    ang = 2.0 * np.pi * np.outer(np.arange(b), np.arange(a)) / n
    sign = 1.0 if inverse else -1.0
    return (np.cos(ang).astype(dtype_name),
            (sign * np.sin(ang)).astype(dtype_name))


def _use_gauss() -> bool:
    """Gauss/Karatsuba complex multiply: 3 real matmuls instead of 4 (25%
    fewer matmul flops, a few extra elementwise adds).  Default ON.  Env:
    CUDECOMP_TPU_FFT_GAUSS=0 restores 4 matmuls; a :func:`policy` override
    beats the env."""
    ov = _POLICY.get()
    if ov and ov.get("gauss") is not None:
        return bool(ov["gauss"])
    return os.environ.get("CUDECOMP_TPU_FFT_GAUSS", "1") == "1"


def _cmatmul(xr, xi, mr, mi, eq, n=None):
    """Complex contraction (x @ M) on split parts: 4 real matmuls, or 3 with
    the Gauss form:  k1=(xr+xi)C, k2=xr(S-C), k3=xi(C+S);
    y_r = k1 - k3, y_i = k1 + k2  (C=mr, S=mi; matrices are constants so the
    combinations fold at compile time).  ``n`` is the transform length this
    contraction belongs to (drives the per-N ``auto`` precision policy)."""
    dot = partial(jnp.einsum, eq, precision=(_PREC or _precision(n)))
    if _use_gauss():
        k1 = dot(xr + xi, mr)
        k2 = dot(xr, mi - mr)
        k3 = dot(xi, mr + mi)
        return (k1 - k3, k1 + k2)
    return (dot(xr, mr) - dot(xi, mi), dot(xr, mi) + dot(xi, mr))


def _axis_eq(ndim: int, axis: int) -> str:
    """Einsum contracting dim ``axis`` in place: 'abc,bB->aBc' style.

    XLA lowers this to a canonical dot for any axis position (axis 0:
    lhs-transposed matmul; middle: batched matmul; last: plain matmul) with
    no materialized data permute."""
    dims = _LETTERS[:ndim]
    c = dims[axis]
    out = dims[:axis] + c.upper() + dims[axis + 1:]
    return f"{dims},{c}{c.upper()}->{out}"


def _radix_butterfly(vr, vi, b: int, axis: int, inverse: bool):
    """Explicit B-point DFT (B in {2, 4}) over dim ``axis``, elementwise.

    The small-factor stage of a large-N split would otherwise be a K=B
    matmul; the radix-2/4 DFT matrices contain only {0, +-1, +-i}, so the
    stage is pure adds and component swaps — elementwise work that XLA
    fuses."""
    take = lambda t, j: lax.index_in_dim(t, j, axis, keepdims=False)
    if b == 2:
        r0, i0, r1, i1 = take(vr, 0), take(vi, 0), take(vr, 1), take(vi, 1)
        yr = [r0 + r1, r0 - r1]
        yi = [i0 + i1, i0 - i1]
    else:  # b == 4
        r = [take(vr, j) for j in range(4)]
        i = [take(vi, j) for j in range(4)]
        er, ei = r[0] + r[2], i[0] + i[2]        # even sum
        fr, fi = r[1] + r[3], i[1] + i[3]        # odd sum
        gr, gi = r[0] - r[2], i[0] - i[2]        # even diff
        hr, hi = r[1] - r[3], i[1] - i[3]        # odd diff
        # w = -i (forward) / +i (inverse); w * (hr + i hi)
        if inverse:
            wr, wi = -hi, hr
        else:
            wr, wi = hi, -hr
        yr = [er + fr, gr + wr, er - fr, gr - wr]
        yi = [ei + fi, gi + wi, ei - fi, gi - wi]
    return (jnp.stack(yr, axis=axis), jnp.stack(yi, axis=axis))


def _fft_core(xr, xi, inverse: bool, axis: int):
    """FFT along dim ``axis`` of (xr, xi), in place.  Unscaled transform."""
    n = xr.shape[axis]
    dt = str(xr.dtype)
    if dt == "bfloat16":
        # bf16 carry (storage-only): DFT/twiddle constants and accumulation
        # stay f32 — einsum promotes bf16 x f32 to f32
        dt = "float32"
    if n == 1:
        return xr, xi
    a, b = _best_factorization(n)
    if n <= _direct_threshold() or b == 1:  # small or prime: dense DFT
        c, s = _dft_mats(n, inverse, dt)
        eq = _axis_eq(xr.ndim, axis)
        return _cmatmul(xr, xi, jnp.asarray(c), jnp.asarray(s), eq, n=n)

    # Factor choice stays near-sqrt by default.  When an explicit
    # CUDECOMP_TPU_FFT_FACTORS override selects a small factor, the
    # radix-2/4 stage below runs as elementwise butterflies instead of a
    # K=2/4 matmul.

    shape = xr.shape
    split = shape[:axis] + (b, a) + shape[axis + 1:]
    # v[..., b_, a_, ...] = x[..., a_ + A*b_, ...]  (C-order split, free)
    vr = xr.reshape(split)
    vi = xi.reshape(split)
    ndim = len(split)

    # step 1: B-point DFTs over b_ (at position `axis`), in place
    if b in (2, 4):
        yr, yi = _radix_butterfly(vr, vi, b, axis, inverse)
    else:
        cb, sb = _dft_mats(b, inverse, dt)
        yr, yi = _cmatmul(vr, vi, jnp.asarray(cb), jnp.asarray(sb),
                          _axis_eq(ndim, axis), n=n)
    # step 2: twiddle W_N^{a_ k2}, shaped (k2, a_) at (axis, axis+1)
    tc, ts = _twiddle_bk(b, a, inverse, dt)
    bshape = (1,) * axis + (b, a) + (1,) * (ndim - axis - 2)
    tc = jnp.asarray(tc).reshape(bshape)
    ts = jnp.asarray(ts).reshape(bshape)
    zr = yr * tc - yi * ts
    zi = yr * ts + yi * tc
    # step 3: A-point DFTs over a_ (at position axis+1), recursing if large
    if a > _direct_threshold():
        outr, outi = _fft_core(zr, zi, inverse, axis + 1)
        # recursion leaves sub-transform order (k1-major within a_); the
        # final flatten below composes indices as k1*B + k2 only when step 3
        # writes k1 at `axis` — swap the two sub-dims explicitly
        outr = jnp.swapaxes(outr, axis, axis + 1)
        outi = jnp.swapaxes(outi, axis, axis + 1)
    else:
        ca, sa = _dft_mats(a, inverse, dt)
        # contract a_ (axis+1), writing k1 to `axis` and keeping k2 at
        # axis+1: '...ka...,aK->...Kk...'
        dims = _LETTERS[:ndim]
        k2c, ac = dims[axis], dims[axis + 1]
        out = dims[:axis] + ac.upper() + k2c + dims[axis + 2:]
        eq = f"{dims},{ac}{ac.upper()}->{out}"
        outr, outi = _cmatmul(zr, zi, jnp.asarray(ca), jnp.asarray(sa),
                              eq, n=n)
    return outr.reshape(shape), outi.reshape(shape)


def fft_planes(r, i, axes, inverse: bool = False):
    """FFT along several data axes of separate (re, im) planes.

    The plane form is this engine's spectral format: the DFT contractions
    read/write the planes directly, so code that chains transforms should
    carry ``(r, i)`` and call this — the interleaved (..., 2) convenience
    form of :func:`fft_split_axes` costs a re-interleave pass.

    Inverse applies the combined 1/prod(N) scale once, in the last stage's
    epilogue.
    """
    ndim = r.ndim
    axes = [a % ndim for a in axes]
    if not axes:
        return r, i
    shape = r.shape
    scale = 1.0
    # opt-in experiment: store the inter-stage carry in bfloat16, halving
    # the memory traffic between axis contractions.  The matmul
    # contractions promote bf16 x f32 to f32, but elementwise work
    # CONSUMING a bf16 carry (Gauss operand pre-sums, radix-2/4
    # butterflies in peeled factorizations) runs at bf16 — its round-trip
    # error is far above the reference's 5e-4 gate.
    bf16_carry = os.environ.get("CUDECOMP_TPU_FFT_BF16_CARRY", "0") == "1"
    out_dtype = r.dtype
    for j, a in enumerate(axes):
        if inverse:
            scale *= 1.0 / shape[a]
        r, i = _fft_core(r, i, inverse, a)
        if bf16_carry and j < len(axes) - 1:
            r = r.astype(jnp.bfloat16)
            i = i.astype(jnp.bfloat16)
    r = r.astype(out_dtype)
    i = i.astype(out_dtype)
    if inverse and scale != 1.0:
        r = r * scale
        i = i * scale
    return r, i


def fft_split_axes(x, axes, inverse: bool = False):
    """FFT of split-complex ``x`` (..., 2) along several data axes.

    Carries the (re, im) planes separately across ALL stages (one slice at
    entry, one stack at exit — per-axis ``fft_split`` would re-stack and
    re-slice at every stage boundary, risking an extra HBM pass each).
    Chained-transform code should prefer :func:`fft_planes` and skip the
    stack/slice boundary entirely."""
    if x.shape[-1] != 2:
        raise ValueError(f"split-complex input must have trailing dim 2, "
                         f"got shape {tuple(x.shape)}")
    r, i = fft_planes(x[..., 0], x[..., 1], axes, inverse=inverse)
    return jnp.stack([r, i], axis=-1)


def fft_split(x, axis: int, inverse: bool = False):
    """FFT of split-complex ``x`` (..., 2) along data dim ``axis``.

    Forward is unscaled; inverse scales by 1/N (jnp.fft convention).
    The transform contracts ``axis`` in place — no data permutes.
    """
    if x.shape[-1] != 2:
        raise ValueError(f"split-complex input must have trailing dim 2, "
                         f"got shape {tuple(x.shape)}")
    ndim = x.ndim - 1  # data dims
    axis = axis % ndim
    r, i = _fft_core(x[..., 0], x[..., 1], inverse, axis)
    if inverse:
        scale = 1.0 / x.shape[axis]
        r = r * scale
        i = i * scale
    return jnp.stack([r, i], axis=-1)


def _use_half_spectrum() -> bool:
    """Dense r2c/c2r via (N, N//2+1) matrices: half the flops of the
    full-spectrum form, at an odd output width.  Default off;
    CUDECOMP_TPU_FFT_HALF_SPECTRUM=1 enables."""
    return os.environ.get("CUDECOMP_TPU_FFT_HALF_SPECTRUM", "0") == "1"


@lru_cache(maxsize=None)
def _rdft_mats(n: int, dtype_name: str):
    """Dense real-to-half-spectrum DFT matrices (n, n//2 + 1)."""
    nh = n // 2 + 1
    ang = 2.0 * np.pi * np.outer(np.arange(n), np.arange(nh)) / n
    return (np.cos(ang).astype(dtype_name),
            (-np.sin(ang)).astype(dtype_name))


@lru_cache(maxsize=None)
def _irdft_mats(n: int, dtype_name: str):
    """Dense half-spectrum-to-real inverse matrices (n//2 + 1, n).

    x[j] = (1/n) sum_k alpha_k (Fr[k] cos(2 pi j k / n) - Fi[k] sin(...)),
    alpha_k = 1 for k = 0 (and k = n/2 when n even), else 2 — the Hermitian
    mirror folded into the constants so no spectrum reconstruction pass is
    needed.
    """
    nh = n // 2 + 1
    k = np.arange(nh)
    alpha = np.full(nh, 2.0)
    alpha[0] = 1.0
    if n % 2 == 0:
        alpha[-1] = 1.0
    ang = 2.0 * np.pi * np.outer(k, np.arange(n)) / n
    cr = (alpha[:, None] * np.cos(ang)) / n
    ci = (-alpha[:, None] * np.sin(ang)) / n
    return cr.astype(dtype_name), ci.astype(dtype_name)


def _use_packed_r2c() -> bool:
    """Packed real transform (two reals per complex slot): the classic
    N/2-point-complex-FFT real transform (FFTW/cuFFT real plans use it).
    Default ON for even N >= 4 (half the contraction length, no wasted
    zero-imaginary matmuls); CUDECOMP_TPU_FFT_R2C_PACKED=0 restores the
    full-spectrum fallback."""
    return os.environ.get("CUDECOMP_TPU_FFT_R2C_PACKED", "1") == "1"


@lru_cache(maxsize=64)
def _r2c_pack_twiddles(n: int, dtype_name: str):
    """cos/sin(2*pi*k/n) for k = 0..n//2-1 (the untangle twiddles)."""
    k = np.arange(n // 2)
    ang = 2.0 * np.pi * k / n
    return (np.cos(ang).astype(dtype_name), np.sin(ang).astype(dtype_name))


def _bshape(ndim: int, axis: int, m: int):
    return (1,) * axis + (m,) + (1,) * (ndim - axis - 1)


def _rev_half(a, axis):
    """a[(m - k) mod m] along ``axis`` (index-reversal of an m-point
    spectrum): element 0 stays, the rest flips."""
    head = lax.slice_in_dim(a, 0, 1, axis=axis)
    tail = jnp.flip(lax.slice_in_dim(a, 1, a.shape[axis], axis=axis),
                    axis=axis)
    return jnp.concatenate([head, tail], axis=axis)


def _rfft_packed(x, axis):
    """rfft along ``axis`` (even extent n) via ONE n/2-point complex FFT.

    z[j] = f[2j] + i f[2j+1]; Z = FFT_{n/2}(z); with E/O the even/odd
    sub-spectra recovered by Hermitian (un)tangling,
    F[k] = E[k] + W_n^k O[k].  Halves the axis contraction length AND
    removes the zero-imaginary waste of the full-spectrum fallback.
    """
    n = x.shape[axis]
    m = n // 2
    ev = lax.slice_in_dim(x, 0, n, stride=2, axis=axis)
    od = lax.slice_in_dim(x, 1, n, stride=2, axis=axis)
    zr, zi = _fft_core(ev, od, inverse=False, axis=axis)
    zr_rev, zi_rev = _rev_half(zr, axis), _rev_half(zi, axis)
    er = (zr + zr_rev) * 0.5
    ei = (zi - zi_rev) * 0.5
    our = (zi + zi_rev) * 0.5
    oui = (zr_rev - zr) * 0.5
    c, s = _r2c_pack_twiddles(n, str(x.dtype))
    bs = _bshape(x.ndim, axis, m)
    c = jnp.asarray(c).reshape(bs)
    s = jnp.asarray(s).reshape(bs)
    fr = er + c * our + s * oui
    fi = ei + c * oui - s * our
    # k = m (Nyquist): W^m = -1 -> F[m] = E[0] - O[0]
    fr_m = (lax.slice_in_dim(er, 0, 1, axis=axis)
            - lax.slice_in_dim(our, 0, 1, axis=axis))
    fi_m = (lax.slice_in_dim(ei, 0, 1, axis=axis)
            - lax.slice_in_dim(oui, 0, 1, axis=axis))
    return (jnp.concatenate([fr, fr_m], axis=axis),
            jnp.concatenate([fi, fi_m], axis=axis))


def _irfft_packed(r, i, axis, n):
    """Inverse of :func:`_rfft_packed`: half spectrum (extent n//2+1) to
    the real signal (extent n) via ONE n/2-point complex inverse FFT."""
    m = n // 2
    # c2r semantics (numpy irfft, cuFFT C2R): the DC and Nyquist bins are
    # real by Hermitian symmetry — their imaginary parts are IGNORED
    zero = jnp.zeros_like(lax.slice_in_dim(i, 0, 1, axis=axis))
    i = jnp.concatenate(
        [zero, lax.slice_in_dim(i, 1, m, axis=axis), zero], axis=axis)
    fr = lax.slice_in_dim(r, 0, m, axis=axis)
    fi = lax.slice_in_dim(i, 0, m, axis=axis)
    # conj(F[m-k]) for k = 0..m-1: indices m..1
    fr_rev = jnp.flip(lax.slice_in_dim(r, 1, m + 1, axis=axis), axis=axis)
    fi_rev = jnp.flip(lax.slice_in_dim(i, 1, m + 1, axis=axis), axis=axis)
    er = (fr + fr_rev) * 0.5
    ei = (fi - fi_rev) * 0.5
    gr = (fr - fr_rev) * 0.5
    gi = (fi + fi_rev) * 0.5
    c, s = _r2c_pack_twiddles(n, str(r.dtype))
    bs = _bshape(r.ndim, axis, m)
    c = jnp.asarray(c).reshape(bs)
    s = jnp.asarray(s).reshape(bs)
    our = c * gr - s * gi          # O = G * W^{-k}, W^{-k} = c + i s
    oui = c * gi + s * gr
    zr = er - oui                  # Z = E + i O
    zi = ei + our
    wr, wi = _fft_core(zr, zi, inverse=True, axis=axis)
    wr = wr / m
    wi = wi / m
    # interleave: f[2j] = Re z[j], f[2j+1] = Im z[j]
    st = jnp.stack([wr, wi], axis=axis + 1)
    return st.reshape(r.shape[:axis] + (n,) + r.shape[axis + 1:])


def rfft_planes(x, axis: int):
    """Real-to-plane-form FFT along ``axis``: returns (r, i) planes with
    extent N//2 + 1 along ``axis``.

    For dense-DFT sizes the contraction uses (N, N//2+1) matrices directly
    — half the flops and output traffic of transforming the full spectrum
    and slicing.  With ``CUDECOMP_TPU_FFT_R2C_PACKED=1`` (and even N) the
    packed N/2-point-complex form runs instead (see :func:`_rfft_packed`).
    """
    n = x.shape[axis]
    axis = axis % x.ndim
    if _use_packed_r2c() and n % 2 == 0 and n >= 4:
        return _rfft_packed(x, axis)
    if _use_half_spectrum() and (n <= _direct_threshold()
                                 or _best_factorization(n)[1] == 1):
        c, s = _rdft_mats(n, str(x.dtype))
        eq = _axis_eq(x.ndim, axis)
        prec = _PREC or _precision(n)
        r = jnp.einsum(eq, x, jnp.asarray(c), precision=prec)
        i = jnp.einsum(eq, x, jnp.asarray(s), precision=prec)
        return r, i
    r, i = _fft_core(x, jnp.zeros_like(x), inverse=False, axis=axis)
    r = lax.slice_in_dim(r, 0, n // 2 + 1, axis=axis)
    i = lax.slice_in_dim(i, 0, n // 2 + 1, axis=axis)
    return r, i


def rfft_split(x, axis: int):
    """Real-to-split-complex FFT along ``axis``: output extent N//2 + 1.

    Interleaved (..., 2) form of :func:`rfft_planes`.
    """
    return jnp.stack(rfft_planes(x, axis), axis=-1)


def irfft_planes(r, i, axis: int, n: int):
    """Plane-form-to-real inverse FFT along ``axis`` (output extent n).

    Dense sizes contract the half spectrum straight to the real signal with
    the Hermitian weights folded into (N//2+1, N) constants — no spectrum
    reconstruction pass, two real matmuls at half K.
    """
    ndim = r.ndim
    axis = axis % ndim
    if _use_packed_r2c() and n % 2 == 0 and n >= 4:
        return _irfft_packed(r, i, axis, n)
    if _use_half_spectrum() and (n <= _direct_threshold()
                                 or _best_factorization(n)[1] == 1):
        cr, ci = _irdft_mats(n, str(r.dtype))
        eq = _axis_eq(r.ndim, axis)
        prec = _PREC or _precision(n)
        return (jnp.einsum(eq, r, jnp.asarray(cr), precision=prec)
                + jnp.einsum(eq, i, jnp.asarray(ci), precision=prec))
    # rebuild the full Hermitian spectrum: F[k] = conj(F[n-k]) for k > n//2
    k_half = n // 2
    mr = jnp.flip(lax.slice_in_dim(r, 1, n - k_half, axis=axis), axis=axis)
    mi = -jnp.flip(lax.slice_in_dim(i, 1, n - k_half, axis=axis), axis=axis)
    fr = jnp.concatenate([r, mr], axis=axis)
    fi = jnp.concatenate([i, mi], axis=axis)
    outr, _ = _fft_core(fr, fi, inverse=True, axis=axis)
    return outr / n


def irfft_split(x, axis: int, n: int):
    """Split-complex-to-real inverse FFT along ``axis`` (output extent n).

    Interleaved (..., 2) form of :func:`irfft_planes`.
    """
    return irfft_planes(x[..., 0], x[..., 1], axis % (x.ndim - 1), n)


def to_split(xc):
    """Complex array -> split-complex (..., 2) float array."""
    return jnp.stack([jnp.real(xc), jnp.imag(xc)], axis=-1)


def from_split(x):
    """Split-complex (..., 2) -> complex array (requires complex support)."""
    return x[..., 0] + 1j * x[..., 1]
