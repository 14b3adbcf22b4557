"""Pallas kernel (Triton route) for the banded varispeed windowed-sinc resampler.

XLA compiles the plain banded formulation
(``pipelines/respeeder_device.sinc_shift_mac``) as a loop of
``2*(nt+drift)`` passes, each of which reads and rewrites the whole
(segments, max_n) accumulator in device memory.  Here one program owns one
segment row and one power-of-two lane tile: it reads its row's block speeds
and positions once, keeps the accumulator in registers across every pass,
reads each pass's shifted signal window ``sig[start + v + k]`` straight from
device memory (consecutive passes overlap, so they hit L1/L2), and stores
once.  The tap weights are :func:`tap_weight`, the same function the XLA
formulation evaluates.

Runs compiled on the GPU and, with ``interpret=True``, in the Pallas
interpreter on the CPU (tests).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["tap_weight", "sinc_rows"]

# one program per (segment row, lane tile); chosen on an H100 among 32-128
# lanes and 1-4 warps (PERF.md, PR 1)
LANES, NUM_WARPS = 64, 2


def tap_weight(jj, shift, fc, in_seg, nt: int):
    """Windowed-sinc weight of integer tap ``jj`` (hann(2nt+1)[:2nt] taper,
    adaptive cutoff ``fc``, fractional anchor offset ``shift``); zero outside
    ``[-nt, nt)`` and outside the segment.  ``jnp.sinc`` written out so the
    Triton route lowers it."""
    valid = (jj >= -nt) & (jj < nt) & in_seg
    jf = jj.astype(jnp.float32)
    x = (jf - shift) * fc
    px = np.float32(np.pi) * x
    safe = jnp.where(x == 0, 1.0, px)
    sinc = jnp.where(x == 0, 1.0, jnp.sin(safe) / safe)
    hann = 0.5 - 0.5 * jnp.cos(np.pi * (jf + nt) / nt)
    return jnp.where(valid, sinc * fc * hann, 0.0)


def _round_half_even(x):
    """``jnp.round`` from floor (the Triton route has no round): exact for
    |x| < 2**23."""
    r = jnp.floor(x)
    d = x - r
    odd = (r - 2.0 * jnp.floor(0.5 * r)) == 1.0
    return r + jnp.where((d > 0.5) | ((d == 0.5) & odd), 1.0, 0.0)


def _kernel(start_ref, n_ref, sig_ref, bs_ref, rel_ref, out_ref, *, nt: int,
            drift: int, max_n: int, lanes: int):
    row = pl.program_id(0)
    lane0 = pl.program_id(1) * lanes
    k = lane0 + jax.lax.broadcasted_iota(jnp.int32, (lanes,), 0)
    in_row = k < max_n
    at = pl.ds(row * max_n + lane0, lanes)
    bs = plgpu.load(bs_ref.at[at], mask=in_row, other=1.0)
    rel = plgpu.load(rel_ref.at[at], mask=in_row, other=0.0)
    in_seg = k < n_ref[row]
    ind_local = _round_half_even(rel)
    shift = rel - ind_local
    m = ind_local.astype(jnp.int32) - k
    fc = jnp.minimum(bs, 1.0)
    U = nt + drift
    n_sig = sig_ref.shape[0]
    idx0 = start_ref[row] + k  # signal index each lane reads on pass 0

    def body(v, acc):
        idx = idx0 + v
        x = sig_ref[jnp.clip(idx, 0, n_sig - 1)]
        x = jnp.where((idx >= 0) & (idx < n_sig), x, 0.0)
        return acc + x * tap_weight((v - U) - m, shift, fc, in_seg, nt)

    acc = jax.lax.fori_loop(0, 2 * U, body, jnp.zeros((lanes,), jnp.float32))
    plgpu.store(out_ref.at[at], acc, mask=in_row)


@functools.partial(jax.jit, static_argnames=("nt", "drift", "interpret"))
def sinc_rows(sig, starts, bs, rel, n, *, nt: int, drift: int,
              interpret: bool = False):
    """Banded windowed-sinc rows: the kernel twin of ``sinc_shift_mac``.

    ``sig``: (N,) signal; row i's window starts at ``starts[i]`` (its integer
    anchor minus ``nt + drift``; samples outside ``[0, N)`` read zero).
    ``bs``/``rel``: (T, max_n) block speeds and anchor-relative positions
    from ``segment_grids``; ``n``: (T,) output counts.  Returns (T, max_n);
    entries with k >= n[i] are zero.
    """
    T, max_n = bs.shape
    lanes = LANES
    tiles = -(-max_n // lanes)
    # a tail of ``lanes`` keeps every lane tile's slice inside the arrays
    # (the GPU masks the overhang; the interpreter would clamp the slice)
    tail = ((0, lanes),)
    bs_f = jnp.pad(bs.reshape(-1), tail, constant_values=1.0)
    rel_f = jnp.pad(rel.reshape(-1), tail)
    kernel = functools.partial(_kernel, nt=nt, drift=drift, max_n=max_n,
                               lanes=lanes)
    out = pl.pallas_call(
        kernel,
        grid=(T, tiles),
        out_shape=jax.ShapeDtypeStruct((T * max_n + lanes,), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="sinc_banded_rows",
    )(starts.astype(jnp.int32), n.astype(jnp.int32),
      sig.astype(jnp.float32), bs_f, rel_f)
    return out[:T * max_n].reshape(T, max_n)
