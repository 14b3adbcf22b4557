"""Device-resident wow/flutter restoration — the performance path.

The portable pipeline (respeeder.py) moves the spectrogram and the position
curve through the host; that costs HBM<->host bandwidth which dominates end
to end.  This module keeps the whole hot path on the device:

  upload signal once
   -> jit A: STFT -> banded peak tracking -> speed curve        (device)
   -> host: tiny position plan (segment counts + f64 base offsets, ~100 KB)
   -> jit B: two-level position reconstruction + windowed-sinc resample
             on a (segments, max_n) padded grid                  (device)

Host<->device traffic beyond the signal upload is ~100 KB regardless of
audio length.  The position plan keeps the reference's exact semantics
(dithered per-segment output counts, resampling.py:93-137): segment base
offsets are computed in float64 on the host, within-segment offsets in
float32 on device (bounded by one hop, so exactly representable).

The padded-grid sinc is the same math as ops/resampling.py (2*NT taps,
hann(2NT+1)[:2NT], adaptive cutoff) with fc = min(block_speed, 1) — the
reference's 1/(p[i+1]-p[i]) evaluated in closed form.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels.sinc_triton import sinc_rows, tap_weight
from ..models.trackers import masked_peak_refine
from ..ops.fourier import get_window
from ..ops.resampling import _sinc_window

__all__ = ["track_speed_device", "track_peaks_span", "plan_positions",
           "restore_fused_takes", "segment_grids", "segment_advances",
           "sinc_shift_mac", "run_banded_sinc",
           "sinc_padded_device", "restore_device", "compact_output",
           "compact_padded_device",
           "restore_file_fast", "restore_file_streamed"]


def segment_grids(s_lo, s_hi, nn, bf, max_n: int):
    """Per-segment block-speed / position grids shared by every banded-sinc
    tier (the reference's lerped block speeds, resampling.py:107-119).

    s_lo/s_hi/nn/bf: (T,) segment endpoint speeds, output counts, fractional
    base offsets.  Returns (bs, rel, in_seg): (T, max_n) lerped block speeds,
    positions relative to the integer window anchor, and the validity mask.
    """
    kf = jnp.arange(max_n, dtype=jnp.float32)[None, :]
    ki = jnp.arange(max_n, dtype=jnp.int32)[None, :]
    denom = jnp.maximum(nn[:, None] - 1, 1).astype(jnp.float32)
    bs = s_lo[:, None] + kf / denom * (s_hi[:, None] - s_lo[:, None])
    in_seg = ki < nn[:, None]
    inv = jnp.where(in_seg, 1.0 / bs, 0.0)
    rel = jnp.cumsum(inv, axis=1) + bf[:, None]
    return bs, rel, in_seg


def sinc_shift_mac(buf, bs, rel, in_seg, max_n: int, nt: int, drift: int):
    """The banded windowed-sinc shift-MAC inner loop (XLA tier).

    ``buf``: (T, L) contiguous signal windows, row i starting at
    ``anchor_i - (nt + drift)``; ``bs``/``rel``/``in_seg`` from
    :func:`segment_grids`.  Each of the ``2*(nt+drift)`` passes slides the
    window one sample and accumulates ``sinc * cutoff * hann`` taps
    (:func:`~..kernels.sinc_triton.tap_weight`, shared with the GPU kernel)
    without a per-tap gather.  Shared by the dense tier
    (:func:`sinc_banded_device`) and the sharded tier
    (parallel/sharded.py) so the tap math cannot drift between them.
    """
    U = nt + drift
    ki = jnp.arange(max_n, dtype=jnp.int32)[None, :]
    ind_local = jnp.round(rel).astype(jnp.int32)
    shift = rel - ind_local
    fc = jnp.minimum(bs, 1.0)
    m = ind_local - ki  # |m| <= drift by the caller's drift contract

    def body(v, out):
        w = tap_weight((v - U) - m, shift, fc, in_seg, nt)
        seg = jax.lax.dynamic_slice_in_dim(buf, v, max_n, axis=1)
        return out + seg * w

    return jax.lax.fori_loop(0, 2 * U, body,
                             jnp.zeros(bs.shape, jnp.float32))


def _tree_sum_last(x):
    """Fixed-order binary-tree sum over the last axis via explicit
    elementwise adds.  XLA's ``reduce`` is free to reassociate — and DOES
    pick different orders in different enclosing programs, which turned the
    per-segment advance sums into a nondeterminism source across programs
    (two programs that differed only in their sinc stage produced
    ``base_frac`` plans differing ~2.7e-4 at e.g. n=49999, breaking their
    3e-5 output parity).
    Elementwise adds have a fixed DAG, so this is bit-deterministic for any
    program shape at the same FLOP count."""
    # pad-to-even at each level (not to the next power of two upfront: that
    # would transiently hold up to ~2x the documented (chunk, max_n) grid)
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = jnp.pad(x, ((0, 0),) * (x.ndim - 1) + ((0, 1),))
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def segment_advances(s_lo, s_hi, n, max_n: int, seg_chunk: int = 32768):
    """Exact per-segment input advances ``A_i = sum_k 1/bs_ik`` on the padded
    grid, chunked so HBM holds one (seg_chunk, max_n) reciprocal grid at a
    time.  Shared by the fused single-chip step and the sharded step."""
    kf = jnp.arange(max_n, dtype=jnp.float32)[None, :]
    ki = jnp.arange(max_n, dtype=jnp.int32)[None, :]

    def a_chunk(args):
        lo, hi, nn = args
        denom = jnp.maximum(nn[:, None] - 1, 1).astype(jnp.float32)
        bs = lo[:, None] + kf / denom * (hi[:, None] - lo[:, None])
        inv = jnp.where(ki < nn[:, None], 1.0 / bs, 0.0)
        # A_i = n_i + sum(1/bs - 1): the integer part is exact and the
        # residual sum has ~n_i/30 the magnitude of sum(1/bs) (speeds are
        # near 1), so the deterministic tree sum's absolute error shrinks by
        # the same factor.  inv - 1 is EXACT for inv in [0.5, 2] (Sterbenz;
        # half-ulp-of-small-result otherwise, still ~1e-8).
        e = jnp.where(ki < nn[:, None], inv - 1.0, 0.0)
        return nn.astype(jnp.float32) + _tree_sum_last(e)

    T = n.shape[0]
    if T <= seg_chunk:
        return a_chunk((s_lo, s_hi, n))
    pad_t = (-T) % seg_chunk
    nt_chunks = (T + pad_t) // seg_chunk
    return jax.lax.map(a_chunk, (
        jnp.pad(s_lo, (0, pad_t), constant_values=1.0).reshape(nt_chunks, seg_chunk),
        jnp.pad(s_hi, (0, pad_t), constant_values=1.0).reshape(nt_chunks, seg_chunk),
        jnp.pad(n, (0, pad_t)).reshape(nt_chunks, seg_chunk),
    )).reshape(-1)[:T]


@functools.lru_cache(maxsize=16)
def _banded_dft_matrix(n_fft: int, zeropad: int, lo: int, hi: int) -> np.ndarray:
    """(n_fft, 2*(hi-lo)) real DFT matrix computing rFFT bins [lo, hi) of the
    zero-padded transform — cos columns then sin columns, pre-scaled by the
    reference's 1/sqrt(n_fft) norm."""
    ang = -2.0 * np.pi * np.outer(np.arange(n_fft), np.arange(lo, hi)) / (n_fft * zeropad)
    scale = 1.0 / np.sqrt(n_fft)
    return np.concatenate([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32) * scale


def banded_refined_chunk(xs, nl, nu, n_fft: int, step: int, zeropad: int,
                         window_name: str, band, chunk: int):
    """Shared banded-DFT peak refinement over one chunk of frames.

    ``xs``: (..., span) raw samples — frame p of the chunk starts at
    ``xs[..., p*step]``.  ``nl``/``nu``: (..., chunk) absolute bin limits.
    One function body serves the dense, batched-takes, and sharded tiers so
    their tracking cannot drift.

    The formulation (window multiply feeding a (chunk, n_fft) x
    (n_fft, 2*nb) dot) is LOAD-BEARING for the bit-parity architecture: a
    frame's value depends only on its own window samples, and this exact
    producer+dot shape is the one whose compiled reduction order measured
    RANK-INVARIANT on the CPU (dense rank-2 vs sharded/batched rank-3 agree
    bit-for-bit).  Group-packing G frames per dot row (window folded into
    a block-shifted matrix) was tried and rejected: without the elementwise
    producer XLA lowers the dot through library GEMMs whose K-reduction
    order varies with rank AND with the flattened row count (same data,
    rank-2 vs rank-3, 5e-7 disagreements), which flips plan dither
    roundings and breaks the dense/sharded bit-exact contract
    (docs/ARCHITECTURE.md §13)."""
    lo, hi = int(band[0]), int(band[1])
    nb = hi - lo
    window = jnp.asarray(get_window(window_name, n_fft))
    dft = jnp.asarray(_banded_dft_matrix(n_fft, zeropad, lo, hi))
    ratio = n_fft // step
    blocks = xs.reshape(*xs.shape[:-1], -1, step)
    frames = jnp.concatenate(
        [blocks[..., j:j + chunk, :] for j in range(ratio)], axis=-1) * window
    ri = jnp.dot(frames, dft, precision=jax.lax.Precision.HIGHEST)
    mag = jnp.sqrt(ri[..., :nb] ** 2 + ri[..., nb:] ** 2) + 1e-7
    return masked_peak_refine(mag, nl - lo, nu - lo, bin_offset=float(lo))


@functools.partial(jax.jit, static_argnames=("n_frames", "n_fft", "step",
                                              "zeropad", "window_name",
                                              "chunk_frames", "band"))
def track_peaks_span(xp, NL, NU, n_frames: int, n_fft: int, step: int,
                     zeropad: int = 1, window_name: str = "blackmanharris",
                     chunk_frames: int = 4096, band=None):
    """Banded peak tracking over an already-padded span of samples.

    ``xp`` holds the samples frame 0 starts on (any centering/reflect padding
    already applied); frame t covers ``xp[t*step : t*step+n_fft]``.  Returns
    the refined (parabolic) peak bin per frame — the frame-parallel core of
    the Peak tracker (wow_detection.py:294-304 + 119-134).

    ``band``: optional STATIC (lo, hi) bin bounds covering every per-frame
    [NL, NU) window plus one parabolic-neighbor margin.  When given, the
    full rFFT is replaced by a banded real-DFT **matmul** — the spectrum is
    only ever inspected inside the band, so the frames x (n_fft, 2(hi-lo))
    product computes exactly the needed bins and nothing else.

    The STFT streams through ``lax.map`` tiles of ``chunk_frames`` frames so
    HBM usage stays bounded for arbitrarily long recordings (the FFT temps of
    a monolithic frame matrix are ~8x the frame bytes).
    """
    assert n_fft % step == 0
    window = jnp.asarray(get_window(window_name, n_fft))
    ratio = n_fft // step
    n_chunks = -(-n_frames // chunk_frames)
    span = (chunk_frames + ratio - 1) * step
    xp2 = jnp.pad(xp.astype(jnp.float32),
                  (0, max(0, n_chunks * chunk_frames * step + span - xp.shape[0])))
    pad_t = n_chunks * chunk_frames - n_frames
    num_bins = n_fft * zeropad // 2 + 1
    if band is not None:
        lo = max(0, int(band[0]))
        hi = min(num_bins, int(band[1]))
        nb = hi - lo
    else:
        lo, nb = 0, num_bins
    NLp = jnp.pad(NL, (0, pad_t), constant_values=lo + 1)
    NUp = jnp.pad(NU, (0, pad_t), constant_values=lo + 2)

    def one_chunk(args):
        c, nl, nu = args
        xs = jax.lax.dynamic_slice(xp2, (c * chunk_frames * step,), (span,))
        if band is not None:
            # shared banded-DFT chunk kernel (same body as the sharded tier)
            return banded_refined_chunk(xs, nl, nu, n_fft, step, zeropad,
                                        window_name, (lo, lo + nb),
                                        chunk_frames)
        blocks = xs.reshape(-1, step)
        frames = jnp.concatenate(
            [blocks[j:j + chunk_frames] for j in range(ratio)], axis=1) * window
        spec = jnp.fft.rfft(frames, n=n_fft * zeropad, axis=-1) / np.sqrt(n_fft)
        mag = jnp.abs(spec) + 1e-7  # (chunk, F)
        # nl/nu are absolute bins; mag's F axis is band-local (offset lo)
        return masked_peak_refine(mag, nl - lo, nu - lo, bin_offset=float(lo))

    refined = jax.lax.map(one_chunk, (
        jnp.arange(n_chunks),
        NLp.reshape(n_chunks, chunk_frames),
        NUp.reshape(n_chunks, chunk_frames)))
    return refined.reshape(-1)[:n_frames]


@functools.partial(jax.jit, static_argnames=("n_fft", "step", "zeropad",
                                              "window_name", "chunk_frames",
                                              "band"))
def track_speed_device(x, NL, NU, n_fft: int, step: int, zeropad: int = 1,
                       window_name: str = "blackmanharris",
                       chunk_frames: int = 4096, band=None, frame_mask=None,
                       inv_limbs=None):
    """STFT + banded peak tracking + speed normalization, all on device.

    x: (n,) waveform.  NL/NU: per-frame band limits (int32 device arrays).
    ``band``: optional static (lo, hi) bound on all NL/NU values — enables
    the banded-DFT matmul fast path (see track_peaks_span).
    ``frame_mask``/``inv_limbs``: valid-frame restriction of the centering
    mean for padded takes (see :func:`normalize_speeds`).
    Returns speeds (T,) centered on ~1.0 (the Peak tracker + TraceLine
    normalization, wow_detection.py:294-304 + markers.py:190-192).
    """
    xp = jnp.pad(x.astype(jnp.float32), n_fft // 2, mode="reflect")
    n_frames = (xp.shape[0] - n_fft) // step + 1
    refined = track_peaks_span(xp, NL, NU, n_frames, n_fft, step, zeropad,
                               window_name, chunk_frames, band)
    return normalize_speeds(refined, center=log_center_for_band(band),
                            frame_mask=frame_mask, inv_limbs=inv_limbs)


def log_center_for_band(band):
    """Static log2 pivot for the exact mean, derived from the static band
    bound so every tier (and every shard partition) agrees on it."""
    if band is None:
        return None
    return float(np.log2(max((band[0] + band[1]) / 2.0, 2.0)))


def _carry(hi, lo, base=4096.0):
    """One base-4096 carry step on exact-integer float32 limbs."""
    c = jnp.floor(lo / base)
    return hi + c, lo - c * base


def quantized_log_sums(ls, center: float, mask=None):
    """Exact integer sum of ``q = round((ls - center) * 2**16)`` as three
    float32 base-4096 limbs (h2, h1, lo).

    Every partial sum stays below 2**24, so each limb is an exactly
    represented integer and the (canonicalized) limb triple is IDENTICAL for
    ANY partition of the frames — summing per time shard and combining with
    ``psum`` yields the same limbs as the dense whole-array sum.  That makes
    the global speed-curve centering bit-identical between the single-chip
    tier and the sharded tier (a plain float mean reassociates, and a ~1e-7
    difference is enough to flip dither roundings downstream).

    Exact for up to ~2**24 frames with |ls - center| <= 1 (a 16 M-frame
    recording at hop 512 is ~12 h of 192 kHz audio; beyond that the streamed
    tier applies).  ``mask``: optional 0/1 frame-validity multiplier.
    """
    q = jnp.round((ls - center) * 65536.0)
    if mask is not None:
        q = q * mask
    T = q.shape[-1]
    pad = (-T) % (128 * 128)
    qb = jnp.pad(q, [(0, 0)] * (q.ndim - 1) + [(0, pad)])
    qb = qb.reshape(*q.shape[:-1], -1, 128, 128)
    bs = jnp.sum(qb, axis=-1)                   # block sums, exact (< 2**23)
    h1, lo = _carry(jnp.zeros_like(bs), bs)     # base-4096 digits per block
    # group stage (128 blocks): limb sums stay < 2**19, still exact
    h1g = jnp.sum(h1, axis=-1)
    log_ = jnp.sum(lo, axis=-1)
    h2g, h1g = _carry(jnp.zeros_like(h1g), h1g)
    # total over groups: exact, then canonicalize
    h2 = jnp.sum(h2g, axis=-1)
    h1 = jnp.sum(h1g, axis=-1)
    lo = jnp.sum(log_, axis=-1)
    h1, lo = _carry(h1, lo)
    h2, h1 = _carry(h2, h1)
    return h2, h1, lo


def exact_log_center(limbs, count: int, center: float, inv_limbs=None):
    """Mean of the quantized log speeds from exact limb sums.  The division
    expression is fixed, so identical (canonical) limbs give a bit-identical
    mean on every tier.

    ``inv_limbs``: optional per-row (…, 3) float32 override of the three
    1/count limb factors (``inv_count_limbs``).  They are computed on the
    HOST in float64 exactly like a static Python ``count`` would be at trace
    time, so a data-dependent frame count (masked batch takes) produces the
    same f32 multiply operands — and therefore a bit-identical mean — as the
    static-count dense path."""
    h2, h1, lo = limbs
    h1, lo = _carry(h1, lo)
    h2, h1 = _carry(h2, h1)
    inv = 1.0 / 65536.0
    if inv_limbs is not None:
        c0, c1, c2 = inv_limbs[..., 0], inv_limbs[..., 1], inv_limbs[..., 2]
    else:
        c0, c1, c2 = 4096.0 * 4096.0 / count, 4096.0 / count, 1.0 / count
    return center + (h2 * c0 + h1 * c1 + lo * c2) * inv


def inv_count_limbs(counts):
    """Host: frame counts -> the (…, 3) float32 1/count limb factors of
    :func:`exact_log_center`, divided in float64 exactly as Python would at
    trace time for a static count (bit-parity with the dense tier)."""
    c = np.asarray(counts, np.float64)
    return np.stack([4096.0 * 4096.0 / c, 4096.0 / c, 1.0 / c],
                    axis=-1).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("center",))
def normalize_speeds(refined, center: float = None, frame_mask=None,
                     inv_limbs=None):
    """Refined peak bins -> speed curve centered on ~1.0 (TraceLine
    normalization, markers.py:190-192).  Shared by the in-memory and the
    streamed tracking paths so both produce bit-identical curves.

    ``center``: static log2-bin pivot enabling the exact partition-invariant
    mean (see :func:`quantized_log_sums`) — pass it wherever the dense and
    sharded tiers must produce identical curves.  ``None`` keeps the plain
    float mean (standalone callers).

    ``frame_mask``/``inv_limbs``: restrict the centering mean to the valid
    frames of a padded take (TraceLine means over the TAKE, not the pad —
    markers.py:190-192); ``inv_limbs`` are the host-computed
    :func:`inv_count_limbs` of the valid frame count."""
    log_speed = jnp.log2(jnp.maximum(refined, 1.0))
    if center is None:
        mean = jnp.mean(log_speed)
    else:
        mean = exact_log_center(
            quantized_log_sums(log_speed, center, mask=frame_mask),
            log_speed.shape[-1], center, inv_limbs=inv_limbs)
    return jnp.power(2.0, log_speed - mean)


def plan_positions(speeds_np, hop: int, num_input_samples: int, t0_samples: float = 0.0):
    """Host-side position plan from a frame-rate speed curve (float64, tiny).

    Returns a dict with per-segment output counts ``n``, float64 base offsets
    split into (int32, float32), segment output starts, n_out and max_n.
    Mirrors the reference's dithering exactly (resampling.py:107-137) via the
    rounded-cumsum closed form.
    """
    speeds = np.asarray(speeds_np, dtype=np.float64)
    T = len(speeds) - 1
    n_raw = hop * (speeds[:-1] + speeds[1:]) / 2.0
    cum = np.cumsum(n_raw)
    n = np.diff(np.round(np.concatenate([[0.0], cum]))).astype(np.int64)
    n = np.maximum(n, 0)
    max_n = int(n.max()) if T else 0
    # exact segment advance A_i = sum_k 1/bs_(i,k) on the padded grid (f64)
    k = np.arange(max_n)[None, :]
    denom = np.maximum(n[:, None] - 1, 1).astype(np.float64)
    bs = speeds[:-1, None] + k / denom * (speeds[1:, None] - speeds[:-1, None])
    inv = np.where(k < n[:, None], 1.0 / bs, 0.0)
    A = inv.sum(axis=1)
    base = t0_samples + np.concatenate([[0.0], np.cumsum(A)[:-1]])
    starts = np.concatenate([[0], np.cumsum(n)[:-1]])
    # end trim (reference: nearest position to the input end)
    ends = base + A
    n_out = int(n.sum())
    over = np.nonzero(ends >= num_input_samples)[0]
    if len(over):
        i = over[0]
        # refine inside segment i: count positions <= crossing
        rel = np.cumsum(inv[i])
        j = int(np.argmin(np.abs(base[i] + rel[: max(1, n[i])] - num_input_samples)))
        n_out = int(starts[i] + j)
    base_int = np.floor(base).astype(np.int32)
    base_frac = (base - base_int).astype(np.float32)
    # drift bound for the banded kernel: max |anchor - output index| in-segment
    rel = np.cumsum(inv, axis=1) + base_frac[:, None]
    m = np.where(k < n[:, None], np.abs(np.round(rel) - k), 0)
    drift = int(m.max()) + 1 if m.size else 1
    return {
        "n": n.astype(np.int32), "base_int": base_int, "base_frac": base_frac,
        "starts": starts.astype(np.int64), "max_n": max_n, "n_out": n_out,
        "drift": drift,
    }


def plan_positions_fast(speeds_np, hop: int, num_input_samples: int,
                        t0_samples: float = 0.0):
    """O(n_segments) position plan via the exact digamma closed form.

    The per-segment advance ``A_i = sum_k 1/(a + c k)`` equals
    ``(psi(a/c + n) - psi(a/c)) / c`` exactly (digamma recurrence), so the
    5M-element reciprocal grid of :func:`plan_positions` collapses to two
    digamma evaluations per segment.  Same outputs (float64 parity ~1e-9).
    """
    from scipy.special import digamma

    speeds = np.asarray(speeds_np, dtype=np.float64)
    n_raw = hop * (speeds[:-1] + speeds[1:]) / 2.0
    cum = np.cumsum(n_raw)
    n = np.diff(np.round(np.concatenate([[0.0], cum]))).astype(np.int64)
    n = np.maximum(n, 0)
    max_n = int(n.max()) if len(n) else 0
    a = speeds[:-1].copy()
    b = speeds[1:].copy()
    # use the positive-slope orientation so digamma args stay positive
    swap = b < a
    a2 = np.where(swap, b, a)
    b2 = np.where(swap, a, b)
    denom = np.maximum(n - 1, 1)
    c = (b2 - a2) / denom
    tiny = np.abs(c) < 1e-12
    c_safe = np.where(tiny, 1.0, c)
    with np.errstate(invalid="ignore", divide="ignore"):
        A_slope = (digamma(a2 / c_safe + n) - digamma(a2 / c_safe)) / c_safe
    A = np.where(tiny | (n <= 1), np.where(n >= 1, n / a2, 0.0), A_slope)
    # n == 1 single-sample segments evaluate bs at k=0 -> 1/a (original a!)
    one = n == 1
    if one.any():
        A[one] = 1.0 / a[one]
    base = t0_samples + np.concatenate([[0.0], np.cumsum(A)[:-1]])
    starts = np.concatenate([[0], np.cumsum(n)[:-1]])
    ends = base + A
    n_out = int(n.sum())
    over = np.nonzero(ends >= num_input_samples)[0]
    if len(over):
        i = over[0]
        k = np.arange(max(1, n[i]))
        bs = speeds[i] + k / max(n[i] - 1, 1) * (speeds[i + 1] - speeds[i])
        rel = np.cumsum(1.0 / bs)
        j = int(np.argmin(np.abs(base[i] + rel - num_input_samples)))
        n_out = int(starts[i] + j)
    base_int = np.floor(base).astype(np.int32)
    base_frac = (base - base_int).astype(np.float32)
    # analytic drift bound: |anchor - k| <= max_n * max|1/speed - 1| + 2
    dmax = float(np.max(np.abs(1.0 / speeds - 1.0))) if len(speeds) else 0.0
    drift = int(np.ceil(max_n * dmax)) + 2
    return {
        "n": n.astype(np.int32), "base_int": base_int, "base_frac": base_frac,
        "starts": starts.astype(np.int64), "max_n": max_n, "n_out": n_out,
        "drift": drift,
    }


@functools.partial(jax.jit, static_argnames=("max_n", "nt", "tile"))
def sinc_padded_device(sig, speeds, n, base_int, base_frac, max_n: int,
                       nt: int = 50, tile: int = 64):
    """Two-level varispeed windowed-sinc resample on a padded segment grid.

    sig (N,), speeds (T+1,), n (T,), base_int/base_frac (T,).
    Returns (T, max_n) padded output; entries with k >= n[i] are zero.
    """
    n_in = sig.shape[0]
    T = n.shape[0]
    offs = np.arange(-nt, nt, dtype=np.int32)
    win = jnp.asarray(_sinc_window(nt))
    pad_t = (-T) % tile
    if pad_t:
        speeds_lo = jnp.pad(speeds[:-1], (0, pad_t), constant_values=1.0)
        speeds_hi = jnp.pad(speeds[1:], (0, pad_t), constant_values=1.0)
        n_p = jnp.pad(n, (0, pad_t))
        bi_p = jnp.pad(base_int, (0, pad_t))
        bf_p = jnp.pad(base_frac, (0, pad_t))
    else:
        speeds_lo, speeds_hi = speeds[:-1], speeds[1:]
        n_p, bi_p, bf_p = n, base_int, base_frac
    k = jnp.arange(max_n, dtype=jnp.float32)[None, :]

    def one_tile(args):
        s_lo, s_hi, nn, bi, bf = args
        denom = jnp.maximum(nn[:, None] - 1, 1).astype(jnp.float32)
        bs = s_lo[:, None] + k / denom * (s_hi[:, None] - s_lo[:, None])
        valid = k < nn[:, None].astype(jnp.float32)
        inv = jnp.where(valid, 1.0 / bs, 0.0)
        rel = jnp.cumsum(inv, axis=1) + bf[:, None]  # local position, < hop*speed+1
        ind_local = jnp.round(rel).astype(jnp.int32)
        shift = rel - ind_local
        fc = jnp.minimum(bs, 1.0)
        ind = bi[:, None] + ind_local  # (tile, max_n) absolute anchors
        idx = ind[:, :, None] + offs[None, None, :]
        in_range = (idx >= 0) & (idx < n_in)
        g = sig[jnp.clip(idx, 0, n_in - 1)]
        xw = (offs[None, None, :].astype(jnp.float32) - shift[:, :, None]) * fc[:, :, None]
        w = jnp.sinc(xw) * fc[:, :, None] * win[None, None, :]
        out = jnp.sum(jnp.where(in_range, g * w, 0.0), axis=-1)
        return jnp.where(valid, out, 0.0)

    n_tiles = (T + pad_t) // tile
    res = jax.lax.map(one_tile, (
        speeds_lo.reshape(n_tiles, tile), speeds_hi.reshape(n_tiles, tile),
        n_p.reshape(n_tiles, tile), bi_p.reshape(n_tiles, tile),
        bf_p.reshape(n_tiles, tile)))
    return res.reshape(-1, max_n)[:T]


def sinc_banded_segments(sig, s_lo, s_hi, n, base_int, base_frac, max_n: int,
                         nt: int = 50, drift: int = 32, seg_tile: int = 32768,
                         force_chunk: bool = False):
    """Segments-level XLA banded sinc: like :func:`sinc_banded_device` but
    taking per-segment endpoint speeds directly, so callers can flatten a
    BATCH of takes into one segment axis (``restore_fused_takes``) and the
    inner kernel shape stays (seg_tile, ...) regardless of batch size.

    ``force_chunk``: always run through fixed seg_tile chunks even when the
    total fits one — the chunk shape (not the total) is what the compiled
    kernel sees, so any batch size reuses the same inner computation.
    """
    n_in = sig.shape[0]
    T = n.shape[0]
    U = nt + drift
    L = max_n + 2 * U

    def run_tile(args):
        lo, hi, nn, bi, bf = args
        bs, rel, in_seg = segment_grids(lo, hi, nn, bf, max_n)
        start = bi - U
        idx = start[:, None] + np.arange(L)[None, :]
        buf = jnp.where((idx >= 0) & (idx < n_in), sig[jnp.clip(idx, 0, n_in - 1)], 0.0)
        return sinc_shift_mac(buf, bs, rel, in_seg, max_n, nt, drift)

    if T <= seg_tile and not force_chunk:
        return run_tile((s_lo, s_hi, n, base_int, base_frac))
    # tile the segment axis so HBM stays bounded for long recordings
    pad_t = (-T) % seg_tile
    n_tiles = (T + pad_t) // seg_tile
    out = jax.lax.map(run_tile, (
        jnp.pad(s_lo, (0, pad_t), constant_values=1.0).reshape(n_tiles, seg_tile),
        jnp.pad(s_hi, (0, pad_t), constant_values=1.0).reshape(n_tiles, seg_tile),
        jnp.pad(n, (0, pad_t)).reshape(n_tiles, seg_tile),
        jnp.pad(base_int, (0, pad_t)).reshape(n_tiles, seg_tile),
        jnp.pad(base_frac, (0, pad_t)).reshape(n_tiles, seg_tile)))
    return out.reshape(-1, max_n)[:T]


@functools.partial(jax.jit, static_argnames=("max_n", "nt", "drift", "seg_tile"))
def sinc_banded_device(sig, speeds, n, base_int, base_frac, max_n: int,
                       nt: int = 50, drift: int = 32, seg_tile: int = 32768):
    """Gather-free banded windowed-sinc varispeed resampler.

    Since restoration speeds stay near 1, the within-segment anchor drifts
    from the output index by at most ``drift`` samples.  One contiguous
    window per segment is fetched, and the 2*NT taps become ``2*(NT+drift)``
    shift-multiply-accumulate passes with no per-tap gather.  Output matches
    ``sinc_padded_device`` exactly where |anchor - k| <= drift.
    """
    if sig.ndim == 2:
        # multi-channel (C, n): identical plan, vmap the kernel over channels
        return jax.vmap(lambda ch: sinc_banded_device(
            ch, speeds, n, base_int, base_frac, max_n, nt, drift, seg_tile))(sig)
    return sinc_banded_segments(sig, speeds[:-1], speeds[1:], n, base_int,
                                base_frac, max_n, nt, drift, seg_tile)


def compact_output(padded_np, plan):
    """Host: padded (T, max_n) -> flat (n_out,) using the segment counts."""
    T, max_n = padded_np.shape
    k = np.arange(max_n)[None, :]
    mask = k < plan["n"][:, None]
    return padded_np[mask][: plan["n_out"]].astype(np.float32)


@functools.partial(jax.jit, static_argnames=("out_len",))
def compact_padded_device(padded, n, out_len: int):
    """Device compaction: padded (..., T, max_n) + segment counts ``n`` (T,)
    -> (contiguous (..., out_len), n_out scalar).

    The gather-formulated inverse of the padded grid: output sample ``j``
    lives in the last segment whose exclusive offset is <= j (binary search
    over the count cumsum), at in-segment index ``j - off[t]``.  Bit-exact
    vs the host :func:`compact_output` (it moves the same float32 values);
    entries past ``n_out`` are zero.  ``out_len`` must be a static bound on
    the output length (callers use ceil(n_in * (1 + d_bound)) + 1, the
    speed-clip contract of :func:`_fused_plan`); values of ``n`` are int32
    so the same 2**31 total-sample cap as :func:`_split_cumsum_exclusive`
    applies.  Keeps the reference's file contract (resampling.py:162-240)
    while the bulk download is the compacted take, not the padded grid.
    """
    T, max_n = padded.shape[-2:]
    csum = jnp.cumsum(n.astype(jnp.int32))
    n_out = csum[-1]
    off = jnp.concatenate([jnp.zeros(1, jnp.int32), csum[:-1]])  # seg starts
    # t(j) = last segment starting at or before j.  A binary search is
    # O(out_len * log T) of serial-dependent gathers (measured 640 ms for a
    # 30 s 192 kHz take); instead scatter each segment's index and start at
    # its start position (T tiny writes) and reconstruct with a cumulative
    # max (one bandwidth-bound scan).  Duplicate starts (zero-count
    # segments) resolve to the LAST segment via max — the searchsorted
    # "right" semantics exactly.
    t_at = jnp.zeros(out_len, jnp.int32).at[off].max(
        jnp.arange(T, dtype=jnp.int32), mode="drop")
    o_at = jnp.zeros(out_len, jnp.int32).at[off].max(off, mode="drop")
    t = jax.lax.cummax(t_at)
    j = jnp.arange(out_len, dtype=jnp.int32)
    k = jnp.clip(j - jax.lax.cummax(o_at), 0, max_n - 1)
    flat = padded.reshape(padded.shape[:-2] + (T * max_n,))
    out = jnp.where(j < n_out, flat[..., t * max_n + k], 0.0)
    return out, n_out


def _split_cumsum_exclusive(x, block: int = 1024, sub: int = 32):
    """Exclusive cumsum of positive values as an exact (int32, frac<1) pair.

    float32 loses sub-sample precision once a plain cumsum exceeds ~2^24;
    here integer parts accumulate exactly and fractional parts in TWO levels
    of small-magnitude float32 partial sums (``sub``-element runs inside
    ``block``-element blocks, floors extracted at each level), with one
    short scan over block carries.  Worst-case frac error ~2e-4 regardless
    of total magnitude, even for adversarial constant fractional parts
    (single-level blocking admitted ~0.12 at block end; round-3 property
    sweep, tests/test_restore_fused.py).

    CONTRACT: the int32 limb overflows past 2**31 ~ 2.1e9 — about 2.2 h of
    192 kHz output through the dither cumsum.  Longer takes must go through
    the streamed tier (restore_file_fast auto-routes them; its host planner
    is int64).  The sharded tier's cross-shard combine
    (parallel/sharded.py:_split_total) reproduces the block-total arithmetic
    here bit-for-bit, so shard totals match dense block totals exactly when
    the shard length is a multiple of ``block``.
    """
    T = x.shape[0]
    pad = (-T) % block
    S = block // sub
    xb = jnp.pad(x, (0, pad)).reshape(-1, S, sub)
    xi = jnp.floor(xb)
    xf = xb - xi
    # exclusive cumsums inside each sub run (frac magnitude <= sub)
    ci_in = jnp.cumsum(xi, axis=-1) - xi  # exact integers (as floats)
    cf_in = jnp.cumsum(xf, axis=-1) - xf
    cfi = jnp.floor(cf_in)
    cff = cf_in - cfi
    # sub-run totals, normalized
    s_last = cff[..., -1] + xf[..., -1]
    sti = ci_in[..., -1] + xi[..., -1] + cfi[..., -1] + jnp.floor(s_last)
    stf = s_last - jnp.floor(s_last)
    # exclusive prefix of sub-run totals inside the block (frac mag <= S)
    bti = jnp.cumsum(sti, axis=-1) - sti
    btf = jnp.cumsum(stf, axis=-1) - stf
    bfi = jnp.floor(btf)
    bff = btf - bfi
    # per-element in-block combine (block offset still zero)
    f0 = bff[..., None] + cff
    w0 = jnp.floor(f0)
    ints0 = bti[..., None] + bfi[..., None] + ci_in + cfi + w0  # exact ints
    fr0 = f0 - w0
    # block totals via the SAME formula _split_total applies to the returned
    # arrays, so the sharded combine is bit-identical to this scan's carries
    s2 = fr0[..., -1, -1] + xf[..., -1, -1]
    ti = (ints0[..., -1, -1] + xi[..., -1, -1] + jnp.floor(s2)).astype(jnp.int32)
    tf = s2 - jnp.floor(s2)

    def step(carry, tot):
        whole, frac = carry
        out = (whole, frac)
        t_i, t_f = tot
        frac = frac + t_f
        w = jnp.floor(frac)
        return (whole + t_i + w.astype(jnp.int32), frac - w), out

    _, (off_i, off_f) = jax.lax.scan(step, (jnp.int32(0), jnp.float32(0.0)), (ti, tf))
    nf = off_f[:, None, None] + fr0
    w = jnp.floor(nf)
    ints = off_i[:, None, None] + ints0.astype(jnp.int32) + w.astype(jnp.int32)
    fracs = nf - w
    return ints.reshape(-1)[:T], fracs.reshape(-1)[:T]


def _sinc_by_platform(kernel, xla, interpret: bool):
    """``kernel(interpret)`` where the program is compiled for a CUDA GPU,
    ``xla()`` elsewhere.  The choice follows the devices the program is
    lowered for (``lax.platform_dependent``), not the process's default
    backend: on a GPU host, a computation on CPU-resident arrays takes the
    XLA path.  ``interpret`` (tests) runs the kernel through the Pallas
    interpreter on any platform."""
    if interpret:
        return kernel(True)
    return jax.lax.platform_dependent(cuda=lambda: kernel(False), default=xla)


@functools.partial(jax.jit, static_argnames=("max_n", "nt", "drift",
                                              "interpret"))
def run_banded_sinc(sig_dev, speeds, n, base_int, base_frac, max_n: int,
                    nt: int, drift: int, interpret: bool = False):
    """Banded sinc of (C, n) or (n,) device signals through one plan: the
    Triton kernel on the GPU, with the channels flattened into its segment
    axis; :func:`sinc_banded_device` elsewhere."""
    def kernel(interp):
        x = sig_dev if sig_dev.ndim == 2 else sig_dev[None]
        C = x.shape[0]
        flat = _flatten_takes(
            x, jnp.broadcast_to(speeds, (C,) + speeds.shape),
            jnp.broadcast_to(n, (C,) + n.shape),
            jnp.broadcast_to(base_int, (C,) + base_int.shape),
            jnp.broadcast_to(base_frac, (C,) + base_frac.shape), max_n, nt,
            drift)
        out = _kernel_segments(flat, max_n, nt, drift, interp)
        out = out.reshape(C, -1, max_n)
        return out if sig_dev.ndim == 2 else out[0]

    return _sinc_by_platform(
        kernel, lambda: sinc_banded_device(sig_dev, speeds, n, base_int,
                                           base_frac, max_n, nt, drift),
        interpret)


@functools.partial(jax.jit, static_argnames=(
    "n_fft", "step", "zeropad", "max_n", "nt", "drift", "window_name",
    "band"))
def restore_fused_device(x, NL, NU, n_fft: int, step: int, zeropad: int,
                         max_n: int, nt: int = 50, drift: int = 64,
                         window_name: str = "blackmanharris", band=None):
    """Single-jit end-to-end restoration: STFT -> peak track -> speed curve ->
    dithered position plan -> banded sinc, with ZERO mid-pipeline host
    round-trips.

    The host plan's float64 cumsums become exact (int32 whole, float32 frac)
    scan carries: the dither ``round(cumsum(n_raw))`` and the segment base
    offsets both stay sub-sample accurate because the fractional part never
    exceeds one sample.  Output is the (T-1, max_n) padded grid (with a
    leading channel axis for 2D input); entries with k >= n_i are zero
    (mask/trim happens wherever the data lands next).

    ``x`` may be (n,) mono or (C, n) multi-channel — tracking runs on
    channel 0 and all channels resample through the shared curve
    (the reference's export contract, resampling.py:211-231).
    """
    mono = x[0] if x.ndim == 2 else x
    speeds, n, base_int, base_frac = _fused_plan(
        mono, NL, NU, n_fft, step, zeropad, max_n, nt, drift, window_name, band)
    return run_banded_sinc(x, speeds, n, base_int, base_frac, max_n, nt, drift)


@functools.partial(jax.jit, static_argnames=(
    "n_fft", "step", "zeropad", "max_n", "nt", "drift", "window_name", "band"))
def _fused_plan(mono, NL, NU, n_fft: int, step: int, zeropad: int, max_n: int,
                nt: int, drift: int, window_name: str, band, frame_mask=None,
                inv_limbs=None):
    """Device position plan: track -> clip -> dithered counts -> advances ->
    base positions.  The shared front half of ``restore_fused_device`` and
    ``restore_fused_takes`` (vmapped there)."""
    speeds = track_speed_device(mono, NL, NU, n_fft, step, zeropad, window_name,
                                band=band, frame_mask=frame_mask,
                                inv_limbs=inv_limbs)
    # enforce the banded-sinc drift contract (|anchor - k| <= drift requires
    # |1/speed - 1| <= (drift-2)/max_n): a take whose wow exceeds what the
    # static ``drift`` budgets gets a clipped curve (graceful bounded-speed
    # degradation) instead of out-of-window taps
    d_bound = min(0.9, max(drift - 2, 1) / max_n)
    speeds = jnp.clip(speeds, 1.0 / (1.0 + d_bound), 1.0 / (1.0 - d_bound))
    s_lo, s_hi = speeds[:-1], speeds[1:]
    n_raw = step * (s_lo + s_hi) / 2.0

    # dithered output counts: n_i = round(cum_i) - round(cum_{i-1}) with the
    # cumsum held as an exact (int, frac) pair (parallel, no long scan)
    ci, cf = _split_cumsum_exclusive(n_raw)
    inc_i = ci + jnp.floor(cf + n_raw).astype(jnp.int32)
    inc_f = cf + n_raw - jnp.floor(cf + n_raw)
    rounded = inc_i + (inc_f >= 0.5).astype(jnp.int32)
    n = jnp.diff(jnp.concatenate([jnp.zeros(1, jnp.int32), rounded]))
    n = jnp.clip(n, 0, max_n)

    # segment advances A_i = sum_k 1/bs, chunked to bound the (T, max_n) grid
    A = segment_advances(s_lo, s_hi, n, max_n)
    base_int, base_frac = _split_cumsum_exclusive(A)
    # Pin the plan's codegen: the enclosing program differs per sinc stage,
    # and without a barrier XLA fuses into the tracking/cumsum subgraph
    # differently per program — 1-ulp speed differences then flip dither
    # roundings (observed: programs with different sinc stages produced plans
    # differing at ~10% of segments for e.g. n=49999, shifting whole
    # segments by one sample).  The barrier isolates the plan subgraph so
    # every enclosing program compiles it identically.
    return jax.lax.optimization_barrier((speeds, n, base_int, base_frac))


def _flatten_takes(xb, speeds, nn, bi, bf, max_n: int, nt: int, drift: int):
    """Concatenate a batch of takes (with a zero guard between rows wide
    enough that no sinc window crosses into the next take) and flatten every
    per-segment plan array, offsetting anchors by the row stride.  Output
    feeds the segments-level kernels whose compiled chunk shape is then
    independent of the batch size."""
    B, n = xb.shape
    U = nt + drift
    guard = max_n + 2 * U
    R = n + guard
    sig_flat = jnp.pad(xb, ((0, 0), (0, guard))).reshape(B * R)
    offs = (jnp.arange(B, dtype=jnp.int32) * R)[:, None]
    return (sig_flat, speeds[:, :-1].reshape(-1), speeds[:, 1:].reshape(-1),
            nn.reshape(-1), (bi + offs).reshape(-1), bf.reshape(-1))


def _kernel_segments(flat, max_n: int, nt: int, drift: int, interpret: bool):
    """The Triton kernel over flattened segments (:func:`_flatten_takes`)."""
    sig_flat, s_lo, s_hi, n_flat, bi_flat, bf_flat = flat
    bs, rel, _ = segment_grids(s_lo, s_hi, n_flat, bf_flat, max_n)
    return sinc_rows(sig_flat, bi_flat - (nt + drift), bs, rel, n_flat,
                     nt=nt, drift=drift, interpret=interpret)


def _sinc_segments(flat, max_n: int, nt: int, drift: int, interpret: bool,
                   seg_tile: int = 4096):
    """Banded sinc over flattened segments: the Triton kernel on the GPU;
    elsewhere the XLA shift-MAC in fixed ``seg_tile`` chunks, so its
    compiled body does not depend on the batch size."""
    return _sinc_by_platform(
        lambda interp: _kernel_segments(flat, max_n, nt, drift, interp),
        lambda: sinc_banded_segments(*flat, max_n, nt, drift,
                                     seg_tile=seg_tile, force_chunk=True),
        interpret)


@functools.partial(jax.jit, static_argnames=(
    "n_fft", "step", "zeropad", "max_n", "nt", "drift", "window_name",
    "band", "interpret"))
def _restore_fused_takes_jit(xb, NLb, NUb, lengths, inv_limbs, n_fft: int,
                             step: int, zeropad: int, max_n: int, nt: int,
                             drift: int, window_name: str, band,
                             interpret: bool):
    B, N = xb.shape

    if lengths is None:
        xt = xb
        xs = xb
        fmasks = invs = None
    else:
        # per-take boundary regeneration so a PADDED row is indistinguishable
        # from its solo restore: tracking windows that
        # cross the take's real end must see the solo path's reflect pad —
        # not the batch pad — and sinc taps past the end must read zero
        # (sinc_banded_segments' own out-of-range convention).
        pos = jnp.arange(N, dtype=jnp.int32)

        def reflect_row(x1, L):
            src = jnp.where(pos < L, pos,
                            jnp.clip(2 * (L - 1) - pos, 0, N - 1))
            return x1[src]

        xt = jax.vmap(reflect_row)(xb, lengths)
        xs = jnp.where(pos[None, :] < lengths[:, None], xb, 0.0)
        F = N // step + 1
        fmasks = (jnp.arange(F, dtype=jnp.int32)[None, :]
                  <= (lengths // step)[:, None]).astype(jnp.float32)
        invs = inv_limbs

    def one_take(x1, nl, nu, fmask, inv3):
        return _fused_plan(x1, nl, nu, n_fft, step, zeropad, max_n, nt,
                           drift, window_name, band, frame_mask=fmask,
                           inv_limbs=inv3)

    if fmasks is None:
        plan = jax.vmap(lambda x1, nl, nu: one_take(x1, nl, nu, None, None))(
            xt, NLb, NUb)
    else:
        plan = jax.vmap(one_take)(xt, NLb, NUb, fmasks, invs)
    speeds, nn, bi, bf = plan
    flat = _flatten_takes(xs, speeds, nn, bi, bf, max_n, nt, drift)
    out = _sinc_segments(flat, max_n, nt, drift, interpret)
    return out.reshape(B, -1, max_n)


def restore_fused_takes(xb, NLb, NUb, n_fft: int, step: int, zeropad: int,
                        max_n: int, nt: int = 50, drift: int = 64,
                        window_name: str = "blackmanharris", band=None,
                        lengths=None, interpret: bool = False):
    """Batch of INDEPENDENT takes in one dispatch: each row of ``xb``
    (B, n) tracks its OWN speed curve and resamples through it.

    Contrast with ``restore_fused_device``'s 2D input, where dim 0 is the
    CHANNELS of one take sharing channel 0's curve (the reference's export
    contract).  Here dim 0 is separate recordings — the serving shape for a
    digitization batch on one chip, amortizing the dispatch floor the same
    way the multi-track path does.  ``NLb``/``NUb``: (B, n_frames) per-take
    band limits.  Returns (B, T-1, max_n) padded grids.

    ``lengths``: optional (B,) real sample counts for a MIXED-LENGTH batch
    (rows zero- or arbitrarily padded to the common N).  Each take is then
    restored EXACTLY as its solo ``restore_fused_device`` run would: the
    tracking input is reflect-regenerated at the take boundary on device,
    the TraceLine centering mean runs over the take's own frames only
    (markers.py:190-192 — the mean is over the take, not the pad), and sinc
    taps past the end read zero.  The first ``length//step`` output segments
    are bit-identical to the solo restore; the rest is pad to discard.
    Lengths ride as DATA (with host-precomputed 1/count factors), so one
    compiled program serves every length mix.

    Compile-once design: the plan runs as a ``vmap``
    over takes and the batch then FLATTENS into the kernel's segment axis
    (zero guard bands between takes), always chunked at a fixed
    ``seg_tile`` on the CPU — so the compiled XLA inner map body is
    byte-identical for every B and only the cheap outer trace re-runs when
    the batch size changes.  On the GPU the kernel's grid follows the
    segment count.  ``interpret`` (tests) runs the kernel through the Pallas
    interpreter on any platform.
    """
    inv = None
    if lengths is not None:
        lengths_h = np.asarray(lengths, np.int64)
        inv = jnp.asarray(inv_count_limbs(lengths_h // step + 1))
        lengths = jnp.asarray(lengths_h, jnp.int32)
    return _restore_fused_takes_jit(xb, NLb, NUb, lengths, inv, n_fft, step,
                                    zeropad, max_n, nt, drift, window_name,
                                    band, interpret)


def _band_limits(f0_hz, tolerance_st, fft_size, zeropad, sr):
    """Fixed NL/NU bin band around a target frequency (semitone tolerance)."""
    num_bins = fft_size * zeropad // 2 + 1
    tol = tolerance_st / 12.0
    NL = max(1, min(num_bins - 1,
                    int(round(max(1.0, f0_hz * 2 ** -tol) * fft_size * zeropad / sr))))
    NU = max(1, min(num_bins - 1,
                    int(round(min(sr / 2, f0_hz * 2 ** tol) * fft_size * zeropad / sr))))
    return NL, NU


def _probe_f0(x, sr):
    """Strongest-bin pilot-tone probe over the first ~2^18 samples."""
    probe = np.asarray(x[: min(len(x), 1 << 18)], dtype=np.float32)
    spec = np.abs(np.fft.rfft(probe * np.hanning(len(probe))))
    return float(np.argmax(spec[10:]) + 10) / len(probe) * sr


def restore_file_streamed(audio_path, f0_hz=None, tolerance_st: float = 1.0,
                          fft_size: int = 4096, fft_overlap: int = 8,
                          zeropad: int = 2, sinc_quality: int = 50,
                          suffix: str = "", channel: int = 0, use_channels=None,
                          frames_per_block: int = 65536, seg_tile: int = 16384,
                          resume: bool = True, speed_curve=None, timings=None):
    """Larger-than-memory wow/flutter fix: two streamed passes over the file.

    Pass 1 reads ``frames_per_block``-frame sample spans via the native
    StreamReader and tracks peaks per span — frame-exact vs the in-memory
    path because the masked-peak tracker is frame-local (the halo a frame
    needs is read with the span, reference blockwise pattern:
    experiments/pyrespeeder_cmd.py:16-49).  The frame-rate speed curve and
    the position plan are the only whole-recording state held in memory
    (~16 bytes/frame).  Pass 2 resamples ``seg_tile`` segments at a time
    from a re-read input window and appends to a StreamWriter, so peak host
    memory is one block regardless of recording length.

    Checkpoint/resume (``resume=True``): the pass-1 speed curve persists to
    ``<out>.speeds.npz`` keyed by the input's identity and the tracking
    config, so a multi-hour job interrupted in pass 2 restarts WITHOUT
    re-tracking; the sidecar is removed after a successful write.

    ``speed_curve``: optional frame-rate speeds (``n//hop + 1`` values) that
    SKIP tracking entirely — streamed project replay (a saved master curve
    over a larger-than-memory take) and constant-ratio resampling both ride
    this.

    ``timings``: optional dict the call populates with per-pass wall times
    (``pass1_s`` tracking, ``plan_s`` host planning, ``pass2_s``
    resample+write) plus ``n``/``sr``/``n_out``.
    """
    import time as _time

    from ..utils import audio_io

    if timings is None:
        timings = {}

    hop = fft_size // fft_overlap
    nt = int(sinc_quality)
    with audio_io.StreamReader(audio_path) as reader:
        sr, num_channels = reader.sample_rate, reader.channels
        n = int(reader.frames)
        channels = list(use_channels) if use_channels else list(range(num_channels))
        if f0_hz is None:
            f0_hz = _probe_f0(reader.read(0, min(n, 1 << 18))[:, channel], sr)
        NL, NU = _band_limits(f0_hz, tolerance_st, fft_size, zeropad, sr)
        pad = fft_size // 2
        n_frames = (n + 2 * pad - fft_size) // hop + 1
        frames_per_block = min(frames_per_block, n_frames)
        out_base = f"{os.path.splitext(audio_path)[0]}_res{suffix}"
        ckpt_path = f"{out_base}.speeds.npz"
        # key includes the input's identity (size + mtime_ns), not just its
        # geometry — a replaced file with identical frame count must NOT
        # resume pass 2 from the previous file's speed curve.
        st = os.stat(audio_path)
        ckpt_key = np.asarray([n, num_channels, sr, fft_size, hop, zeropad,
                               NL, NU, channel, st.st_size, st.st_mtime_ns],
                              np.int64)

        speeds = None
        if speed_curve is not None:
            speeds = np.asarray(speed_curve, np.float64)
            assert len(speeds) == n_frames, (len(speeds), n_frames)
            resume = False  # nothing expensive to checkpoint
        if resume and os.path.exists(ckpt_path):
            try:
                ck = np.load(ckpt_path)
                if np.array_equal(ck["key"], ckpt_key):
                    speeds = ck["speeds"]
                    import logging

                    logging.info(f"Resuming pass 2 from {ckpt_path}")
            except Exception:
                pass
        if speeds is None:
            # ---- pass 1: streamed banded peak tracking (frame-exact)
            _t0 = _time.perf_counter()
            NLs = jnp.full((frames_per_block,), NL, jnp.int32)
            NUs = jnp.full((frames_per_block,), NU, jnp.int32)
            span_need = (frames_per_block - 1) * hop + fft_size
            refined_parts = []
            t_read = t_dev = 0.0
            for t0 in range(0, n_frames, frames_per_block):
                t1 = min(n_frames, t0 + frames_per_block)
                lo = t0 * hop - pad
                hi = (t1 - 1) * hop - pad + fft_size
                rlo, rhi = max(0, lo), min(n, hi)
                _tr = _time.perf_counter()
                blk = reader.read(rlo, rhi - rlo)[:, channel].astype(np.float32)
                t_read += _time.perf_counter() - _tr
                if lo < 0 or hi > n:  # reflect only at the true file edges
                    blk = np.pad(blk, (rlo - lo, hi - rhi), mode="reflect")
                blk = np.pad(blk, (0, span_need - len(blk)))
                _td = _time.perf_counter()
                refined = np.asarray(track_peaks_span(
                    jnp.asarray(blk), NLs, NUs, frames_per_block, fft_size, hop,
                    zeropad, band=(NL - 1, NU + 1)))
                t_dev += _time.perf_counter() - _td
                refined_parts.append(refined[: t1 - t0])
            timings["pass1_read_s"] = t_read
            timings["pass1_device_s"] = t_dev  # incl. block upload + curve download
            speeds = np.asarray(normalize_speeds(
                jnp.asarray(np.concatenate(refined_parts)),
                center=log_center_for_band((NL - 1, NU + 1))))
            if resume:
                np.savez(ckpt_path, key=ckpt_key, speeds=speeds)
            timings["pass1_s"] = _time.perf_counter() - _t0

        # ---- global position plan (host, frame-rate sized)
        _t0 = _time.perf_counter()
        plan = plan_positions_fast(speeds, hop, n)
        drift = 8
        while drift < plan["drift"]:
            drift *= 2
        U = nt + drift
        max_n = int(plan["max_n"])
        T = len(plan["n"])
        speeds32 = speeds.astype(np.float32)
        out_path = out_base + "." + audio_io.out_ext()

        # ---- pass 2: tile the segment axis, re-read input windows, append.
        # The read span is padded to a FIXED length so the device kernel
        # compiles once for the whole file (per-tile anchor spreads vary by a
        # few samples; zeros beyond the real span are never inside a window)
        bi_all = plan["base_int"]
        span_fix = max(
            int(bi_all[min(T, a + seg_tile) - 1]) - int(bi_all[a])
            for a in range(0, T, seg_tile)) + max_n + 2 * U + 2
        timings["plan_s"] = _time.perf_counter() - _t0
        timings.update(n=n, sr=sr, n_out=int(plan["n_out"]))
        _t0 = _time.perf_counter()
        written = 0
        t_read = t_dev = t_write = 0.0
        with audio_io.open_writer(out_path, sr, len(channels)) as writer:
            for a in range(0, T, seg_tile):
                b = min(T, a + seg_tile)
                nseg = b - a
                lo = int(plan["base_int"][a]) - U
                hi = int(plan["base_int"][b - 1]) + max_n + U + 2
                rlo, rhi = max(0, lo), min(n, hi)
                _tr = _time.perf_counter()
                buf = reader.read(rlo, rhi - rlo)[:, channels]  # (span, C)
                t_read += _time.perf_counter() - _tr
                pad_s = span_fix - buf.shape[0]
                if pad_s > 0:
                    buf = np.pad(buf, ((0, pad_s), (0, 0)))
                _td = _time.perf_counter()
                sig_dev = jnp.asarray(np.ascontiguousarray(buf.T))
                n_t = np.zeros(seg_tile, np.int32)
                n_t[:nseg] = plan["n"][a:b]
                bi_t = np.zeros(seg_tile, np.int32)
                bi_t[:nseg] = plan["base_int"][a:b] - rlo
                bf_t = np.zeros(seg_tile, np.float32)
                bf_t[:nseg] = plan["base_frac"][a:b]
                s_t = np.ones(seg_tile + 1, np.float32)
                s_t[: nseg + 1] = speeds32[a: b + 1]
                padded = np.asarray(run_banded_sinc(
                    sig_dev, jnp.asarray(s_t), jnp.asarray(n_t),
                    jnp.asarray(bi_t), jnp.asarray(bf_t), max_n, nt, drift))
                t_dev += _time.perf_counter() - _td
                mask = np.arange(max_n)[None, :] < n_t[:, None]
                tile_out = np.stack([padded[c][mask]
                                     for c in range(len(channels))], axis=-1)
                _tw = _time.perf_counter()
                take = min(len(tile_out), plan["n_out"] - written)
                writer.write(tile_out[:take])
                t_write += _time.perf_counter() - _tw
                written += take
                if written >= plan["n_out"]:
                    break
        timings["pass2_s"] = _time.perf_counter() - _t0
        timings["pass2_read_s"] = t_read
        timings["pass2_device_dl_s"] = t_dev  # device compute + download
        timings["pass2_write_s"] = t_write
    if resume and os.path.exists(ckpt_path):
        os.remove(ckpt_path)  # success: the checkpoint has served its purpose
    import logging

    logging.info(f"Wrote {out_path}")
    return out_path


def restore_file_fast(audio_path, f0_hz=None, tolerance_st: float = 1.0,
                      fft_size: int = 4096, fft_overlap: int = 8, zeropad: int = 2,
                      sinc_quality: int = 50, suffix: str = "", channel: int = 0,
                      use_channels=None, stream="auto",
                      stream_threshold_bytes: int = 1 << 30):
    """File-to-file wow/flutter fix through the device pipeline.

    Tracks on ``channel``, resamples all ``use_channels`` (default: all)
    through the shared speed curve — the reference's multi-channel export
    contract (resampling.py:211-231).  Auto-detects the pilot tone when
    ``f0_hz`` is None.  Returns the output path.

    ``stream``: True forces the two-pass larger-than-memory path
    (:func:`restore_file_streamed`); "auto" switches to it when the DECODED
    size (header frames x channels x 4 bytes — container bytes undercount
    FLAC by 4-6x) exceeds ``stream_threshold_bytes``.
    """
    from ..utils import audio_io, streaming

    # the fused device plan carries int32 sample counts (2.1e9 cap,
    # _split_cumsum_exclusive contract); takes that could exceed it stream
    # unconditionally through the int64 host planner
    int32_guard = streaming.decoded_bytes(audio_path) // 4 > (1 << 31) // 2
    if int32_guard or streaming.should_stream(audio_path, stream,
                                              stream_threshold_bytes):
        return restore_file_streamed(
            audio_path, f0_hz=f0_hz, tolerance_st=tolerance_st,
            fft_size=fft_size, fft_overlap=fft_overlap, zeropad=zeropad,
            sinc_quality=sinc_quality, suffix=suffix, channel=channel,
            use_channels=use_channels)

    signal, sr, num_channels = audio_io.read_file(audio_path)
    channels = list(use_channels) if use_channels else list(range(num_channels))
    x = signal[:, channel]
    if f0_hz is None:
        f0_hz = _probe_f0(x, sr)
    hop = fft_size // fft_overlap
    n = len(x)
    NL, NU = _band_limits(f0_hz, tolerance_st, fft_size, zeropad, sr)
    n_frames = (n + (fft_size // 2) * 2 - fft_size) // hop + 1
    NLs = jnp.full((n_frames,), NL, jnp.int32)
    NUs = jnp.full((n_frames,), NU, jnp.int32)
    speeds = np.asarray(track_speed_device(jnp.asarray(x), NLs, NUs, fft_size,
                                           hop, zeropad,
                                           band=(NL - 1, NU + 1)))
    plan = plan_positions_fast(speeds, hop, n)
    drift = 8
    while drift < plan["drift"]:
        drift *= 2
    sig_dev = jnp.asarray(np.ascontiguousarray(signal[:, channels].T))  # (C, n)
    padded = run_banded_sinc(
        sig_dev, jnp.asarray(speeds.astype(np.float32)), jnp.asarray(plan["n"]),
        jnp.asarray(plan["base_int"]), jnp.asarray(plan["base_frac"]),
        int(plan["max_n"]), int(sinc_quality), drift)
    # compact on device (bit-exact gather, tests/test_restore_fused.py) and
    # download the interleaved take directly: the host never touches the
    # padded grid and the transfer shrinks to the actual output
    out_dev, _ = compact_padded_device(padded, jnp.asarray(plan["n"]),
                                       int(plan["n_out"]))
    out = np.asarray(jnp.transpose(out_dev))
    return audio_io.write_file(audio_path, out, sr, len(channels),
                               suffix=f"_res{suffix}")


def restore_device(sig_dev, sr: int, f0_hz: float, tolerance_st: float = 1.0,
                   fft_size: int = 4096, fft_overlap: int = 8, zeropad: int = 2,
                   sinc_quality: int = 50):
    """Full device-resident restoration around a fixed target frequency.

    Returns (padded_out_device, plan).  Only ~100 KB crosses the host
    boundary (the frame-rate speed curve + the position plan).
    """
    hop = fft_size // fft_overlap
    n = int(sig_dev.shape[0])
    n_frames = (n + (fft_size // 2) * 2 - fft_size) // hop + 1
    NL, NU = _band_limits(f0_hz, tolerance_st, fft_size, zeropad, sr)
    NLs = jnp.full((n_frames,), NL, jnp.int32)
    NUs = jnp.full((n_frames,), NU, jnp.int32)
    speeds = track_speed_device(sig_dev, NLs, NUs, fft_size, hop, zeropad,
                                band=(NL - 1, NU + 1))
    speeds_np = np.asarray(speeds)  # ~T floats, the only mid-pipe download
    plan = plan_positions_fast(speeds_np, hop, n)
    # bucket the drift bound so jit caches stay warm across takes
    drift = 8
    while drift < plan["drift"]:
        drift *= 2
    padded = run_banded_sinc(
        sig_dev, jnp.asarray(speeds_np.astype(np.float32)),
        jnp.asarray(plan["n"]), jnp.asarray(plan["base_int"]),
        jnp.asarray(plan["base_frac"]), int(plan["max_n"]), int(sinc_quality),
        drift)
    return padded, plan
