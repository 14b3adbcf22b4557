"""Variable-speed windowed-sinc resampling on the device.

Reference: util/resampling.py — ``speed_to_pos`` (speed curve -> fractional
sample positions with error dithering, resampling.py:93-137), lag-curve
positions (resampling.py:189-206), and the windowed-sinc interpolator with
per-sample anti-aliasing cutoff (``sinc_core``, resampling.py:51-90), which
the reference parallelizes with a manual thread pool over numba kernels.

Device-first design
-------------------
* Position generation runs on the host in float64: positions reach 1e7+
  samples and float32 cannot hold sub-sample precision at that magnitude.
  The reference's sequential error-dithering loop collapses to a closed form
  ``n_i = round(cumsum(n_raw))_i - round(cumsum(n_raw))_{i-1}``, making the
  whole curve a vectorized cumsum.
* Positions ship to the device split as ``(int32 anchor, float32 shift)`` —
  an exact decomposition — plus a per-sample cutoff ``fc``.
* The interpolation is a batched gather + weighted reduction, tiled with
  ``lax.map`` so the (tile, taps) working set stays bounded in device
  memory; XLA fuses the window/sinc weight computation into the reduction.
  The wow/flutter fast path resamples through the banded formulation
  instead (``pipelines/respeeder_device``, ``kernels/sinc_triton``).

Tap convention: the reference's interior loop takes 2*NT taps (j in
[-NT, NT)): ``upper = min(ind + NT, len)`` excludes the final tap
(resampling.py:71-72, 89-90).  We reproduce that exactly so interior output
is bit-comparable; at the signal edges we zero-mask out-of-range taps instead
of replicating the reference's slice-misalignment quirk.
"""

from __future__ import annotations

import functools
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import audio_io
from ..utils.timing import log_duration

__all__ = [
    "speed_to_pos", "lag_to_pos", "sinc_resample", "linear_resample",
    "resample_ratio", "run",
]


def speed_to_pos(sampletimes, speeds, num_input_samples):
    """Convert a speed curve to output-sample positions (host float64).

    ``sampletimes``: sample indices where ``speeds`` is sampled (evenly
    spaced); returns positions into the input signal for every output sample,
    trimmed at the end of the input (resampling.py:93-137).
    """
    sampletimes = np.asarray(sampletimes, dtype=np.float64)
    speeds = np.asarray(speeds, dtype=np.float64)
    periods = np.diff(sampletimes)
    # target output counts per segment before dithering
    n_raw = periods * (speeds[:-1] + speeds[1:]) / 2.0
    # the reference's error-dithering loop == differenced rounded cumsum
    cum = np.cumsum(n_raw)
    n = np.diff(np.round(np.concatenate([[0.0], cum]))).astype(np.int64)
    n = np.maximum(n, 0)
    total = int(n.sum())
    if total <= 0:
        return np.empty(0, dtype=np.float64)
    # per-output-sample segment id and index within the segment
    seg = np.repeat(np.arange(len(n)), n)
    starts = np.concatenate([[0], np.cumsum(n)[:-1]])
    k = np.arange(total) - starts[seg]
    denom = np.maximum(n[seg] - 1, 1).astype(np.float64)
    block_speeds = k / denom * (speeds[seg + 1] - speeds[seg]) + speeds[seg]
    positions = np.cumsum(1.0 / block_speeds) + sampletimes[0]
    # trim where the input signal ends (nearest position to the end)
    inside = positions <= num_input_samples
    if not inside.all():
        end = int(np.argmin(np.abs(positions - num_input_samples)))
        positions = positions[:end]
    return positions


def lag_to_pos(sampletimes, lags, num_input_samples):
    """Lag curve -> positions (resampling.py:189-206 inline logic)."""
    sampletimes = np.asarray(sampletimes, dtype=np.float64)
    lags = np.asarray(lags, dtype=np.float64)
    num_output_samples = int(num_input_samples + abs(lags[-1]))
    sample_at = np.interp(np.arange(num_output_samples), sampletimes, sampletimes - lags)
    over = np.nonzero(sample_at >= num_input_samples)[0]
    if len(over):
        sample_at = sample_at[:over[0]]
    return np.clip(sample_at, 0, None)


@functools.lru_cache(maxsize=16)
def _sinc_window(nt: int) -> np.ndarray:
    # reference: np.hanning(2*NT+1), of which only the first 2*NT taps are used
    return np.hanning(2 * nt + 1)[: 2 * nt].astype(np.float32)


@functools.partial(jax.jit, static_argnames=("nt", "tile"))
def _sinc_device(sig, ind, shift, fc, nt: int, tile: int):
    """Tiled gather + windowed-sinc MAC. ind/shift/fc are padded to tiles."""
    n_in = sig.shape[0]
    offs = np.arange(-nt, nt, dtype=np.int32)
    win = jnp.asarray(_sinc_window(nt))

    def one_tile(args):
        ind_t, shift_t, fc_t = args
        idx = ind_t[:, None] + offs[None, :]
        valid = (idx >= 0) & (idx < n_in)
        g = sig[jnp.clip(idx, 0, n_in - 1)]
        x = (offs[None, :].astype(jnp.float32) - shift_t[:, None]) * fc_t[:, None]
        w = jnp.sinc(x) * fc_t[:, None] * win[None, :]
        return jnp.sum(jnp.where(valid, g * w, 0.0), axis=-1)

    n_tiles = ind.shape[0] // tile
    out = jax.lax.map(one_tile, (
        ind.reshape(n_tiles, tile),
        shift.reshape(n_tiles, tile),
        fc.reshape(n_tiles, tile),
    ))
    return out.reshape(-1)


def _positions_to_device_args(sample_at):
    """Split float64 positions into exact (int32 anchor, float32 shift) + fc."""
    sample_at = np.asarray(sample_at, dtype=np.float64)
    ind = np.round(sample_at).astype(np.int64)
    shift = (sample_at - ind).astype(np.float32)
    period = np.diff(sample_at)
    if len(period):
        period = np.concatenate([period, period[-1:]])  # last fc reuses previous period
    else:
        period = np.ones(len(sample_at))
    fc = np.minimum(1.0 / np.maximum(period, 1e-12), 1.0).astype(np.float32)
    return ind.astype(np.int32), shift, fc


@functools.partial(jax.jit, static_argnames=("nt", "drift", "block"))
def _sinc_banded_blocks(sig, anchors, rel, fc, nt: int, drift: int, block: int):
    """Gather-free banded sinc over fixed-size output blocks.

    ``anchors``: (n_blocks,) int32 input anchor per block; ``rel``: (n_blocks,
    block) float32 positions relative to the anchor; ``fc``: per-sample
    cutoff.  The taps become 2*(nt+drift) static shifted MAC passes with
    no per-tap gather (see pipelines/respeeder_device.py).
    """
    n_in = sig.shape[0]
    U = nt + drift
    L = block + 2 * U
    k = jnp.arange(block, dtype=jnp.int32)[None, :]
    ind_local = jnp.round(rel).astype(jnp.int32)
    shift = rel - ind_local
    m = ind_local - k
    start = anchors - U
    idx = start[:, None] + np.arange(L)[None, :]
    buf = jnp.where((idx >= 0) & (idx < n_in), sig[jnp.clip(idx, 0, n_in - 1)], 0.0)

    def body(v, out):
        jj = (v - U) - m
        valid = (jj >= -nt) & (jj < nt)
        jf = jj.astype(jnp.float32)
        x = (jf - shift) * fc
        hann = 0.5 - 0.5 * jnp.cos(np.pi * (jf + nt) / nt)
        w = jnp.where(valid, jnp.sinc(x) * fc * hann, 0.0)
        seg = jax.lax.dynamic_slice_in_dim(buf, v, block, axis=1)
        return out + seg * w

    return jax.lax.fori_loop(0, 2 * U, body,
                             jnp.zeros(rel.shape, jnp.float32))


def sinc_resample(signal, sample_at, quality: int = 50, tile: int = 16384,
                  block: int = 512, max_band_drift: int = 192,
                  device_out: bool = False):
    """Windowed-sinc resample of a 1D signal at float64 positions.

    ``quality`` is the reference's ``sinc_quality`` NT (resampling.py:21-27).
    Returns a float32 array of len(sample_at).

    Auto-kernel selection: when positions advance near-monotonically with a
    bounded in-block excursion (speed curves near 1, lag curves), the
    gather-free banded kernel runs; otherwise (large resampling ratios) the
    tiled-gather kernel does.

    ``device_out=True`` returns the jax device array instead of downloading —
    for callers that feed the result straight into the next device op (e.g.
    tapesynch's resample -> band-pass -> correlate chain, which then makes
    no intermediate host round trip).
    """
    n_out = len(sample_at)
    if isinstance(signal, jax.Array):
        signal = signal.astype(jnp.float32)  # already on device: no download
    else:
        signal = np.asarray(signal, dtype=np.float32)
    was_1d = signal.ndim == 1
    if was_1d:
        signal = signal[:, None]
    if n_out == 0:
        out = np.empty((0, signal.shape[1]), np.float32)
        return out[:, 0] if was_1d else out
    sig = jnp.asarray(signal)
    sample_at = np.asarray(sample_at, dtype=np.float64)

    # exact (anchor, shift) split + per-sample cutoff from the *unpadded*
    # positions, the last period reused (reference convention, resampling.py:71)
    ind, shift, fc = _positions_to_device_args(sample_at)

    # try the banded layout: per-block anchors + small relative positions
    n_blocks = -(-n_out // block)
    grid_pad = n_blocks * block - n_out
    padded = np.pad(sample_at, (0, grid_pad), mode="edge")
    pos_b = padded.reshape(n_blocks, block)
    anchors = np.round(pos_b[:, 0]).astype(np.int64)
    rel = pos_b - anchors[:, None]
    drift_needed = int(np.ceil(np.abs(np.round(rel) - np.arange(block)[None, :]).max())) + 1
    if drift_needed <= max_band_drift:
        drift = 8
        while drift < drift_needed:
            drift *= 2
        fc_b = np.pad(fc, (0, grid_pad), constant_values=1.0).reshape(n_blocks, block)
        args = (jnp.asarray(anchors.astype(np.int32)),
                jnp.asarray(rel.astype(np.float32)), jnp.asarray(fc_b))
        out = jax.vmap(
            lambda s: _sinc_banded_blocks(s, *args, int(quality), drift, int(block)),
            in_axes=1, out_axes=-1)(sig)
        out = out.reshape(-1, sig.shape[1])[:n_out]
        if not device_out:
            out = np.asarray(out)
        return out[:, 0] if was_1d else out

    pad = (-n_out) % tile
    if pad:
        ind = np.pad(ind, (0, pad))
        shift = np.pad(shift, (0, pad))
        fc = np.pad(fc, (0, pad), constant_values=1.0)
    args = (jnp.asarray(ind), jnp.asarray(shift), jnp.asarray(fc))
    out = jax.vmap(lambda s: _sinc_device(s, *args, int(quality), int(tile)),
                   in_axes=1, out_axes=-1)(sig)
    out = out[:n_out]
    if not device_out:
        out = np.asarray(out)
    return out[:, 0] if was_1d else out


@functools.partial(jax.jit, static_argnames=())
def _linear_device(sig, ind, frac):
    n_in = sig.shape[0]
    lo = jnp.clip(ind, 0, n_in - 1)
    hi = jnp.clip(ind + 1, 0, n_in - 1)
    # reference uses np.interp(..., left=0, right=0)
    inside = (ind >= 0) & (ind <= n_in - 1)
    exact_end = (ind == n_in - 1) & (frac == 0)
    keep = inside & ((ind < n_in - 1) | exact_end)
    if sig.ndim > 1:
        frac, keep = frac[:, None], keep[:, None]
    out = sig[lo] * (1.0 - frac) + sig[hi] * frac
    return jnp.where(keep, out, 0.0)


def linear_resample(signal, sample_at):
    """Linear-interpolation resampling, matching np.interp(left=0, right=0).

    ``signal`` may be 1D (time,) or 2D (time, channels); channels are
    interpolated in ONE device call.
    """
    sample_at = np.asarray(sample_at, dtype=np.float64)
    ind = np.floor(sample_at).astype(np.int64)
    frac = (sample_at - ind).astype(np.float32)
    sig = jnp.asarray(np.asarray(signal, dtype=np.float32))
    out = _linear_device(sig, jnp.asarray(ind.astype(np.int32)), jnp.asarray(frac))
    return np.asarray(out)


def resample_ratio(signal, sr_from, sr_to, quality: int = 16, axis: int = 0,
                   device_out: bool = False):
    """Constant-ratio resampler (replaces resampy.resample usages).

    signal may be 1D or 2D; ``axis`` is the time axis.  All channels resample
    in a single vmapped device call (no per-channel host sync).
    ``device_out=True`` keeps the result on device (see sinc_resample).
    """
    is_dev = isinstance(signal, jax.Array)
    if not is_dev:
        signal = np.asarray(signal)
    ratio = float(sr_from) / float(sr_to)
    n_out = int(round(signal.shape[axis] / ratio))
    sample_at = np.arange(n_out, dtype=np.float64) * ratio
    if signal.ndim == 1:
        return sinc_resample(signal, sample_at, quality=quality,
                             device_out=device_out)
    xp = jnp if is_dev else np
    moved = xp.moveaxis(signal, axis, 0)
    out = sinc_resample(moved, sample_at, quality=quality,
                        device_out=device_out)
    return jnp.moveaxis(out, 0, axis) if device_out else np.moveaxis(out, 0, axis)


def run(filenames, signal_data=None, speed_curve=None, resampling_mode="Linear",
        sinc_quality=50, use_channels=(), prog_sig=None, lag_curve=None, suffix=""):
    """Batch resample driver mirroring the reference's ``run`` contract
    (resampling.py:162-240): writes ``<name>_res<suffix>.<ext>`` per input
    (extension from :func:`audio_io.set_output_format`, default wav).
    Returns the list of output paths.
    """
    def progress(pct):
        # prog_sig mirrors the reference's notifyProgress signal contract
        # (resampling.py:165-168); plain callables are accepted too
        if prog_sig is None:
            return
        emit = getattr(getattr(prog_sig, "notifyProgress", None), "emit", None)
        (emit or prog_sig)(pct)

    progress(0)
    out_paths = []
    if signal_data is None:
        signal_data = [None for _ in filenames]
    for filename, sig_data in zip(filenames, signal_data):
        with log_duration("Preparing"):
            logging.info(f"Resampling '{os.path.basename(filename)}'... "
                         f"{resampling_mode}, {sinc_quality}, {use_channels}")
            if sig_data:
                signal, sr = sig_data
                num_channels = signal.shape[1]
            else:
                signal, sr, num_channels = audio_io.read_file(filename)
            if speed_curve is not None:
                sampletimes = np.asarray(speed_curve)[:, 0] * sr
                speeds = np.asarray(speed_curve)[:, 1]
                sample_at = speed_to_pos(sampletimes, speeds, len(signal))
            elif lag_curve is not None:
                sampletimes = np.asarray(lag_curve)[:, 0] * sr
                lags = np.asarray(lag_curve)[:, 1] * sr
                sample_at = lag_to_pos(sampletimes, lags, len(signal))
            else:
                raise ValueError("need speed_curve or lag_curve")
        channels = [c for c in use_channels if c < signal.shape[1]] or list(range(num_channels))
        # progress milestones are per stage+file rather than the reference's
        # per-channel ticks (resampling.py:230-231): channels resample in ONE
        # vmapped device call here, so there is no per-channel point left
        fi = len(out_paths)
        n_files = len(filenames)
        progress(int((fi + 0.25) / n_files * 100))
        with log_duration("Resampling"):
            # all channels in one vmapped device call (the reference fans a
            # thread pool over channels+chunks, resampling.py:30-46)
            sel = signal[:, channels]
            if resampling_mode == "Sinc":
                output = sinc_resample(sel, sample_at, quality=sinc_quality)
            else:
                output = linear_resample(sel, sample_at)
            progress(int((fi + 0.85) / n_files * 100))
        with log_duration("Writing"):
            # write_file honours set_output_format (--flac-out), unlike a
            # hard-coded .wav path
            out_path = audio_io.write_file(filename, np.asarray(output), sr,
                                           suffix=f"_res{suffix}")
            out_paths.append(out_path)
            progress(int(len(out_paths) / n_files * 100))
    logging.info("Done!")
    return out_paths
