"""Sub-sample spectral-temporal alignment of two recordings
(reference tool: pytapesynch_gui.py).

Pipeline: lag markers (manual or auto-placed) -> windowed band-passed
cross-correlation refinement (``correlate_sources``,
pytapesynch_gui.py:108-133) -> spline lag curve with azimuth-sweep overrides
(markers.py:730-794) -> lag-curve resample of the source.

Device-first: the azimuth sweep correlates all windows in one batched jit call
(the reference loops windows in Python, pytapesynch_gui.py:231-235); the
speed-ratio estimator cross-correlates log2-spaced average spectra on device.
"""

from __future__ import annotations

import logging

import jax.numpy as jnp
import numpy as np

from ..models import markers as mk
from ..ops import correlation, filters, fourier, resampling
from ..utils import audio_io

__all__ = [
    "get_signal", "get_signal_around", "correlate_sources", "improve_lag",
    "azimuth_sweep", "estimate_speed_ratio", "auto_align", "align_files",
    "get_speed_at",
]


def get_signal(signal, sr, t0, t1, channel=0):
    """Zero-padded slice [t0, t1) of one channel (spectrum.py:153-171)."""
    sig = signal[:, channel] if signal.ndim == 2 else signal
    s0 = int(t0 * sr)
    s1 = int(t1 * sr)
    pad_l = max(0, -s0)
    pad_r = max(0, s1 - len(sig))
    piece = sig[max(0, s0):min(len(sig), s1)]
    return np.pad(piece, (pad_l, pad_r))


def get_signal_around(signal, sr, t, width, channel=0):
    return get_signal(signal, sr, t - width, t + width, channel)


def get_speed_at(lag_data, marker_sr, t, width=0.05):
    """Local source-speed estimate from the lag-curve derivative
    (pytapesynch_gui.py:175-192)."""
    # host on purpose: the lag curve is frame-rate sized (a few hundred
    # points); scipy f64 here is cheaper than a device round-trip and
    # bit-matches the reference's curve smoothing (pytapesynch_gui.py:180)
    filtered = np.asarray(filters.butter_bandpass_filter(
        lag_data[:, 1], 0, 15, marker_sr, order=3, backend="host"))
    before = np.interp(t - width, lag_data[:, 0], filtered)
    after = np.interp(t + width, lag_data[:, 0], filtered)
    speed = (after - before) / (2 * width) + 1.0
    return speed


def correlate_sources(ref_signal, src_signal, sr, t0, t1, delay, lower, upper,
                      ignore_phase=False, window_name=None, speed=1.0):
    """Windowed band-passed delay estimate between the two sources
    (pytapesynch_gui.py:108-133).  ``speed`` != 1 resamples the source
    window to the reference's expected speed first.
    Returns (time_delay_seconds, correlation)."""
    t_center = (t0 + t1) / 2
    t_width = (t1 - t0) / 2
    ref_sig = get_signal_around(ref_signal, sr, t_center, t_width)
    if speed != 1.0:
        src_sig = get_signal_around(src_signal, sr, t_center - delay, t_width / speed)
        src_sig = resampling.resample_ratio(src_sig, sr / speed, sr, quality=8)
    else:
        src_sig = get_signal_around(src_signal, sr, t_center - delay, t_width)
    n = min(len(ref_sig), len(src_sig))
    # device scan IIR with defect refinement (>100 dB to scipy float64,
    # ops/filters.py) — the host fallback is no longer needed here; the
    # filtered windows stay on device for find_delay (no host round trip)
    a = filters.butter_bandpass_filter(ref_sig[:n], lower, upper, sr, order=3)
    b = filters.butter_bandpass_filter(src_sig[:n], lower, upper, sr, order=3)
    sample_delay, corr = correlation.find_delay(a, b, ignore_phase=ignore_phase,
                                                window_name=window_name)
    return float(sample_delay) / sr * speed, float(corr)


def improve_lag(ref_signal, src_signal, sr, lag_samples, lower=None, upper=None,
                ignore_phase=False, match_speed=False, lag_data=None, marker_sr=None):
    """Refine selected lag markers in place (pytapesynch_gui.py:92-106)."""
    for lag in lag_samples:
        try:
            t0, t1 = sorted((lag.a[0], lag.b[0]))
            lo = lower if lower is not None else min(lag.a[1], lag.b[1])
            hi = upper if upper is not None else max(lag.a[1], lag.b[1])
            speed = 1.0
            if match_speed and lag_data is not None:
                speed = get_speed_at(lag_data, marker_sr, (t0 + t1) / 2)
            time_delay, corr = correlate_sources(
                ref_signal, src_signal, sr, t0, t1, lag.d, lo, hi,
                ignore_phase=ignore_phase, speed=speed)
            lag.d += time_delay
            lag.corr = corr
        except Exception:
            logging.exception("Refining failed")
    return lag_samples


def azimuth_sweep(ref_signal, src_signal, sr, t0, t1, lower, upper, lag_data,
                  dur=0.1, overlap=4, reject=0.3, ignore_phase=False):
    """Per-window delay sweep across [t0, t1] -> AzimuthLine
    (pytapesynch_gui.py:211-238), with all windows correlated in ONE batched
    device call."""
    sample_times = np.arange(t0, t1, dur / overlap)
    if not len(sample_times):
        return None
    sample_lags = np.interp(sample_times, lag_data[:, 0], lag_data[:, 1])
    # build the window stacks (all same length -> batchable)
    n_win = int(round(2 * dur * sr))
    refs = np.stack([get_signal_around(ref_signal, sr, x, dur) [:n_win]
                     for x in sample_times])
    srcs = np.stack([get_signal_around(src_signal, sr, x - d, dur)[:n_win]
                     for x, d in zip(sample_times, sample_lags)])
    refs = _dsp_bandpass_rows(refs, lower, upper, sr, materialize=False)
    srcs = _dsp_bandpass_rows(srcs, lower, upper, sr, materialize=False)
    delays, corrs = correlation.find_delay_batch(refs, srcs, ignore_phase=ignore_phase,
                                                 window_name="hann")
    lags = sample_lags + np.asarray(delays) / sr
    marker = mk.AzimuthLine(sample_times, lags, np.asarray(corrs), lower, upper)
    marker.update_reject(overlap, reject)
    return marker


def estimate_speed_ratio(ref_signal, src_signal, sr, fft_size=16384, f_lo=50.0, f_hi=None):
    """Global speed ratio of src relative to ref from the log2-frequency shift
    of their average spectra (the Correlation tracker's trick across files,
    wow_detection.py:396-436 applied globally)."""
    f_hi = f_hi or sr / 2 * 0.9
    hop = fft_size // 2

    def mean_logspec(sig):
        mono = sig[:, 0] if sig.ndim == 2 else sig
        # frame-mean ON device: downloading only the (F,) average spectrum
        # instead of the full (F, T) magnitude saves ~5 MB/signal of
        # device->host traffic
        mag = fourier.get_mag(mono, fft_size, hop, "hann")
        return np.asarray(jnp.mean(mag, axis=1))

    a = mean_logspec(ref_signal)
    b = mean_logspec(src_signal)
    freqs = fourier.fft_freqs(fft_size, sr)
    lo, hi = np.searchsorted(freqs, (f_lo, f_hi))
    log_grid = np.linspace(np.log2(freqs[lo]), np.log2(freqs[hi - 1]), 4 * (hi - lo))
    la = np.interp(log_grid, np.log2(freqs[lo:hi]), np.log(a[lo:hi] + 1e-10))
    lb = np.interp(log_grid, np.log2(freqs[lo:hi]), np.log(b[lo:hi] + 1e-10))
    la -= la.mean()
    lb -= lb.mean()
    res = np.asarray(correlation.xcorr(la * np.hanning(len(la)),
                                       lb * np.hanning(len(lb)), mode="same"))
    i_peak = int(np.argmax(res))
    i_interp, _ = correlation.parabolic(res, min(max(i_peak, 1), len(res) - 2))
    shift_log2 = (float(i_interp) - len(res) // 2) * (log_grid[-1] - log_grid[0]) / len(log_grid)
    # src content shifted up by s octaves lags the ref spectrum on the log
    # grid, putting the correlation peak at center - s: ratio = 2**(-shift)
    return float(2.0 ** (-shift_log2))


def _fixed_window(signal, sr, t_start, length, channel=0):
    """Zero-padded fixed-length slice starting at ``t_start`` seconds."""
    sig = signal[:, channel] if signal.ndim == 2 else signal
    s0 = int(round(t_start * sr))
    s1 = s0 + length
    pad_l = max(0, -s0)
    pad_r = max(0, s1 - len(sig))
    piece = sig[max(0, s0):min(len(sig), s1)]
    return np.pad(piece, (pad_l, pad_r))


def _fixed_windows_device(sig_dev, sr, starts_s, length):
    """Batched :func:`_fixed_window` sliced ON device from an already
    uploaded mono signal: the host sends only the B start indices, not the
    B x length window payloads (value-identical — same ``int(round(t*sr))``
    indices, zeros outside the signal)."""
    n = sig_dev.shape[0]
    s0 = np.array([int(round(t * sr)) for t in starts_s], np.int32)
    idx = jnp.asarray(s0)[:, None] + jnp.arange(length, dtype=jnp.int32)[None, :]
    mask = (idx >= 0) & (idx < n)
    return jnp.where(mask, sig_dev[jnp.clip(idx, 0, n - 1)], 0.0)


def auto_align(ref_signal, src_signal, sr, num_windows=8, window_s=1.0,
               lower=100.0, upper=None, hop=64, smoothing=3, match_speed=True):
    """Headless end-to-end alignment: estimate the global speed offset, then
    window-correlate along the overlap to build the lag curve.

    All ``num_windows`` window pairs stack into ONE speed-resample, ONE
    batched band-pass, and ONE ``find_delay_batch`` device call (round 1
    correlated them one at a time, pytapesynch_gui.py:108-133's loop shape).

    Returns (lag_samples, lag_curve_data) where the curve is (n, 2) time/lag
    seconds on the reference timeline.
    """
    upper = upper or sr / 4
    # upload each mono signal ONCE; the ratio probe, window slicing,
    # speed-resample, band-pass, and find_delay all consume the same device
    # buffers — host<->device traffic for the whole align is the two signal
    # uploads plus scalars
    ref_dev = jnp.asarray(ref_signal[:, 0] if ref_signal.ndim == 2
                          else ref_signal, jnp.float32)
    src_dev = jnp.asarray(src_signal[:, 0] if src_signal.ndim == 2
                          else src_signal, jnp.float32)
    ratio = estimate_speed_ratio(ref_dev, src_dev, sr) if match_speed else 1.0
    logging.info(f"Source speed ratio estimate: {ratio:.5f}")
    dur_ref = len(ref_signal) / sr
    centers = np.linspace(window_s, dur_ref - window_s, num_windows)
    # initial lag guess: src ~ ref resampled by ratio, so the source position
    # of ref time t is t/ratio and lag(t) = t - t/ratio
    lag_guess = centers - centers / ratio
    try:
        L = int(round(2 * window_s * sr))
        refs = _fixed_windows_device(ref_dev, sr,
                                     [t - window_s for t in centers], L)
        if ratio != 1.0:
            Ls = int(round(2 * window_s / ratio * sr))
            srcs = _fixed_windows_device(
                src_dev, sr,
                [t - d0 - window_s / ratio
                 for t, d0 in zip(centers, lag_guess)], Ls)
            # identical positions for every window -> one vmapped resample;
            # stays on device through the band-pass + find_delay chain below
            srcs = resampling.resample_ratio(srcs.T, sr / ratio, sr,
                                             quality=8, device_out=True).T
        else:
            srcs = _fixed_windows_device(
                src_dev, sr,
                [t - d0 - window_s for t, d0 in zip(centers, lag_guess)], L)
        n = min(refs.shape[1], srcs.shape[1])
        a = _dsp_bandpass_rows(refs[:, :n], lower, upper, sr, materialize=False)
        b = _dsp_bandpass_rows(srcs[:, :n], lower, upper, sr, materialize=False)
        delays, corrs = correlation.find_delay_batch(a, b, window_name="hann")
        time_delays = np.asarray(delays) / sr * ratio
        corrs = np.asarray(corrs)
        samples = [
            mk.LagSample((t - window_s, lower), (t + window_s, upper),
                         d0 + float(td), float(c))
            for t, d0, td, c in zip(centers, lag_guess, time_delays, corrs)]
    except Exception:
        # batched path failed wholesale (degenerate window, etc.) — fall back
        # to per-window correlation, skipping individual failures (the
        # reference's loop contract: one bad window must not kill the run)
        logging.exception("batched auto_align failed; falling back per-window")
        samples = []
        for t, d0 in zip(centers, lag_guess):
            try:
                delay, corr = correlate_sources(
                    ref_signal, src_signal, sr, t - window_s, t + window_s, d0,
                    lower, upper, window_name="hann", speed=ratio)
                samples.append(mk.LagSample((t - window_s, lower),
                                            (t + window_s, upper),
                                            d0 + delay, corr))
            except Exception:
                logging.exception(f"auto_align window at {t:.2f}s failed")
    lag_line = mk.LagLine(sr, hop, dur_ref, smoothing=smoothing)
    data = lag_line.update(samples)
    return samples, data


def _dsp_bandpass_rows(rows, lower, upper, sr, materialize=True):
    """Band-pass a (batch, n) stack along the last axis (device scan IIR
    with defect refinement — >100 dB to the scipy float64 oracle — one call
    for the whole batch).  ``materialize=False`` keeps the result on device
    for a following device op (find_delay_batch)."""
    out = filters.butter_bandpass_filter(rows, lower, upper, sr, order=3)
    return np.asarray(out) if materialize else out


def align_files(ref_path, src_path, out_suffix="", num_windows=8, window_s=1.0,
                lower=100.0, upper=None, smoothing=3, use_channels=(),
                resampling_mode="Sinc", sinc_quality=50, save_project=False):
    """BASELINE config 4: align ``src`` to ``ref`` and write the resampled
    source (pytapesynch_gui.py:145-155)."""
    ref_signal, sr, _ = audio_io.read_file(ref_path)
    src_signal, sr2, _ = audio_io.read_file(src_path)
    if sr2 != sr:
        src_signal = resampling.resample_ratio(src_signal, sr2, sr)
    samples, lag_curve = auto_align(ref_signal, src_signal, sr,
                                    num_windows=num_windows, window_s=window_s,
                                    lower=lower, upper=upper, smoothing=smoothing)
    if save_project:
        from ..utils import project

        proj = project.Project(".tapesync", {
            "reference": ref_path, "source": src_path, "smoothing": smoothing,
            "resampling_mode": resampling_mode, "sinc_quality": sinc_quality,
            "suffix": out_suffix,
        }, {"lags": samples, "azimuths": []})
        proj.save(project.project_path_for(src_path, ".tapesync"))
    paths = resampling.run(
        (src_path,), signal_data=((src_signal, sr),), lag_curve=lag_curve,
        resampling_mode=resampling_mode, sinc_quality=sinc_quality,
        use_channels=use_channels, suffix=out_suffix)
    return paths, samples, lag_curve
