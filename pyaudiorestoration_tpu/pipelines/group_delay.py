"""Per-band phase / group delay estimation between two recordings
(reference: experiments/group_delay.py).

The reference loops log-spaced bands, band-passing both signals with scipy
and cross-correlating each pair.  Here all bands are materialized at once by
frequency-domain band filtering (one rFFT per signal + per-band Butterworth
magnitude responses) and correlated in one batched device call.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import jax
import jax.numpy as jnp
from scipy import signal as _dsp

from ..ops import correlation

__all__ = ["band_delays"]


def _pairwise(it):
    a, b = itertools.tee(it)
    next(b, None)
    return zip(a, b)


@functools.partial(jax.jit, static_argnames=("n", "n_fft"))
def _bandify(x, H, n: int, n_fft: int):
    """Apply a stack of zero-phase band responses H (num_bands, n_rfft) to x.

    ``n_fft`` must be a power of two >= n: XLA may lower awkward FFT
    lengths (e.g. 66150 = 3 s at 22.05 kHz) to a DFT-style matmul that
    materializes an n x n matrix (17 GB at 3 s).  Zero-padding to a radix-2 length both
    avoids that and removes circular wrap-around from the band filtering.
    """
    X = jnp.fft.rfft(x, n=n_fft)
    return jnp.fft.irfft(X[None, :] * H, n=n_fft)[:, :n]


def band_delays(ref_sig, src_sig, sr, f_lower=10.0, f_upper=2000.0,
                bandwidth=45.0, order=1, min_corr=0.6):
    """Delay and correlation per log-spaced band (group_delay.py:31-110).

    Returns a list of dicts: band center, lag (samples), correlation, and the
    per-band ref/src RMS levels (for differential-EQ style diagnostics).
    """
    n = min(len(ref_sig), len(src_sig))
    ref = np.asarray(ref_sig[:n], np.float32)
    src = np.asarray(src_sig[:n], np.float32)
    n_fft = 1 << (n - 1).bit_length()
    num_bands = int((f_upper - f_lower) / bandwidth)
    band_limits = np.logspace(np.log2(f_lower), np.log2(f_upper), num=num_bands,
                              endpoint=True, base=2)
    freqs = np.fft.rfftfreq(n_fft, 1 / sr)
    responses = []
    centers = []
    for lo, hi in _pairwise(band_limits):
        sos = _dsp.butter(order, [lo / (sr / 2), hi / (sr / 2)], btype="band",
                          output="sos")
        _, h = _dsp.sosfreqz(sos, worN=2 * np.pi * freqs / sr)
        responses.append(np.abs(h) ** 2)  # zero-phase (filtfilt magnitude)
        centers.append((lo + hi) / 2)
    H = jnp.asarray(np.stack(responses).astype(np.float32))
    ref_bands = _bandify(jnp.asarray(ref), H, n, n_fft)
    src_bands = _bandify(jnp.asarray(src), H, n, n_fft)
    delays, corrs = correlation.find_delay_batch(ref_bands, src_bands)
    ref_rms = np.sqrt(np.mean(np.square(np.asarray(ref_bands)), axis=1))
    src_rms = np.sqrt(np.mean(np.square(np.asarray(src_bands)), axis=1))
    out = []
    for c, d, corr, rv, sv in zip(centers, np.asarray(delays), np.asarray(corrs),
                                  ref_rms, src_rms):
        if corr > min_corr:
            out.append({"band_hz": float(c), "lag_samples": float(d),
                        "corr": float(corr), "ref_rms": float(rv),
                        "src_rms": float(sv)})
    return out
