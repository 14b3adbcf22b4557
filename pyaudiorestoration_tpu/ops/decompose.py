"""Harmonic/percussive separation (HPSS) and soft masks on the device.

Reference: util/decompose.py (librosa-derived; Fitzgerald 2010 / Driedger
2014): median filter along time -> harmonic enhancement, along frequency ->
percussive, Wiener-exponent soft masks, optional margins yielding a residual.

Device-first: the median filter is a sliding-window sort (gather to
(..., n, size) windows + ``jnp.sort``), tiled over the orthogonal axis with
``lax.map`` to bound the working set.  Everything else is fused elementwise.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["softmask", "median_filter_1d", "harmonic", "magphase", "hpss"]


def _median_last_axis(x, size: int):
    """Sliding median along the last axis, scipy.ndimage 'reflect' padding."""
    pad_lo = size // 2
    pad_hi = size - 1 - pad_lo
    cfg = [(0, 0)] * (x.ndim - 1) + [(pad_lo, pad_hi)]
    xp = jnp.pad(x, cfg, mode="symmetric")  # scipy 'reflect' == numpy 'symmetric'
    n = x.shape[-1]
    # size static shifted views (no gather, no index constants)
    windows = jnp.stack([xp[..., j:j + n] for j in range(size)], axis=-1)
    return jnp.sort(windows, axis=-1)[..., size // 2]


@functools.partial(jax.jit, static_argnames=("size", "axis", "block"))
def median_filter_1d(x, size: int, axis: int, block: int = 128):
    """Median filter of odd ``size`` along ``axis`` of a 2D array, tiled."""
    assert size % 2 == 1, "median_filter_1d expects an odd kernel"
    moved = jnp.moveaxis(x, axis, -1)  # (other, n)
    other, n = moved.shape
    pad = (-other) % block
    padded = jnp.pad(moved, ((0, pad), (0, 0)))
    tiles = padded.reshape(-1, block, n)
    out = jax.lax.map(lambda t: _median_last_axis(t, size), tiles)
    out = out.reshape(-1, n)[:other]
    return jnp.moveaxis(out, -1, axis)


def softmask(X, X_ref, power=1, split_zeros=False):
    """Numerically robust soft mask ``X**p / (X**p + X_ref**p)``
    (decompose.py:7-73); ``power=inf`` gives a hard mask ``X > X_ref``."""
    X = jnp.asarray(X)
    X_ref = jnp.asarray(X_ref)
    if X.shape != X_ref.shape:
        raise ValueError(f"Shape mismatch: {X.shape} != {X_ref.shape}")
    if np.isinf(power):
        return (X > X_ref).astype(X.dtype)
    dtype = X.dtype if jnp.issubdtype(X.dtype, jnp.floating) else jnp.float32
    Z = jnp.maximum(X, X_ref).astype(dtype)
    bad = Z < np.finfo(np.float32).tiny
    Zs = jnp.where(bad, 1.0, Z)
    m = (X / Zs) ** power
    ref_m = (X_ref / Zs) ** power
    mask = m / (m + ref_m)
    fill = 0.5 if split_zeros else 0.0
    return jnp.where(bad, fill, mask)


def magphase(D, power=1):
    """Split complex spectrogram into magnitude**power and unit phase
    (decompose.py:152-174).

    The phasor is computed as ``D / |D|`` (two real divides) rather than
    ``exp(1j*angle)`` — it avoids complex transcendentals, which not every XLA backend implements.
    """
    D = jnp.asarray(D)
    mag = jnp.abs(D)
    phase = D / jnp.maximum(mag, np.finfo(np.float32).tiny)
    return mag ** power, phase


def _median_pair(S, win_harm: int, win_perc: int):
    harm = median_filter_1d(S, win_harm, axis=1)   # along time
    perc = median_filter_1d(S, win_perc, axis=0)   # along frequency
    return harm, perc


def hpss(S, kernel_size=31, power=2.0, mask=False, margin=1.0):
    """Median-filtering HPSS (decompose.py:177-271).

    ``S``: (freq, time) magnitude or complex spectrogram.
    Returns (harmonic, percussive) components (or masks).
    """
    S = jnp.asarray(S)
    if jnp.iscomplexobj(S):
        S, phase = magphase(S)
    else:
        phase = 1
    win_harm, win_perc = (kernel_size, kernel_size) if np.isscalar(kernel_size) else kernel_size
    margin_harm, margin_perc = (margin, margin) if np.isscalar(margin) else margin
    if margin_harm < 1 or margin_perc < 1:
        raise ValueError("Margins must be >= 1.0")
    harm, perc = _median_pair(S, int(win_harm), int(win_perc))
    split_zeros = margin_harm == 1 and margin_perc == 1
    mask_harm = softmask(harm, perc * margin_harm, power=power, split_zeros=split_zeros)
    mask_perc = softmask(perc, harm * margin_perc, power=power, split_zeros=split_zeros)
    if mask:
        return mask_harm, mask_perc
    return (S * mask_harm) * phase, (S * mask_perc) * phase


def harmonic(S, kernel_size=31, power=2.0, mask=False, margin=1.0):
    """Harmonic component only (decompose.py:76-149)."""
    h, _ = hpss(S, kernel_size=kernel_size, power=power, mask=mask, margin=margin)
    return h
