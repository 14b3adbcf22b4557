"""STFT / iSTFT engine on the device via JAX/XLA.

Implements the reference's spectral conventions (util/fourier.py:37-157,
314-437): ``blackmanharris`` default window, reflect-pad centering, hop
``step``, zero-padding factor applied to the FFT length only, and a global
``1/sqrt(n_fft)`` normalization so volume is constant across FFT sizes.

Device-first design notes
-------------------------
* Framing is one XLA gather over a static index matrix — no Python loop over
  frames (the reference needs a numba kernel for this, fourier.py:160-166).
* Overlap-add for the inverse transform is expressed as ``n_fft//hop`` static
  shifted adds (a pure reshape/pad/sum dataflow) whenever ``hop`` divides
  ``n_fft`` — the common case, since the GUI exposes overlap as a power of
  two (widgets.py:325-406).  This avoids scatter-adds, which serialize on
  colliding writes.  A scatter fallback covers arbitrary hops.
* Everything is jit-compiled with static shape parameters; batches of
  channels go through ``vmap``.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from scipy import signal as _dsp

__all__ = [
    "stft", "istft", "get_mag", "to_mag", "fft_freqs", "get_window",
    "window_sumsquare", "fix_length", "pad_center", "n_frames_for",
    "istft_frames_raw",
]


@functools.lru_cache(maxsize=64)
def get_window(window_name: str, n: int, fftbins: bool = True) -> np.ndarray:
    """Host-side window design (static, cached)."""
    return _dsp.get_window(window_name, n, fftbins=fftbins).astype(np.float32)


def to_mag(spectrum):
    """Magnitude with the reference's epsilon floor (fourier.py:23-24)."""
    return jnp.abs(spectrum) + 1e-7


def fft_freqs(n_fft: int, fs: float) -> np.ndarray:
    """Frequencies of the rFFT bins (fourier.py:690-700). Host numpy."""
    return np.arange(0, (n_fft // 2 + 1)) / float(n_fft) * float(fs)


def n_frames_for(n_samples: int, n_fft: int, step: int, center: bool = True) -> int:
    """Number of STFT frames produced for a signal of ``n_samples``."""
    padded = n_samples + (n_fft // 2) * 2 if center else n_samples
    return max(0, (padded - n_fft) // step + 1)


def frame_signal(x, n_fft: int, step: int, center: bool = True):
    """Slice a 1D signal into overlapping frames, shape (n_frames, n_fft).

    When ``step`` divides ``n_fft`` (the usual power-of-two overlap), frames
    are built from ``n_fft//step`` static shifted views of a (blocks, step)
    reshape — no gather and no index constants (a naive index-matrix gather
    bakes an O(n_frames * n_fft) constant into the XLA program).
    """
    if center:
        x = jnp.pad(x, n_fft // 2, mode="reflect")
    n_est = (x.shape[0] - n_fft) // step + 1
    if n_fft % step == 0:
        ratio = n_fft // step
        need = (n_est + ratio - 1) * step
        xb = jnp.pad(x, (0, max(0, need - x.shape[0])))[:need]
        blocks = xb.reshape(-1, step)
        return jnp.concatenate([blocks[j:j + n_est] for j in range(ratio)], axis=1)
    i0 = jax.lax.broadcasted_iota(jnp.int32, (n_est, n_fft), 0) * step
    i1 = jax.lax.broadcasted_iota(jnp.int32, (n_est, n_fft), 1)
    return x[i0 + i1]


@functools.partial(jax.jit, static_argnames=("n_fft", "step", "window_name", "zeropad", "center"))
def _stft_1d(x, n_fft: int, step: int, window_name: str, zeropad: int, center: bool):
    window = jnp.asarray(get_window(window_name, n_fft))
    frames = frame_signal(x.astype(jnp.float32), n_fft, step, center) * window
    spec = jnp.fft.rfft(frames, n=n_fft * zeropad, axis=-1)
    # (n_frames, n_freqs) -> (n_freqs, n_frames) to match the reference layout
    return spec.T / np.sqrt(n_fft)


def stft(x, n_fft: int = 1024, step: int | None = 512, window_name: str = "blackmanharris",
         zeropad: int = 1, center: bool = True):
    """Short-time Fourier transform.

    Parameters mirror the reference ``stft`` (fourier.py:37-75).  ``x`` may be
    1D ``(n,)`` or 2D ``(channels, n)``; output is ``(n_freqs, n_frames)`` or
    ``(channels, n_freqs, n_frames)`` complex64.
    """
    n_fft = int(n_fft)
    step = max(n_fft // 2, 1) if step is None else int(step)
    x = jnp.asarray(x)
    if x.ndim == 1:
        return _stft_1d(x, n_fft, step, window_name, int(zeropad), center)
    if x.ndim == 2:
        return jax.vmap(lambda c: _stft_1d(c, n_fft, step, window_name, int(zeropad), center))(x)
    raise ValueError("x must be 1D or 2D (channels, time)")


def get_mag(*args, **kwargs):
    """Magnitude spectrogram (fourier.py:27-29)."""
    return to_mag(stft(*args, **kwargs))


def pad_center(data: np.ndarray, size: int) -> np.ndarray:
    """Center-pad a 1D host array to ``size`` (librosa-style, fourier.py:236-277)."""
    n = len(data)
    lpad = (size - n) // 2
    if lpad < 0:
        raise ValueError(f"Target size {size} < input size {n}")
    return np.pad(data, (lpad, size - n - lpad))


@functools.lru_cache(maxsize=64)
def _wss_cached(window_name: str, n_frames: int, hop_length: int, win_length: int, n_fft: int):
    """Sum-squared window envelope (fourier.py:492-546). Host, cached, analytic."""
    n = n_fft + hop_length * (n_frames - 1)
    win_sq = pad_center(get_window(window_name, win_length).astype(np.float64) ** 2, n_fft)
    x = np.zeros(n, dtype=np.float64)
    # Direct accumulation is cheap on host (n_frames is frame-rate sized).
    for i in range(n_frames):
        s = i * hop_length
        x[s:min(n, s + n_fft)] += win_sq[:max(0, min(n_fft, n - s))]
    return x.astype(np.float32)


def window_sumsquare(window_name, n_frames, hop_length=512, win_length=None, n_fft=2048):
    if win_length is None:
        win_length = n_fft
    return _wss_cached(window_name, int(n_frames), int(hop_length), int(win_length), int(n_fft))


def _overlap_add(ytmp, hop: int, out_len: int):
    """Overlap-add windowed frames ``ytmp`` of shape (n_frames, n_fft).

    Frame starts all lie on the g = gcd(n_fft, hop) grid, so the overlap-add
    is ``n_fft//g`` static shifted adds over (…, g) blocks — a pure
    reshape/pad/sum dataflow with NO baked index constants for ANY hop
    (dividing hops reduce to g = hop, the round-1 fast path).  Only when the
    shift count would explode (g tiny vs n_fft) does a sequential
    dynamic-slice loop take over — still constant-free.
    """
    n_frames, n_fft = ytmp.shape
    g = math.gcd(n_fft, hop)
    ratio = n_fft // g   # chunks per frame
    hb = hop // g        # blocks advanced per frame
    if ratio <= 64:
        blocks = ytmp.reshape(n_frames, ratio, g)
        n_blocks = max(-(-out_len // g), (n_frames - 1) * hb + ratio)
        acc = jnp.zeros((n_blocks, g), dtype=ytmp.dtype)
        for j in range(ratio):
            src = blocks[:, j, :]  # (n_frames, g): frame t writes block t*hb + j
            if hb > 1:  # spread frames onto the hb-strided block grid
                src = jnp.concatenate(
                    [src[:, None, :],
                     jnp.zeros((n_frames, hb - 1, g), ytmp.dtype)],
                    axis=1).reshape(n_frames * hb, g)
            pad_hi = max(0, n_blocks - src.shape[0] - j)
            acc = acc + jnp.pad(src, ((j, pad_hi), (0, 0)))[:n_blocks]
        return acc.reshape(-1)[:out_len]
    # Sequential fallback for pathological gcds: dynamic-slice accumulate
    # (no O(n_frames * n_fft) index constant, unlike a scatter-add).
    total = (n_frames - 1) * hop + n_fft

    def body(t, y):
        seg = jax.lax.dynamic_slice(y, (t * hop,), (n_fft,))
        frame = jax.lax.dynamic_index_in_dim(ytmp, t, axis=0, keepdims=False)
        return jax.lax.dynamic_update_slice(y, seg + frame, (t * hop,))

    y = jax.lax.fori_loop(0, n_frames, body, jnp.zeros(total, dtype=ytmp.dtype))
    return fix_length(y, out_len)


@functools.partial(jax.jit, static_argnames=("hop_length", "win_length", "window_name", "center", "length", "n_frames", "zeropad"))
def _istft_1d(stft_matrix, hop_length: int, win_length: int, window_name: str,
              center: bool, length: int | None, n_frames: int, zeropad: int = 1):
    n_fft_padded = 2 * (stft_matrix.shape[0] - 1)
    n_fft = n_fft_padded // zeropad
    mat = stft_matrix[:, :n_frames] * np.sqrt(n_fft)  # denormalize
    window = jnp.asarray(pad_center(get_window(window_name, win_length), n_fft))
    # (n_freqs, n_frames) -> frames on rows for the overlap-add; with zeropad
    # the inverse frame is the zero-padded analysis frame, so crop to n_fft
    # (this closes the reference's 'implement zeropad' TODO, fourier.py:315)
    ytmp = jnp.fft.irfft(mat, n=n_fft_padded, axis=0)[:n_fft].T * window[None, :]
    expected_len = n_fft + hop_length * (n_frames - 1)
    y = _overlap_add(ytmp, hop_length, expected_len)

    ifft_window_sum = window_sumsquare(
        window_name, n_frames, hop_length=hop_length, win_length=win_length, n_fft=n_fft)
    tiny = np.finfo(np.float32).tiny
    denom = np.where(ifft_window_sum > tiny, ifft_window_sum, 1.0)
    y = y / jnp.asarray(denom)

    if length is None:
        if center:
            y = y[n_fft // 2: expected_len - n_fft // 2]
        return y
    start = n_fft // 2 if center else 0
    y = y[start:]
    if y.shape[0] >= length:
        return y[:length]
    return jnp.pad(y, (0, length - y.shape[0]))


def istft(stft_matrix, hop_length=None, win_length=None, window_name="blackmanharris",
          center=True, length=None, zeropad=1):
    """Inverse STFT (least-squares Griffin-Lim style, fourier.py:314-437).

    ``stft_matrix``: (n_freqs, n_frames) complex.  Frame trimming for a target
    ``length`` matches the reference exactly.  ``zeropad`` inverts spectra
    produced with ``stft(..., zeropad=k)`` (the reference leaves this
    unimplemented, fourier.py:315).
    """
    stft_matrix = jnp.asarray(stft_matrix)
    n_fft = 2 * (stft_matrix.shape[0] - 1) // int(zeropad)
    if win_length is None:
        win_length = n_fft
    if hop_length is None:
        hop_length = int(win_length // 4)
    if length:
        padded_length = length + int(n_fft) if center else length
        n_frames = min(stft_matrix.shape[1], int(np.ceil(padded_length / hop_length)))
    else:
        n_frames = stft_matrix.shape[1]
    return _istft_1d(stft_matrix, int(hop_length), int(win_length), window_name,
                     center, None if length is None else int(length), int(n_frames),
                     int(zeropad))


@functools.partial(jax.jit, static_argnames=("hop", "window_name", "zeropad"))
def istft_frames_raw(stft_matrix, hop: int, window_name: str = "blackmanharris",
                     zeropad: int = 1):
    """UNNORMALIZED inverse STFT: irfft + synthesis window + overlap-add,
    WITHOUT the window-sumsquare division or any trimming.

    The streamed spectral tools (utils/streaming.stream_masked_stft) invert
    frame blocks with this and divide by their own locally-accumulated
    envelope, which makes blockwise output bit-identical to the in-memory
    ``istft`` in the interior (same addends, same order).  Input
    (n_freqs, n_frames) or (C, n_freqs, n_frames); output length is
    ``n_fft + hop*(n_frames-1)`` in overlap-add coordinates (frame 0 starts
    at 0).
    """
    n_fft_padded = 2 * (stft_matrix.shape[-2] - 1)
    n_fft = n_fft_padded // zeropad
    n_frames = stft_matrix.shape[-1]
    mat = stft_matrix * np.sqrt(n_fft)  # denormalize (matches _istft_1d)
    window = jnp.asarray(pad_center(get_window(window_name, n_fft), n_fft))
    ytmp = jnp.fft.irfft(mat, n=n_fft_padded, axis=-2)[..., :n_fft, :]
    ytmp = jnp.swapaxes(ytmp, -1, -2) * window[None, :]
    out_len = n_fft + hop * (n_frames - 1)
    if ytmp.ndim == 2:
        return _overlap_add(ytmp, hop, out_len)
    return jax.vmap(lambda f: _overlap_add(f, hop, out_len))(ytmp)


def fix_length(data, size: int, axis: int = -1):
    """Trim or zero-pad ``data`` to ``size`` along ``axis`` (fourier.py:440-478)."""
    data = jnp.asarray(data)
    n = data.shape[axis]
    if n > size:
        sl = [slice(None)] * data.ndim
        sl[axis] = slice(0, size)
        return data[tuple(sl)]
    if n < size:
        lengths = [(0, 0)] * data.ndim
        lengths[axis] = (0, size - n)
        return jnp.pad(data, lengths)
    return data
