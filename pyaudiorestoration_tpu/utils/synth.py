"""Seeded synthetic tape takes: a pilot tone under wow and flutter.

The inputs of the chip smoke run, the benchmark and the tests are made here
from a seed, so nothing depends on recordings outside the repository.  A
3150 Hz tone is the test signal of the wow-and-flutter measurement standards
(IEC 60386, DIN 45507); the speed error is one slow wow component and one
fast flutter component with seeded phases, plus a little seeded hiss.
"""

from __future__ import annotations

import numpy as np

__all__ = ["wow_take"]


def wow_take(seconds: float = 30.0, sr: int = 192000, channels: int = 2,
             f0: float = 3150.0, wow=(0.55, 0.003), flutter=(6.3, 0.001),
             noise: float = 1e-3, seed: int = 0):
    """A (n, channels) float32 take of a pilot tone whose playback speed is
    ``1 + a_w sin(2 pi f_w t + p_w) + a_f sin(2 pi f_f t + p_f)``.

    ``wow``/``flutter``: (rate Hz, depth) pairs.  Channel c > 0 is the same
    tone at 0.8**c of the level with its own hiss, so a restore that tracks
    channel 0 and resamples every channel through its curve is checkable on
    each.  Returns (take, speed) with ``speed`` the (n,) true speed curve.
    """
    rng = np.random.default_rng(seed)
    n = int(round(seconds * sr))
    t = np.arange(n) / sr
    p_w, p_f = rng.uniform(0.0, 2.0 * np.pi, 2)
    speed = (1.0 + wow[1] * np.sin(2 * np.pi * wow[0] * t + p_w)
             + flutter[1] * np.sin(2 * np.pi * flutter[0] * t + p_f))
    tone = np.sin(2 * np.pi * f0 * np.cumsum(speed) / sr)
    take = np.stack([0.5 * 0.8 ** c * tone + noise * rng.standard_normal(n)
                     for c in range(channels)], axis=-1)
    return take.astype(np.float32), speed
