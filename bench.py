"""Benchmark: wow/flutter restoration of a 192 kHz stereo take on one GPU.

    python bench.py

Prints two JSON lines: the single stereo take (the north-star metric; it
also carries the batch number as ``batch8_x_realtime``), then the 8-take
independent batch tier (``restore_fused_takes``, the digitization-batch
shape; reference anchor: the sequential file loop, resampling.py:168):

  {"metric": ..., "value": N, "unit": "x_realtime", "vs_baseline": N, ...}

Measures the device-resident restoration pipeline (STFT -> banded peak
tracking -> speed curve -> dithered position plan -> windowed-sinc resample,
pyaudiorestoration_tpu/pipelines/respeeder_device.py, one jit program) on
the seeded synthetic take of ``utils/synth.wow_take``: 30 s, 192 kHz,
stereo, a 3150 Hz pilot tone under wow and flutter, restored with FFT 4096,
overlap 8, zeropad 2, sinc quality 50.  The signal is uploaded once; each
timed run is one dispatch that ends in ``block_until_ready``, and
``value`` is audio seconds over the median warm wall.  ``vs_baseline`` is
value / 100 — the fraction of the >=100x-realtime target (the reference
publishes no numbers, BASELINE.md).  Every line names the card and its
power limit.  Exits non-zero when JAX finds no GPU.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SECONDS = float(os.environ.get("BENCH_SECONDS", "30"))
SR, F0 = 192000, 3150.0
FFT, OVERLAP, ZP, QUALITY, DRIFT = 4096, 8, 2, 50, 16
BATCH = 8


def timed(fn, reps):
    """Warm wall times (s) of ``reps`` dispatches, each forced alone."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn().block_until_ready()
        walls.append(time.perf_counter() - t0)
    return walls


def main():
    import jax
    import jax.numpy as jnp

    from pyaudiorestoration_tpu.pipelines import respeeder_device as rdev
    from pyaudiorestoration_tpu.utils.device import (
        best_device, card_description, enable_persistent_compile_cache)
    from pyaudiorestoration_tpu.utils.synth import wow_take

    try:
        dev = best_device()
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        sys.exit(3)
    enable_persistent_compile_cache()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    card = card_description()

    take, _ = wow_take(SECONDS, SR, 2, seed=0)
    sig_dev = jax.device_put(jnp.asarray(take.T))
    audio_s = take.shape[0] / SR
    hop = FFT // OVERLAP
    max_n = int(hop * 1.1)
    NL, NU = rdev._band_limits(F0, 1.0, FFT, ZP, SR)
    band = (NL - 1, NU + 1)
    n_frames = (take.shape[0] + 2 * (FFT // 2) - FFT) // hop + 1
    NLs = jax.device_put(jnp.full((n_frames,), NL, jnp.int32))
    NUs = jax.device_put(jnp.full((n_frames,), NU, jnp.int32))

    def run_single():
        return rdev.restore_fused_device(sig_dev, NLs, NUs, FFT, hop, ZP,
                                         max_n, QUALITY, DRIFT, band=band)

    takes_dev = jax.device_put(jnp.asarray(
        np.stack([take[:, 0] * (0.5 + 0.06 * i) for i in range(BATCH)])))
    NLb = jax.device_put(jnp.broadcast_to(NLs, (BATCH, n_frames)))
    NUb = jax.device_put(jnp.broadcast_to(NUs, (BATCH, n_frames)))

    def run_batch():
        return rdev.restore_fused_takes(takes_dev, NLb, NUb, FFT, hop, ZP,
                                        max_n, QUALITY, DRIFT, band=band)

    def measure(fn, reps):
        t0 = time.perf_counter()
        fn().block_until_ready()  # compile (or cache load) + first run
        cold = time.perf_counter() - t0
        return cold, timed(fn, reps)

    cold, walls = measure(run_single, 20)
    b_cold, b_walls = measure(run_batch, 10)
    rtf = audio_s / float(np.median(walls))
    b_audio_s = BATCH * audio_s
    b_rtf = b_audio_s / float(np.median(b_walls))
    print(json.dumps({
        "metric": "192kHz stereo flutter-correction realtime factor (1 chip, device-resident, steady-state)",
        "value": rtf, "unit": "x_realtime", "vs_baseline": rtf / 100.0,
        "walls_ms": [1e3 * w for w in walls], "wall_cold_s": cold,
        "audio_s": audio_s, "batch8_x_realtime": b_rtf,
        "device": device, "card": card,
    }))
    print(json.dumps({
        "metric": "8-take independent batch aggregate realtime factor (1 chip, restore_fused_takes, steady-state)",
        "value": b_rtf, "unit": "x_realtime", "vs_baseline": b_rtf / 100.0,
        "walls_ms": [1e3 * w for w in b_walls], "wall_cold_s": b_cold,
        "audio_s": b_audio_s, "device": device, "card": card,
    }))


if __name__ == "__main__":
    main()
