"""Sinc-stage A/B on the GPU: the Triton kernel against what XLA makes of the
plain banded formulation, at the flagship widths (30 s, 192 kHz, stereo,
FFT 4096, overlap 8, zeropad 2, sinc quality 50, drift 16).

Run on a machine with a GPU, from the repository root:

    python scripts/sinc_ab.py [--reps 20]

Prints the card's name and power limit, then one JSON line per
measurement: the isolated stage (same plan, same grids) and the end-to-end
``restore_fused_device`` step, each as warm wall times of runs that end in
``block_until_ready``, taken in alternating order.  Also checks the kernel
against ``sinc_banded_device`` on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FFT, OVERLAP, ZP, NT, DRIFT = 4096, 8, 2, 50, 16


def _wall(fn):
    t0 = time.perf_counter()
    fn().block_until_ready()
    return time.perf_counter() - t0


def _ab(name, fa, fb, reps):
    """Warm both, then alternate a, b, b, a ... and report both series."""
    fa().block_until_ready()
    fb().block_until_ready()
    ta, tb = [], []
    for i in range(reps):
        if i % 2 == 0:
            ta.append(_wall(fa))
            tb.append(_wall(fb))
        else:
            tb.append(_wall(fb))
            ta.append(_wall(fa))
    row = {"measure": name,
           "kernel_ms_median": 1e3 * float(np.median(ta)),
           "kernel_ms_min": 1e3 * min(ta),
           "xla_ms_median": 1e3 * float(np.median(tb)),
           "xla_ms_min": 1e3 * min(tb),
           "kernel_ms": [1e3 * t for t in ta], "xla_ms": [1e3 * t for t in tb]}
    print(json.dumps(row), flush=True)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from pyaudiorestoration_tpu.pipelines import respeeder_device as rdev
    from pyaudiorestoration_tpu.utils.device import (
        best_device, card_description, enable_persistent_compile_cache)
    from pyaudiorestoration_tpu.utils.synth import wow_take

    dev = best_device()
    enable_persistent_compile_cache()
    print(f"card: {card_description()} | jax: {dev.device_kind}", flush=True)

    sr = 192000
    take, _ = wow_take(30.0, sr, 2, seed=0)
    x = jax.device_put(jnp.asarray(take.T))
    hop = FFT // OVERLAP
    max_n = int(hop * 1.1)
    NL, NU = rdev._band_limits(3150.0, 1.0, FFT, ZP, sr)
    F = (x.shape[1] + 2 * (FFT // 2) - FFT) // hop + 1
    NLs = jnp.full((F,), NL, jnp.int32)
    NUs = jnp.full((F,), NU, jnp.int32)
    band = (NL - 1, NU + 1)
    speeds, n, bi, bf = jax.block_until_ready(rdev._fused_plan(
        x[0], NLs, NUs, FFT, hop, ZP, max_n, NT, DRIFT, "blackmanharris",
        band))
    print(json.dumps({"segments": int(n.shape[0]), "channels": 2,
                      "max_n": max_n, "passes": 2 * (NT + DRIFT)}), flush=True)

    stage_args = (x, speeds, n, bi, bf, max_n, NT, DRIFT)

    def xla_stage():
        return rdev.sinc_banded_device(*stage_args)

    def kernel_stage():
        return rdev.run_banded_sinc(*stage_args)

    d = float(jnp.max(jnp.abs(kernel_stage() - xla_stage())))
    print(json.dumps({"check": "kernel vs sinc_banded_device on the card",
                      "max_abs_diff": d}), flush=True)
    _ab("sinc stage (stereo, same plan)", kernel_stage, xla_stage, args.reps)

    def xla_e2e_fn(x):
        s, nn, b, f = rdev._fused_plan(x[0], NLs, NUs, FFT, hop, ZP, max_n,
                                       NT, DRIFT, "blackmanharris", band)
        return rdev.sinc_banded_device(x, s, nn, b, f, max_n, NT, DRIFT)

    xla_e2e = jax.jit(xla_e2e_fn)
    _ab("restore_fused_device end to end",
        lambda: rdev.restore_fused_device(x, NLs, NUs, FFT, hop, ZP, max_n,
                                          NT, DRIFT, band=band),
        lambda: xla_e2e(x), args.reps)


if __name__ == "__main__":
    main()
