"""Smoke run of the wow/flutter restoration path on one GPU.

    python chip_smoke.py           # one card: phases (a)-(e)
    python chip_smoke.py --multi   # four cards: the sharded tiers only

Everything runs in this one process (a second JAX process on the card would
find most of its memory reserved).  The input is a seeded synthetic take at
the flagship width: 30 s, 192 kHz, stereo, a 3150 Hz pilot tone under wow
and flutter, restored with FFT 4096, overlap 8, zeropad 2, sinc quality 50.

(a) the device: JAX must find a GPU, else the run exits non-zero;
(b) the Triton sinc kernel at the flagship widths against the plain
    references ``sinc_padded_device`` and ``sinc_banded_device``;
(c) end to end through ``cli.main``: ``respeed`` (default tier),
    ``respeed --fast``, the same take as FLAC with ``--flac-out``, and
    ``respeed-batch`` over four takes of unequal length;
(d) the GPU's fused plan against the CPU backend's, and a take inside
    ``restore_fused_takes`` against the same take alone;
(e) one warm wall time of the flagship restore (orientation only).

``--multi`` runs only the cross-device tiers on four cards: four takes on a
``files=4`` mesh (``respeed-batch``) and one take on a ``time=4`` mesh
(``restore_file_sharded``), each against its solo single-card restore.

The last line of standard output is the JSON result; a failing phase raises
and the line is never printed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SR, SECONDS, F0 = 192000, 30.0, 3150.0
FFT, OVERLAP, ZP, NT, DRIFT = 4096, 8, 2, 50, 16
HOP = FFT // OVERLAP
TAKE_FRACTIONS = (1.0, 0.81, 0.59, 0.37)  # respeed-batch: unequal lengths
TOL = 2e-5  # float32 kernel-vs-reference envelope, as in the CPU tests
# (d) tolerances.  XLA:GPU and XLA:CPU (and two GPU programs of different
# shapes) may sum in different orders, so a tracked speed can differ in its
# last bits; a differing bit can flip a dithered segment count (one output
# sample moves to the neighbouring segment), and the output positions, an
# integral of the curve over the whole take, drift by a fraction of a
# sample.  The result is held to what a listener gets: the compacted take's
# timing and waveform.  Each limit is set from the card's readings (PERF.md).
SPEED_REL_TOL = 1e-5  # tracked speed curve, GPU vs CPU
POS_DRIFT_TOL = 0.5   # output positions, GPU vs CPU, in input samples
# restored channel, GPU vs CPU: read 40.0 dB.  On the 3150 Hz pilot at
# 192 kHz, 30 dB is a timing error of about 0.3 samples, 20 dB of one sample
GPU_CPU_MIN_SNR_DB = 30.0
# a take inside restore_fused_takes against the same take alone, both on the
# GPU: read 86.1 dB.  One wrong segment in the take would read below 40 dB
BATCH_MIN_SNR_DB = 70.0
# --multi compares with no tolerance: the sharded tiers promise the solo
# restore bit for bit (docs/ARCHITECTURE.md section 13), and four cards
# showed it
LEN_REL_TOL = 0.01    # output length against the reference restore


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def band_args(rdev, n, f0=None):
    import jax.numpy as jnp

    NL, NU = rdev._band_limits(f0 or F0, 1.0, FFT, ZP, SR)
    F = (n + 2 * (FFT // 2) - FFT) // HOP + 1
    return (jnp.full((F,), NL, jnp.int32), jnp.full((F,), NU, jnp.int32),
            (NL - 1, NU + 1))


def phase_kernel(x):
    """(b) kernel vs both references on one plan, at the given widths."""
    import jax
    import jax.numpy as jnp

    from pyaudiorestoration_tpu.pipelines import respeeder_device as rdev

    max_n = int(HOP * 1.1)
    NLs, NUs, band = band_args(rdev, x.shape[1])
    speeds, n, bi, bf = rdev._fused_plan(x[0], NLs, NUs, FFT, HOP, ZP, max_n,
                                         NT, DRIFT, "blackmanharris", band)
    args = (x, speeds, n, bi, bf, max_n, NT, DRIFT)
    got = rdev.run_banded_sinc(*args)
    banded = rdev.sinc_banded_device(x, speeds, n, bi, bf, max_n, NT, DRIFT)
    padded = rdev.sinc_padded_device(x[0], speeds, n, bi, bf, max_n, NT)
    d_pad = float(jnp.max(jnp.abs(got[0] - padded)))
    d_band = float(jnp.max(jnp.abs(got - banded)))
    log(f"(b) kernel {tuple(got.shape)}: max|d| vs sinc_padded_device "
        f"{d_pad:.3e}, vs sinc_banded_device {d_band:.3e} (limit {TOL})")
    mem = rdev.run_banded_sinc.lower(*args).compile().memory_analysis()
    log(f"(b) memory_analysis: {mem}")
    check(bool(jnp.all(jnp.isfinite(got))), "kernel output not finite")
    check(d_pad <= TOL and d_band <= TOL, "kernel disagrees with reference")


def run_cli(argv):
    from pyaudiorestoration_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc == 0, f"cli {argv} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])["outputs"]


def phase_cli(work, take, takes):
    """(c) the user's entry points, in process, on files."""
    import jax.numpy as jnp

    from pyaudiorestoration_tpu.pipelines import respeeder_device as rdev
    from pyaudiorestoration_tpu.utils import audio_io, metrics

    width = ["--fft-size", str(FFT), "--fft-overlap", str(OVERLAP),
             "--zeropad", str(ZP), "--sinc-quality", str(NT)]
    wav = os.path.join(work, "take.wav")
    flac = os.path.join(work, "take_flac.flac")
    audio_io.write_wav(wav, take, SR)
    audio_io.write_flac(flac, take, SR, bits_per_sample=24)
    before = metrics.flutter(take[:, 0], SR)
    n = take.shape[0]

    def plan_n_out(path):
        """The --fast plan's output length, from the decoded input."""
        x0 = audio_io.read_file(path)[0][:, 0]
        NLs, NUs, band = band_args(rdev, n, rdev._probe_f0(x0, SR))
        speeds = np.asarray(rdev.track_speed_device(
            jnp.asarray(x0), NLs, NUs, FFT, HOP, ZP, band=band))
        return rdev.plan_positions_fast(speeds, HOP, n)["n_out"]

    runs = [("respeed", ["respeed", wav] + width, None),
            ("respeed --fast", ["respeed", wav, "--fast", "--suffix", "_fast"]
             + width, plan_n_out(wav)),
            ("respeed --fast --flac-out (FLAC in)",
             ["--flac-out", "24", "respeed", flac, "--fast"] + width,
             plan_n_out(flac))]
    try:
        for name, argv, want_len in runs:
            t0 = time.perf_counter()
            (out,) = run_cli(argv)
            wall = time.perf_counter() - t0
            y, osr, ch = audio_io.read_file(out)
            after = metrics.flutter(y[:, 0], osr)
            log(f"(c) {name}: {os.path.basename(out)} {y.shape} sr {osr}, "
                f"flutter {before:.2e} -> {after:.2e}, {wall:.1f} s "
                f"(cold, incl. compile)")
            check(osr == SR and ch == take.shape[1], f"{name}: format")
            if want_len is not None:
                check(len(y) == want_len, f"{name}: {len(y)} != plan {want_len}")
            else:
                check(abs(len(y) / n - 1) < 0.01, f"{name}: length {len(y)}")
            check(after < before / 3, f"{name}: flutter not reduced")
    finally:
        audio_io.set_output_format("wav")

    paths = []
    for i, t in enumerate(takes):
        p = os.path.join(work, f"batch{i}.wav")
        audio_io.write_wav(p, t, SR)
        paths.append(p)
    t0 = time.perf_counter()
    outs = run_cli(["respeed-batch", *paths, "--fft-size", str(FFT), "--step",
                    str(HOP), "--zeropad", str(ZP), "--sinc-quality", str(NT)])
    wall = time.perf_counter() - t0
    for t, out in zip(takes, outs):
        y, osr, _ = audio_io.read_file(out)
        b, a = metrics.flutter(t[:, 0], SR), metrics.flutter(y[:, 0], osr)
        log(f"(c) respeed-batch: {os.path.basename(out)} {len(t)} -> {len(y)} "
            f"samples, flutter {b:.2e} -> {a:.2e}")
        check(abs(len(y) / len(t) - 1) < 0.01, "respeed-batch: length")
        check(a < b / 3, "respeed-batch: flutter not reduced")
    log(f"(c) respeed-batch: 4 takes in {wall:.1f} s (cold, incl. compile)")


def compacted(padded, counts=None):
    """The contiguous take from a (segments, max_n) grid.  Without
    ``counts`` they are read off the grid: entries past a segment's count are
    exactly zero (masked taps), and a computed sample of this noisy tone is
    never exactly zero."""
    from pyaudiorestoration_tpu.parallel import sharded

    p = np.asarray(padded)
    if counts is None:
        nz = p != 0
        counts = np.where(nz.any(-1), p.shape[-1] - np.argmax(nz[:, ::-1], -1),
                          0)
    return sharded.compact_padded_host(p, np.asarray(counts))


def compare_outputs(name, y, ref, min_snr_db=None):
    """A restored take against its reference restore, sample by sample:
    held to ``min_snr_db`` and the length tolerance, or, without a limit, to
    bit equality."""
    m = min(len(y), len(ref))
    d = np.asarray(y[:m], np.float64) - np.asarray(ref[:m], np.float64)
    err = float(np.sum(d * d))
    snr = np.inf if err == 0 else 10 * np.log10(
        float(np.sum(np.square(ref[:m], dtype=np.float64))) / err)
    same = bool(len(y) == len(ref) and err == 0)
    limit = "bit-identical" if min_snr_db is None else f"{min_snr_db} dB"
    log(f"{name}: {len(y)} samples (reference {len(ref)}), bit-identical "
        f"{same}, max|d| {float(np.abs(d).max()):.3e}, SNR {snr:.1f} dB "
        f"(limit {limit})")
    if min_snr_db is None:
        check(same, f"{name}: differs from its reference restore")
    else:
        check(snr >= min_snr_db and abs(len(y) / len(ref) - 1) <= LEN_REL_TOL,
              f"{name}: drifted from its reference restore")


def phase_gpu_vs_cpu(x, take2):
    """(d) the fused plan and restore on the GPU against the CPU backend,
    and a take in a batch against the same take alone."""
    import jax
    import jax.numpy as jnp

    from pyaudiorestoration_tpu.pipelines import respeeder_device as rdev

    max_n = int(HOP * 1.1)
    NLs, NUs, band = band_args(rdev, x.shape[1])
    static = (FFT, HOP, ZP, max_n, NT, DRIFT, "blackmanharris", band)
    gpu = rdev._fused_plan(x[0], NLs, NUs, *static)
    x_cpu = jax.device_put((x[0], NLs, NUs), jax.devices("cpu")[0])
    cpu = rdev._fused_plan(*x_cpu, *static)
    (sg, ng, big, bfg), (sc, nc, bic, bfc) = (
        [np.asarray(a) for a in p] for p in (gpu, cpu))
    rel = float(np.max(np.abs(sg / sc - 1)))
    flips = int(np.sum(ng != nc))
    base = float(np.max(np.abs((big - bic) + (bfg.astype(np.float64) - bfc))))
    log(f"(d) GPU vs CPU plan: speed max rel err {rel:.3e} (limit "
        f"{SPEED_REL_TOL}), dithered counts differing {flips}/{len(ng)}, "
        f"base position max |d| {base:.3e} samples, bit-identical: "
        f"{bool(np.array_equal(sg, sc) and flips == 0)}")
    check(rel <= SPEED_REL_TOL, "GPU speed curve drifted from CPU")

    def positions(plan):
        """Each output sample's position in the input, in samples."""
        s, n, bi, bf = plan
        rel = rdev.segment_grids(s[:-1], s[1:], n, bf, max_n)[1]
        return compacted(np.asarray(bi, np.float64)[:, None]
                         + np.asarray(rel, np.float64), np.asarray(n))

    pg, pc = positions(gpu), positions(cpu)
    m = min(len(pg), len(pc))
    drift = float(np.max(np.abs(pg[:m] - pc[:m])))
    log(f"(d) GPU vs CPU output positions: {len(pg)} vs {len(pc)} samples, "
        f"max |d| {drift:.3e} input samples (limit {POS_DRIFT_TOL})")
    check(drift <= POS_DRIFT_TOL, "GPU output positions drifted from CPU")
    # channel 0 restored through each backend's own plan and the same entry
    # point, which runs the Triton kernel for the GPU-resident arrays and the
    # XLA shift-MAC for the CPU-resident ones
    y_gpu = rdev.run_banded_sinc(x[0], *gpu, max_n, NT, DRIFT)
    y_cpu = rdev.run_banded_sinc(x_cpu[0], *cpu, max_n, NT, DRIFT)
    check(next(iter(y_cpu.devices())).platform == "cpu", "CPU restore moved")
    compare_outputs("(d) GPU vs CPU restore, channel 0", compacted(y_gpu, ng),
                    compacted(y_cpu, nc), GPU_CPU_MIN_SNR_DB)

    L2 = len(take2)
    xb = jnp.stack([x[0], jnp.pad(jnp.asarray(take2), (0, x.shape[1] - L2))])
    NLb = jnp.broadcast_to(NLs, (2,) + NLs.shape)
    NUb = jnp.broadcast_to(NUs, (2,) + NUs.shape)
    batch = rdev.restore_fused_takes(xb, NLb, NUb, FFT, HOP, ZP, max_n, NT,
                                     DRIFT, band=band,
                                     lengths=[x.shape[1], L2])
    NL2, NU2, _ = band_args(rdev, L2)
    x2 = jnp.asarray(take2)
    solo = rdev.restore_fused_device(x2, NL2, NU2, FFT, HOP, ZP, max_n, NT,
                                     DRIFT, band=band)
    n_solo = np.asarray(rdev._fused_plan(x2, NL2, NU2, *static)[1])
    T = len(n_solo)
    same_grid = bool(np.array_equal(np.asarray(batch[1])[:T],
                                    np.asarray(solo)))
    log(f"(d) take in restore_fused_takes vs alone: padded grids "
        f"bit-identical {same_grid}")
    compare_outputs("(d) take in restore_fused_takes vs alone",
                    compacted(np.asarray(batch[1])[:T]),
                    compacted(solo, n_solo), BATCH_MIN_SNR_DB)


def phase_wall(x, card):
    """(e) one warm wall time of the flagship restore."""
    from pyaudiorestoration_tpu.pipelines import respeeder_device as rdev

    max_n = int(HOP * 1.1)
    NLs, NUs, band = band_args(rdev, x.shape[1])

    def step():
        return rdev.restore_fused_device(x, NLs, NUs, FFT, HOP, ZP, max_n,
                                         NT, DRIFT, band=band)

    step().block_until_ready()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step().block_until_ready()
        walls.append(time.perf_counter() - t0)
    log(f"(e) warm restore_fused_device, {x.shape[1] / SR:.1f} s stereo at "
        f"{SR} Hz: min {1e3 * min(walls):.3f} ms, median "
        f"{1e3 * float(np.median(walls)):.3f} ms on {card} (orientation, "
        f"not a benchmark)")


def solo_restore(rdev, t, NL, NU, band, max_n, drift):
    """One take alone on one card, compacted like the sharded exports (the
    first length//hop segments, through the take's own device plan)."""
    import jax.numpy as jnp

    from pyaudiorestoration_tpu.parallel import sharded

    n = len(t)
    F = (n + 2 * (FFT // 2) - FFT) // HOP + 1
    x, NLs, NUs = (jnp.asarray(t), jnp.full((F,), NL, jnp.int32),
                   jnp.full((F,), NU, jnp.int32))
    padded = rdev.restore_fused_device(x, NLs, NUs, FFT, HOP, ZP, max_n, NT,
                                       drift, band=band)
    counts = np.asarray(rdev._fused_plan(x, NLs, NUs, FFT, HOP, ZP, max_n,
                                         NT, drift, "blackmanharris",
                                         band)[1])
    t_real = min(len(counts), n // HOP)
    return sharded.compact_padded_host(np.asarray(padded)[:t_real],
                                       counts[:t_real])


def multi(work):
    """Four takes on a files=4 mesh and one take on a time=4 mesh, each
    against its solo single-card restore."""
    import jax

    from pyaudiorestoration_tpu.parallel import batch as pbatch
    from pyaudiorestoration_tpu.pipelines import respeeder_device as rdev
    from pyaudiorestoration_tpu.utils import audio_io
    from pyaudiorestoration_tpu.utils.synth import wow_take

    devs = jax.devices()
    check(len(devs) == 4, f"--multi needs 4 GPUs, found {len(devs)}")
    max_n, drift = int(HOP * 1.25), 32  # the sharded exports' widths
    NL, NU = rdev._band_limits(F0, 1.0, FFT, ZP, SR)
    band = (NL - 1, NU + 1)

    takes = [wow_take(SECONDS * f, SR, 1, seed=10 + i)[0][:, 0]
             for i, f in enumerate(TAKE_FRACTIONS)]
    paths = []
    for i, t in enumerate(takes):
        paths.append(os.path.join(work, f"multi{i}.wav"))
        audio_io.write_wav(paths[-1], t, SR)
    outs = run_cli(["respeed-batch", *paths, "--f0", str(F0), "--fft-size",
                    str(FFT), "--step", str(HOP), "--zeropad", str(ZP),
                    "--sinc-quality", str(NT)])
    for i, (t, out) in enumerate(zip(takes, outs)):
        y, _, _ = audio_io.read_file(out)
        compare_outputs(f"files=4 take {i} ({len(t) / SR:.1f} s)", y[:, 0],
                        solo_restore(rdev, t, NL, NU, band, max_n, drift))

    # one take whose length is a multiple of 4 hops: no mesh padding
    t = wow_take(SECONDS, SR, 1, seed=20)[0][:, 0]
    t = t[: len(t) // (4 * HOP) * (4 * HOP)]
    p = os.path.join(work, "multi_time.wav")
    audio_io.write_wav(p, t, SR)
    out = pbatch.restore_file_sharded(p, f0_hz=F0, fft_size=FFT,
                                      fft_overlap=OVERLAP, zeropad=ZP,
                                      sinc_quality=NT, drift=drift)
    y, _, _ = audio_io.read_file(out)
    compare_outputs("time=4 take", y[:, 0],
                    solo_restore(rdev, t, NL, NU, band, max_n, drift))
    for d in devs:
        stats = d.memory_stats() or {}
        log(f"device {d.id}: peak_bytes_in_use "
            f"{stats.get('peak_bytes_in_use', 'n/a')}")
        check(stats.get("peak_bytes_in_use", 1) > 0,
              f"device {d.id} never used")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded tiers")
    args = ap.parse_args()

    import jax

    # (a) the device: no GPU, no result
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform})",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    from pyaudiorestoration_tpu.utils.device import (
        best_device, card_description, enable_persistent_compile_cache)

    card = card_description()
    log(f"(a) card: {card}")
    log(f"(a) jax: {len(devs)} x {best_device().device_kind}, "
        f"jax {jax.__version__}")
    enable_persistent_compile_cache()

    work = os.path.join(ROOT, ".smoke_tmp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        if args.multi:
            multi(work)
        else:
            import jax.numpy as jnp

            from pyaudiorestoration_tpu.utils.synth import wow_take

            take, _ = wow_take(SECONDS, SR, 2, seed=0)
            x = jax.device_put(jnp.asarray(take.T))
            phase_kernel(x)
            takes = [wow_take(SECONDS * f, SR, 2, seed=1 + i)[0]
                     for i, f in enumerate(TAKE_FRACTIONS)]
            phase_cli(work, take, takes)
            phase_gpu_vs_cpu(x, takes[2][:, 0])
            phase_wall(x, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
