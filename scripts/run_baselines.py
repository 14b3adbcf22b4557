"""Run the five BASELINE.json configs end-to-end and write a JSON report.

Usage: python scripts/run_baselines.py [out_dir]

Covers (BASELINE.md):
 1. pyrespeeder wow/flutter fix of samples/flutter.flac
 2. dropout healer on samples/dropouts_sample.flac (.drop markers)
 3. difeq differential-EQ matching (nr_signal.wav vs nr_noise.wav)
 4. pytapesynch alignment (rhythm.flac vs rhythm+5percent.flac)
 5. expander + HPSS renoiser batch at 192 kHz (flutter_192.flac)

Each stage records wall time and a quality metric; results land in
<out_dir>/BASELINE_RESULTS.json.
"""

import json
import os
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("AUDIOIO_NO_IDX", "1")  # keep the reference dir pristine
SAMPLES = "/root/reference/samples"


def tone_stability(sig, sr, smooth_periods=32):
    idx = np.where(np.bitwise_xor(sig[1:] > 0, sig[:-1] > 0))[0]
    frac = sig[idx] / (sig[idx] - sig[idx + 1])
    cr = idx + frac
    k = smooth_periods
    avg = (cr[2 * k:] - cr[:-2 * k]) / k
    fr = sr / avg  # crossings are half-periods; 2k crossings = k periods
    core = fr[len(fr) // 10: -len(fr) // 10]
    return float(np.std(core) / np.mean(core))


def main(out_dir="baseline_runs"):
    from pyaudiorestoration_tpu.ops import correlation
    from pyaudiorestoration_tpu.pipelines import (
        difeq, dropouts, expander, hpss_tool, respeeder, tapesynch)
    from pyaudiorestoration_tpu.utils import audio_io, project

    os.makedirs(out_dir, exist_ok=True)
    results = {}

    def staged(name):
        def wrap(fn):
            # cold run includes XLA compilation (one-time per shape); the
            # warm second run is the steady-state cost a batch deployment
            # pays per file.  NOTE: fn() executes TWICE, so stage bodies must
            # be idempotent -- any files they write are overwritten by the
            # warm pass (fine for these pure file-to-file pipelines)
            t0 = time.perf_counter()
            res = fn()
            cold = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = fn()
            warm = time.perf_counter() - t0
            res["wall_cold_s"] = round(cold, 3)
            res["wall_warm_s"] = round(warm, 3)
            if "audio_s" in res:
                res["rtf_warm"] = round(res["audio_s"] / warm, 1)
            results[name] = res
            print(name, json.dumps(res))
        return wrap

    # 1. respeeder on flutter.flac
    @staged("respeeder_flutter")
    def _():
        src = os.path.join(out_dir, "flutter.flac")
        shutil.copy(os.path.join(SAMPLES, "flutter.flac"), src)
        sig, sr, _c = audio_io.read_file(src)
        before = tone_stability(sig[:, 0].astype(float), sr)
        paths = respeeder.restore_file(src, mode="Peak", fft_size=1024,
                                       fft_overlap=8, zeropad=4, sinc_quality=50)
        out, osr, _c2 = audio_io.read_file(paths[0])
        after = tone_stability(out[:, 0].astype(float), osr)
        dur = len(sig) / sr
        return {"audio_s": round(dur, 2), "flutter_before": round(before, 5),
                "flutter_after": round(after, 5),
                "reduction_x": round(before / after, 2), "output": paths[0]}

    # 2. dropout healer
    @staged("dropout_heal")
    def _():
        src = os.path.join(out_dir, "dropouts_sample.flac")
        shutil.copy(os.path.join(SAMPLES, "dropouts_sample.flac"), src)
        proj = project.Project.load(os.path.join(SAMPLES, "dropouts_sample.drop"))
        drops = proj.marker_list("dropouts")
        out_path = dropouts.heal_file(src, drops, proj.fft_size, proj.fft_overlap)
        sig, sr, _c = audio_io.read_file(src)
        out, _sr2, _c2 = audio_io.read_file(out_path)
        gains = []
        for d in drops:
            s0, s1 = int((d.t - d.width / 2) * sr), int((d.t + d.width / 2) * sr)
            b = np.sqrt(np.mean(sig[s0:s1, 0] ** 2))
            a = np.sqrt(np.mean(out[s0:s1, 0] ** 2))
            gains.append(a / (b + 1e-12))
        return {"audio_s": round(len(sig) / sr, 2), "num_dropouts": len(drops),
                "median_boost": round(float(np.median(gains)), 3),
                "output": out_path}

    # 3. difeq
    @staged("difeq")
    def _():
        freqs_av, av, paths = difeq.difeq_files(
            os.path.join(SAMPLES, "nr_signal.wav"),
            os.path.join(SAMPLES, "nr_noise.wav"),
            os.path.join(out_dir, "eq"))
        return {"points": len(freqs_av),
                "mean_db": round(float(np.mean(av)), 2), "outputs": paths}

    # 4. tapesynch
    @staged("tapesynch")
    def _():
        ref_p = os.path.join(out_dir, "rhythm.flac")
        src_p = os.path.join(out_dir, "rhythm5.flac")
        shutil.copy(os.path.join(SAMPLES, "rhythm.flac"), ref_p)
        shutil.copy(os.path.join(SAMPLES, "rhythm+5percent.flac"), src_p)
        paths, samples_l, curve = tapesynch.align_files(
            ref_p, src_p, num_windows=10, window_s=0.5, sinc_quality=50)
        ref, sr, _c = audio_io.read_file(ref_p)
        out, _sr2, _c2 = audio_io.read_file(paths[0])
        n = min(len(out), len(ref))
        mid, w = n // 2, sr // 2
        d, corr = correlation.find_delay(ref[mid - w:mid + w, 0],
                                         out[mid - w:mid + w, 0], window_name="hann")
        return {"audio_s": round(len(ref) / sr, 2),
                "mid_corr": round(float(corr), 3),
                "mid_residual_ms": round(float(d) / sr * 1000, 3),
                "output": paths[0]}

    # 5. expander + HPSS at 192 kHz
    @staged("expander_hpss_192k")
    def _():
        src = os.path.join(out_dir, "flutter_192.flac")
        shutil.copy(os.path.join(SAMPLES, "flutter_192.flac"), src)
        ep = expander.expand_file(src, channel_mode="L", band_lower=14000,
                                  band_upper=17000, clip_lower=-80, clip_upper=-40)
        hp = hpss_tool.separate_file(src, fft_size=2048, kernel_size=31)
        sig, sr, _c = audio_io.read_file(src)
        return {"audio_s": round(len(sig) / sr, 2), "sr": sr,
                "outputs": [ep] + hp}

    results["_notes"] = (
        "wall_cold_s includes one-time XLA compilation; wall_warm_s is the "
        "steady-state per-file cost, file reads and writes included; "
        "bench.py times the device-resident pipeline alone."
    )
    path = os.path.join(out_dir, "BASELINE_RESULTS.json")
    with open(path, "w") as w:
        json.dump(results, w, indent=2)
    print("wrote", path)


if __name__ == "__main__":
    main(*sys.argv[1:2])
