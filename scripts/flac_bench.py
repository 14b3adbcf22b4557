"""Single-core FLAC codec benchmark + speed-of-light context.

Times the first-party C++ FLAC encoder/decoder (native/audioio.cpp) on the
flagship take shape — 192 kHz stereo, the seeded pilot-tone take of
``utils/synth.wow_take``, ~34 s — and prints one JSON object with:

  encode_s / decode_s      best-of-N wall time for the full file
  enc_msps / dec_msps      million interleaved samples per second
  memcpy_gbps              measured single-core memcpy bandwidth on the same
                           buffers (the trivial upper bound for any codec)
  quantize_msps            float->int16 quantize-only loop throughput (the
                           irreducible first stage of ANY float-input FLAC
                           encoder, measured via the same .so's WAV16 path)

The reference interchanges FLAC via libsndfile (io_ops.py:7-23); this repo's
codec must carry the same role, so its single-core ceiling bounds the
FLAC-in/FLAC-out file-to-file RTF.

Usage: python scripts/flac_bench.py [--seconds 34] [--repeats 5] [--out -]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("AUDIOIO_NO_IDX", "1")

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=34.0)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--level", type=int, default=1, choices=(0, 1),
                    help="FLAC preset: 0 fixed-only (fast), 1 +LPC (small)")
    ap.add_argument("--out", default="-")
    ap.add_argument("--channels", type=int, default=2, choices=(1, 2),
                    help="take shape; 2 matches the flagship stereo take")
    args = ap.parse_args()

    from pyaudiorestoration_tpu.utils import audio_io
    from pyaudiorestoration_tpu.utils.synth import wow_take

    sr = 192000
    take, _ = wow_take(args.seconds, sr, args.channels, seed=0)
    audio_s = len(take) / sr
    n_interleaved = take.size

    tmp = "/tmp/flac_bench"
    os.makedirs(tmp, exist_ok=True)
    fl = os.path.join(tmp, "take.flac")

    enc, dec = [], []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        audio_io.write_flac(fl, take, sr, level=args.level)
        enc.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        back, sr2, _ = audio_io.read_file(fl)
        dec.append(time.perf_counter() - t0)
    assert sr2 == sr and len(back) == len(take)
    err = float(np.max(np.abs(back - np.clip(take, -1.0, 1.0 - 2.0 ** -15))))
    assert err <= 2.0 ** -15 + 1e-9, f"roundtrip err {err}"

    # trivial upper bound: one single-core memcpy of the same payload
    buf = take.tobytes()
    dst = bytearray(len(buf))
    mc = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        dst[:] = buf
        mc.append(time.perf_counter() - t0)
    memcpy_gbps = len(buf) / min(mc) / 1e9

    # irreducible first stage: quantize float->int16 (the WAV16 writer is
    # exactly that loop + fwrite to tmpfs)
    wv = os.path.join(tmp, "take16.wav")
    qt = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        audio_io.write_wav(wv, take, sr, subtype="PCM16")
        qt.append(time.perf_counter() - t0)

    flac_bytes = os.path.getsize(fl)
    out = {
        "level": args.level,
        "when": time.strftime("%Y-%m-%dT%H:%MZ", time.gmtime()),
        "audio_s": round(audio_s, 3),
        "sr": sr,
        "channels": int(take.shape[1]),
        "interleaved_msamples": round(n_interleaved / 1e6, 2),
        "encode_s": round(min(enc), 4),
        "decode_s": round(min(dec), 4),
        "enc_msps": round(n_interleaved / min(enc) / 1e6, 1),
        "dec_msps": round(n_interleaved / min(dec) / 1e6, 1),
        "flac_mb": round(flac_bytes / 1e6, 2),
        "compression": round(flac_bytes / len(buf), 3),
        "roundtrip_max_err": err,
        "memcpy_gbps": round(memcpy_gbps, 2),
        "wav16_write_s": round(min(qt), 4),
        "codec_rtf_bound": round(audio_s / (min(enc) + min(dec)), 1),
        "runs_encode_s": [round(t, 4) for t in enc],
        "runs_decode_s": [round(t, 4) for t in dec],
    }
    text = json.dumps(out, indent=1)
    if args.out == "-":
        print(text)
    else:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(text)


if __name__ == "__main__":
    main()
