"""Regression tests for round-1 advisor findings (ADVICE.md).

Each test reproduces the exact failure condition; before the fixes the first
two crashed the process (native heap overflow / null deref) and the third
raised TypeError on any batched input.
"""

import numpy as np
import pytest
from scipy import signal as dsp

from pyaudiorestoration_tpu.ops import filters, resampling
from pyaudiorestoration_tpu.utils import audio_io


class _BitWriter:
    def __init__(self):
        self.bits = []

    def w(self, val, n):
        for i in range(n - 1, -1, -1):
            self.bits.append((val >> i) & 1)

    def tobytes(self):
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(
            sum(b << (7 - j) for j, b in enumerate(bits[i:i + 8]))
            for i in range(0, len(bits), 8))


def _malicious_flac():
    """FLAC frame with block 192, LPC order 32, partition order 4, escape
    partition: the first partition's residual count underflows as uint32
    unless (block_size >> part_order) > pred_order is enforced."""
    bw = _BitWriter()
    bw.w(192, 16)   # min block
    bw.w(192, 16)   # max block
    bw.w(0, 24)     # min frame size
    bw.w(0, 24)     # max frame size
    bw.w(8000, 20)  # sample rate
    bw.w(0, 3)      # channels - 1
    bw.w(15, 5)     # bps - 1
    bw.w(192, 36)   # total samples
    streaminfo = bw.tobytes() + bytes(16)  # + md5
    assert len(streaminfo) == 34

    fr = _BitWriter()
    fr.w(0x3FFE, 14)  # sync
    fr.w(0, 1)        # reserved
    fr.w(0, 1)        # blocking strategy
    fr.w(1, 4)        # block size code 1 -> 192
    fr.w(0, 4)        # sample rate from streaminfo
    fr.w(0, 4)        # 1 channel
    fr.w(0, 3)        # bps from streaminfo
    fr.w(0, 1)        # reserved
    fr.w(0, 8)        # utf8 frame number
    fr.w(0, 8)        # crc8 (unchecked)
    # subframe: LPC order 32
    fr.w(0, 1)        # padding
    fr.w(63, 6)       # type: LPC, order 32
    fr.w(0, 1)        # no wasted bits
    for _ in range(32):
        fr.w(0, 16)   # warmup samples
    fr.w(1, 4)        # precision 2
    fr.w(0, 5)        # shift 0
    for _ in range(32):
        fr.w(0, 2)    # coefficients
    # residual: rice method 0, partition order 4 -> part_len 12 < order 32
    fr.w(0, 2)
    fr.w(4, 4)
    fr.w(0xF, 4)      # escape code
    fr.w(0, 5)        # raw bits = 0 -> writes zeros 'count' times
    return b"fLaC" + bytes([0x80, 0, 0, 34]) + streaminfo + fr.tobytes()


def test_flac_residual_partition_underflow_rejected(tmp_path):
    path = tmp_path / "evil.flac"
    path.write_bytes(_malicious_flac())
    with pytest.raises(Exception):
        audio_io.read_file(path)


def test_wav_stream_short_fmt_chunk_rejected(tmp_path):
    # zero-length fmt chunk: field reads must not dereference a null body
    body = b"fmt " + (0).to_bytes(4, "little")
    body += b"data" + (8).to_bytes(4, "little") + bytes(8)
    riff = b"RIFF" + (4 + len(body)).to_bytes(4, "little") + b"WAVE" + body
    path = tmp_path / "shortfmt.wav"
    path.write_bytes(riff)
    with pytest.raises(OSError):
        audio_io.StreamReader(path)
    # 15-byte fmt chunk (one short of the fixed fields) must also be rejected
    body = b"fmt " + (15).to_bytes(4, "little") + bytes(15)
    body += b"data" + (8).to_bytes(4, "little") + bytes(8)
    riff = b"RIFF" + (4 + len(body)).to_bytes(4, "little") + b"WAVE" + body
    path2 = tmp_path / "shortfmt15.wav"
    path2.write_bytes(riff)
    with pytest.raises(OSError):
        audio_io.StreamReader(path2)


@pytest.mark.parametrize("shape", [(4, 256), (310, 310)])
def test_sosfiltfilt_batched(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    sos = dsp.butter(3, [0.1, 0.4], btype="band", output="sos")
    got = np.asarray(filters.sosfiltfilt(sos, x))
    want = dsp.sosfiltfilt(sos, x.astype(np.float64), axis=-1)
    assert got.shape == shape
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_sosfilt_batched_matches_rows(rng):
    x = rng.standard_normal((3, 200)).astype(np.float32)
    sos = dsp.butter(2, 0.2, btype="low", output="sos")
    got = np.asarray(filters.sosfilt(sos, x))
    for i in range(3):
        row = np.asarray(filters.sosfilt(sos, x[i]))
        np.testing.assert_allclose(got[i], row, atol=1e-6)


def test_cli_heal_without_project_or_detect_clean_error(tmp_path, capsys):
    from pyaudiorestoration_tpu import cli

    wav = tmp_path / "x.wav"
    audio_io.write_wav(wav, np.zeros(1024, np.float32), 8000)
    rc = cli.main(["heal", str(wav)])
    assert rc == 1
    err = capsys.readouterr().err
    assert "error:" in err and "--project or --detect" in err


def test_sinc_resample_last_block_fc_convention(rng):
    # n_out NOT a multiple of the banded block: the final real sample's fc
    # must reuse the previous period (downsampling), not collapse to 1
    n_in = 4096
    t = np.arange(n_in)
    sig = np.sin(2 * np.pi * 0.02 * t).astype(np.float32)
    ratio = 2.0  # downsample by 2 -> fc = 0.5 everywhere
    n_out = 777  # 777 % 512 != 0
    sample_at = np.arange(n_out, dtype=np.float64) * ratio + 100.0
    banded = resampling.sinc_resample(sig, sample_at, quality=16)
    gather = resampling.sinc_resample(sig, sample_at, quality=16,
                                      max_band_drift=0)  # force gather path
    np.testing.assert_allclose(banded, gather, atol=1e-4)


def test_sinc_resample_multichannel_matches_1d(rng):
    n = 2048
    sig = rng.standard_normal((n, 3)).astype(np.float32)
    sample_at = np.arange(0, n - 4, 0.7, dtype=np.float64)
    multi = resampling.sinc_resample(sig, sample_at, quality=12)
    assert multi.shape == (len(sample_at), 3)
    for c in range(3):
        single = resampling.sinc_resample(sig[:, c], sample_at, quality=12)
        np.testing.assert_allclose(multi[:, c], single, atol=1e-6)


def test_linear_resample_multichannel(rng):
    n = 512
    sig = rng.standard_normal((n, 2)).astype(np.float32)
    sample_at = np.arange(0, n - 1, 0.5, dtype=np.float64)
    multi = resampling.linear_resample(sig, sample_at)
    for c in range(2):
        single = resampling.linear_resample(sig[:, c], sample_at)
        np.testing.assert_allclose(multi[:, c], single, atol=1e-7)


def test_process_heuristic_degenerate_band_is_finite(tmp_path, rng):
    """Bands narrower than one bin (tiny fft_size vs sr) must be skipped;
    the reference NaN-poisons the whole file via np.mean of an empty slice
    (dropouts_gui.py:283). Found by driving the CLI at sr=22050, fft 64."""
    from pyaudiorestoration_tpu.pipelines import dropouts
    from pyaudiorestoration_tpu.utils import audio_io

    sr = 22050
    t = np.arange(sr) / sr
    sig = (0.4 * np.sin(2 * np.pi * 500 * t)).astype(np.float32)
    sig[8000:8150] *= 0.03
    path = str(tmp_path / "x.wav")
    audio_io.write_wav(path, np.stack([sig, sig], 1), sr)
    out = dropouts.process_heuristic(path, fft_size=64, fft_overlap=4,
                                     num_bands=6, f_lower=100.0,
                                     f_upper=1000.0, max_width=0.08)
    data, _, _ = audio_io.read_file(str(out))
    assert np.all(np.isfinite(data))


def test_narrowband_iir_finite_on_long_signal(rng):
    """Narrow low-frequency band-pass over ~1e5 samples: the scan's 2x2
    prefix products must run at full float32 precision (a bf16 or TF32
    default matmul's error compounds multiplicatively and overflows to NaN)."""
    from pyaudiorestoration_tpu.ops import filters

    x = rng.standard_normal(120000).astype(np.float32)
    y = np.asarray(filters.butter_bandpass_filter(x, 99, 158, 22050, order=3))
    assert np.all(np.isfinite(y))
    yh = np.asarray(filters.butter_bandpass_filter(x, 99, 158, 22050,
                                                   order=3, backend="host"))
    snr = 10 * np.log10(np.mean(yh ** 2) / np.mean((y - yh) ** 2))
    assert snr > 40.0
