"""Audio file I/O backed by the native C++ ``audioio`` runtime.

Mirrors the API surface of the reference's ``util/io_ops.py`` (read_file /
write_file, /root/reference/util/io_ops.py:7-23) but is built on a first-party
C++ WAV+FLAC codec (``../native/audioio.cpp``) instead of libsndfile.

The native library is compiled on demand with ``make`` the first time it is
needed on each host, into a directory keyed by the sources and the host's
CPU; a pure-Python WAV fallback (via :mod:`scipy.io.wavfile`) covers
environments without a C++ toolchain (FLAC requires the native library).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")

_lib = None
_lib_lock = threading.Lock()


def _host_build_key() -> str:
    """Digest of what the native build depends on: the committed sources
    and this host's CPU (the Makefile compiles with ``-march=native``, so a
    library built on another machine must never load here)."""
    h = hashlib.sha256()
    for name in ("audioio.cpp", "Makefile"):
        with open(os.path.join(_NATIVE_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(platform.machine().encode())
    try:
        with open("/proc/cpuinfo") as f:
            h.update("".join(sorted({ln for ln in f if ln.startswith(
                ("model name", "flags", "vendor_id"))})).encode())
    except OSError:
        h.update(platform.processor().encode())
    return h.hexdigest()[:16]


def _lib_path() -> str:
    """AUDIOIO_LIB overrides the codec library path (e.g. an ASAN-
    instrumented build for memory diagnostics); otherwise the library lives
    in ``native/build/<host key>/`` (ignored by git)."""
    return os.environ.get("AUDIOIO_LIB") or os.path.join(
        _NATIVE_DIR, "build", _host_build_key(), "libaudioio.so")


def _build_native(path: str) -> bool:
    """Build the library into ``path`` through a private temporary name, so
    concurrent builders (test workers) never load a half-written file."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        # bounded: a stuck toolchain/filesystem must fail the build, not
        # hang every caller (the doctor health check relies on this)
        subprocess.run(
            ["make", "-s", f"OUT={tmp}"], cwd=_NATIVE_DIR, check=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=300,
        )
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        logging.exception("Building native audioio failed")
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _get_lib():
    """Load (building if necessary) the native audioio library, or None."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        if not os.path.isfile(path) and not _build_native(path):
            return None
        lib = ctypes.CDLL(path)
        lib.audioio_open.restype = ctypes.c_void_p
        lib.audioio_open.argtypes = [ctypes.c_char_p]
        lib.audioio_sample_rate.restype = ctypes.c_int
        lib.audioio_sample_rate.argtypes = [ctypes.c_void_p]
        lib.audioio_channels.restype = ctypes.c_int
        lib.audioio_channels.argtypes = [ctypes.c_void_p]
        lib.audioio_frames.restype = ctypes.c_longlong
        lib.audioio_frames.argtypes = [ctypes.c_void_p]
        lib.audioio_read.restype = ctypes.c_int
        lib.audioio_read.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.audioio_close.restype = None
        lib.audioio_close.argtypes = [ctypes.c_void_p]
        lib.audioio_write_wav_f32.restype = ctypes.c_int
        lib.audioio_write_wav_f32.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ]
        lib.audioio_write_wav_pcm16.restype = ctypes.c_int
        lib.audioio_write_wav_pcm16.argtypes = lib.audioio_write_wav_f32.argtypes
        lib.audioio_stream_open.restype = ctypes.c_void_p
        lib.audioio_stream_open.argtypes = [ctypes.c_char_p]
        lib.audioio_stream_sample_rate.restype = ctypes.c_int
        lib.audioio_stream_sample_rate.argtypes = [ctypes.c_void_p]
        lib.audioio_stream_channels.restype = ctypes.c_int
        lib.audioio_stream_channels.argtypes = [ctypes.c_void_p]
        lib.audioio_stream_frames.restype = ctypes.c_longlong
        lib.audioio_stream_frames.argtypes = [ctypes.c_void_p]
        lib.audioio_stream_read.restype = ctypes.c_int
        lib.audioio_stream_read.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_float)]
        lib.audioio_stream_close.restype = None
        lib.audioio_stream_close.argtypes = [ctypes.c_void_p]
        lib.audioio_write_flac.restype = ctypes.c_int
        lib.audioio_write_flac.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.audioio_flac_wopen.restype = ctypes.c_void_p
        lib.audioio_flac_wopen.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.audioio_flac_wwrite.restype = ctypes.c_int
        lib.audioio_flac_wwrite.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_longlong]
        lib.audioio_flac_wclose.restype = ctypes.c_int
        lib.audioio_flac_wclose.argtypes = [ctypes.c_void_p]
        lib.audioio_probe.restype = ctypes.c_int
        lib.audioio_probe.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)]
        _lib = lib
    return _lib


def probe_file(path):
    """Header-only (sample_rate, channels, frames) — no decode, no frame
    index; the auto-stream thresholds' fast path.  frames can be 0 for a
    FLAC whose STREAMINFO omits the total; callers fall back to opening a
    StreamReader then."""
    import ctypes

    lib = _get_lib()
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    fr = ctypes.c_longlong()
    rc = lib.audioio_probe(str(path).encode(), ctypes.byref(sr),
                           ctypes.byref(ch), ctypes.byref(fr))
    if rc != 0:
        raise OSError(f"cannot probe {path}")
    return int(sr.value), int(ch.value), int(fr.value)


class StreamReader:
    """Random-access block reader over an audio file (native runtime).

    WAV streams directly from disk (no full decode); FLAC maps the
    container, indexes frame offsets once at open, and decodes only the
    frames a read touches (round 3 — previously FLAC fell back to a full
    in-memory decode, defeating the larger-than-memory paths for the very
    files they target).  Usage::

        with StreamReader(path) as r:
            block = r.read(start_frame, num_frames)   # (num, channels) f32
    """

    def __init__(self, path):
        lib = _get_lib()
        if lib is None:
            raise OSError("native audioio unavailable")
        self._lib = lib
        self._h = lib.audioio_stream_open(os.fsencode(path))
        if not self._h:
            raise OSError(f"Cannot open {path}")
        self.sample_rate = lib.audioio_stream_sample_rate(self._h)
        self.channels = lib.audioio_stream_channels(self._h)
        self.frames = lib.audioio_stream_frames(self._h)

    def read(self, start, count):
        count = min(count, self.frames - start)
        out = np.empty((count, self.channels), dtype=np.float32)
        ret = self._lib.audioio_stream_read(
            self._h, int(start), int(count),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if ret != 0:
            raise OSError(f"stream read failed at {start} (+{count}): {ret}")
        return out

    def close(self):
        if self._h:
            self._lib.audioio_stream_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class StreamWriter:
    """Incremental float32 WAV writer (header patched on close).

    The output half of the larger-than-memory path: restored blocks append
    as they leave the device, so peak host memory stays one block regardless
    of recording length (reference pattern: experiments/pyrespeeder_cmd.py:
    91-120 writes blockwise with soundfile).
    """

    # fixed header layout (offsets): RIFF/RF64 @0, riff size @4, WAVE @8,
    # JUNK/ds64 @12 (28-byte payload @20, the BWF RF64 reservation pattern),
    # fmt @48 (16-byte payload @56), fact @72 (dwSampleLength @80),
    # data @84 (size @88), samples from @92
    _DS64_OFF, _FACT_OFF, _DATA_SIZE_OFF, _DATA_START = 12, 80, 88, 92

    def __init__(self, path, sr, channels, force_rf64=False):
        self.path = path
        self.sr = int(sr)
        self.channels = int(channels)
        self.frames = 0
        self.force_rf64 = force_rf64  # testing hook for the > 4 GiB path
        self._f = open(path, "wb")
        f = self._f
        f.write(b"RIFF" + (0).to_bytes(4, "little") + b"WAVE")
        # 28-byte JUNK reservation: rewritten in place as ds64 when the
        # final size exceeds the 32-bit RIFF fields (EBU Tech 3306)
        f.write(b"JUNK" + (28).to_bytes(4, "little") + b"\x00" * 28)
        f.write(b"fmt " + (16).to_bytes(4, "little"))
        f.write((3).to_bytes(2, "little"))                      # IEEE float
        f.write(self.channels.to_bytes(2, "little"))
        f.write(self.sr.to_bytes(4, "little"))
        f.write((self.sr * self.channels * 4).to_bytes(4, "little"))
        f.write((self.channels * 4).to_bytes(2, "little"))
        f.write((32).to_bytes(2, "little"))
        # non-PCM formats require a fact chunk
        f.write(b"fact" + (4).to_bytes(4, "little") + (0).to_bytes(4, "little"))
        f.write(b"data" + (0).to_bytes(4, "little"))
        assert f.tell() == self._DATA_START

    def write(self, block):
        block = np.ascontiguousarray(np.asarray(block, dtype=np.float32))
        if block.ndim == 1:
            block = block[:, None]
        assert block.shape[1] == self.channels
        self._f.write(block.tobytes())
        self.frames += block.shape[0]

    def close(self):
        if self._f is None:
            return
        data_len = self.frames * self.channels * 4
        riff_size = self._DATA_START - 8 + data_len
        f = self._f
        u32_max = 0xFFFFFFFF
        if riff_size <= u32_max and self.frames <= u32_max and not self.force_rf64:
            f.seek(4)
            f.write(riff_size.to_bytes(4, "little"))
            f.seek(self._FACT_OFF)
            f.write(self.frames.to_bytes(4, "little"))
            f.seek(self._DATA_SIZE_OFF)
            f.write(data_len.to_bytes(4, "little"))
        else:
            # > 4 GiB: finalize as RF64 — sizes move to the ds64 chunk and
            # the 32-bit fields hold the 0xFFFFFFFF sentinel
            f.seek(0)
            f.write(b"RF64" + u32_max.to_bytes(4, "little"))
            f.seek(self._DS64_OFF)
            f.write(b"ds64" + (28).to_bytes(4, "little")
                    + riff_size.to_bytes(8, "little")
                    + data_len.to_bytes(8, "little")
                    + self.frames.to_bytes(8, "little")
                    + (0).to_bytes(4, "little"))
            f.seek(self._FACT_OFF)
            f.write(u32_max.to_bytes(4, "little"))
            f.seek(self._DATA_SIZE_OFF)
            f.write(u32_max.to_bytes(4, "little"))
        f.close()
        self._f = None
        logging.info(f"Wrote {self.path} ({self.frames} frames, streamed)")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FlacStreamWriter:
    """Incremental FLAC writer (native encoder; STREAMINFO patched on close).

    The archive-format counterpart of :class:`StreamWriter`: restored blocks
    append as they leave the device and are encoded frame-by-frame (4096
    samples, carry-buffered), so a multi-hour export writes compressed FLAC
    with one block of peak memory.  The reference can only write WAV
    (io_ops.py:19-23).  Same ``write(block)/close()`` contract as
    StreamWriter; quantizes to ``bits`` (16 or 24).
    """

    def __init__(self, path, sr, channels, bits=24, level=1):
        lib = _get_lib()
        if lib is None:
            raise OSError("native audioio unavailable (FLAC needs it)")
        self._lib = lib
        self.path = path
        self.sr = int(sr)
        self.channels = int(channels)
        self.bits = int(bits)
        self.level = int(level)
        self.frames = 0
        self._h = lib.audioio_flac_wopen(os.fsencode(path), self.channels,
                                         self.sr, self.bits, self.level)
        if not self._h:
            raise OSError(f"Cannot open FLAC writer for {path}")

    def write(self, block):
        block = np.ascontiguousarray(np.asarray(block, dtype=np.float32))
        if block.ndim == 1:
            block = block[:, None]
        assert block.shape[1] == self.channels
        rc = self._lib.audioio_flac_wwrite(
            self._h, block.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            block.shape[0])
        if rc != 0:
            raise OSError(f"FLAC stream write failed for {self.path}")
        self.frames += block.shape[0]

    def close(self):
        if self._h is None:
            return
        rc = self._lib.audioio_flac_wclose(self._h)
        self._h = None
        if rc != 0:
            try:
                os.remove(self.path)
            finally:
                raise OSError(f"FLAC stream finalize failed for {self.path}")
        logging.info(f"Wrote {self.path} ({self.frames} frames, streamed FLAC)")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def open_writer(path, sr, channels, bits=None, level=None):
    """Streaming writer for ``path`` chosen by extension: ``.flac`` gets the
    native incremental FLAC encoder (``level``: 0 fast / 1 small), anything
    else float32 WAV/RF64.  ``bits``/``level`` default to the process-wide
    :func:`set_output_format` settings so ``--flac-out BITS --flac-fast``
    applies to streamed exports exactly like in-memory ones."""
    if str(path).lower().endswith(".flac"):
        return FlacStreamWriter(path, sr, channels,
                                bits=_OUT_FLAC_BITS if bits is None else bits,
                                level=_OUT_FLAC_LEVEL if level is None else level)
    return StreamWriter(path, sr, channels)


def read_file(audio_path):
    """Read an audio file (WAV or FLAC).

    Returns ``(signal, sample_rate, num_channels)`` with ``signal`` a float32
    array of shape ``(frames, channels)`` — the same contract as the
    reference's ``io_ops.read_file`` (io_ops.py:7-16).
    """
    lib = _get_lib()
    if lib is not None:
        handle = lib.audioio_open(os.fsencode(audio_path))
        if handle:
            try:
                sr = lib.audioio_sample_rate(handle)
                channels = lib.audioio_channels(handle)
                frames = lib.audioio_frames(handle)
                signal = np.empty((frames, channels), dtype=np.float32)
                lib.audioio_read(handle, signal.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            finally:
                lib.audioio_close(handle)
            if frames == 0:
                raise AttributeError(f"Reading {audio_path} produced no samples")
            return signal, sr, channels
        raise OSError(f"Native audioio failed to decode {audio_path}")
    # Fallback: WAV only.
    from scipy.io import wavfile

    sr, data = wavfile.read(audio_path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = data[:, None]
    return data, int(sr), data.shape[1]


def write_flac(path, signal, sr, bits_per_sample=16, level=1):
    """Write a FLAC file (fixed predictors + rice residuals, native encoder).

    The reference can only write WAV (io_ops.py:19-23); tape archives live
    as FLAC, so the framework writes the archive format too.  ``signal``:
    (n,) or (n, C) float in [-1, 1], quantized to 16 or 24 bits.  Verified
    bit-exact through the native decoder (tests/test_audio_io.py).

    ``level`` trades compression for codec speed like the flac tool's
    -0/-8 presets: 0 = fixed predictors only (fast encode AND ~2.5x faster
    decode of the produced file), 1 = +LPC candidate (default, smallest)."""
    import ctypes

    lib = _get_lib()
    x = np.ascontiguousarray(np.asarray(signal, np.float32))
    if x.ndim == 1:
        x = x[:, None]
    rc = lib.audioio_write_flac(
        str(path).encode(), x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        x.shape[0], x.shape[1], int(sr), int(bits_per_sample), int(level))
    if rc != 0:
        raise OSError(f"FLAC write failed ({rc}) for {path}")
    return path


def write_wav(path, signal, sr, subtype="FLOAT"):
    """Write interleaved float32 WAV. signal: (frames,) or (frames, channels)."""
    signal = np.ascontiguousarray(np.asarray(signal, dtype=np.float32))
    if signal.ndim == 1:
        signal = signal[:, None]
    frames, channels = signal.shape
    lib = _get_lib()
    if lib is not None:
        fn = lib.audioio_write_wav_f32 if subtype == "FLOAT" else lib.audioio_write_wav_pcm16
        ret = fn(
            os.fsencode(path), signal.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            frames, channels, int(sr),
        )
        if ret != 0:
            raise OSError(f"Native audioio failed to write {path}")
        return
    from scipy.io import wavfile

    wavfile.write(path, int(sr), signal if subtype == "FLOAT" else
                  (np.clip(signal, -1, 1) * 32767).astype(np.int16))


# process-wide export format: every tool's write_file call honours it, so
# one CLI flag (--flac-out) switches the whole pipeline's outputs to the
# archive format without threading a parameter through nine tools
_OUT_FORMAT = "wav"
_OUT_FLAC_BITS = 24
_OUT_FLAC_LEVEL = 1


def set_output_format(fmt, bits=24, level=1):
    """Select the export container for write_file: "wav" (float32, default)
    or "flac" (native encoder, quantized to ``bits`` — 16 or 24).  ``level``
    is the FLAC speed/size preset (0 = fixed-only fast, 1 = +LPC)."""
    global _OUT_FORMAT, _OUT_FLAC_BITS, _OUT_FLAC_LEVEL
    if fmt not in ("wav", "flac"):
        raise ValueError(f"unknown output format {fmt!r}")
    if fmt == "flac" and bits not in (16, 24):
        raise ValueError("FLAC output must be 16 or 24 bit")
    if level not in (0, 1):
        raise ValueError("FLAC level must be 0 (fast) or 1 (small)")
    _OUT_FORMAT = fmt
    _OUT_FLAC_BITS = int(bits)
    _OUT_FLAC_LEVEL = int(level)


def out_ext():
    """Current export extension ("wav" or "flac") — pipelines that build
    output paths by hand use this so streamed exports honour the format."""
    return _OUT_FORMAT


def write_file(audio_path, signal, sr, channels=None, suffix="_out"):
    """Write ``signal`` to ``<audio_path without ext><suffix>.<ext>``.

    Mirrors io_ops.write_file (io_ops.py:19-23) but honours
    :func:`set_output_format` (the reference writes float32 WAV only);
    returns the output path.
    """
    out_path = f"{os.path.splitext(audio_path)[0]}{suffix}.{_OUT_FORMAT}"
    if _OUT_FORMAT == "flac":
        write_flac(out_path, signal, sr, _OUT_FLAC_BITS, _OUT_FLAC_LEVEL)
    else:
        write_wav(out_path, signal, sr)
    logging.info(f"Wrote {out_path}")
    return out_path
