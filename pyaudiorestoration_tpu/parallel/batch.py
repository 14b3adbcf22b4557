"""Data-parallel batch restoration over the ``files`` mesh axis.

The reference loops file lists sequentially (resampling.py:168,
dropouts_gui.py:121-135); here a batch of recordings shards across devices
as the ``files`` axis while each recording's time axis shards over ``time``
(parallel/sharded.restore_step).
"""

from __future__ import annotations

import numpy as np

from ..utils import audio_io
from . import mesh as pmesh
from . import sharded

__all__ = ["load_batch", "restore_batch", "restore_batch_files",
           "restore_batch_files_fused", "restore_file_sharded",
           "lag_resample_file_sharded", "validate_plan"]


def load_batch(paths, multiple: int = 1, channel: int = 0,
               reflect_tail: int = 0):
    """Read files into a zero-padded (files, time) batch.

    All files must share a sample rate; lengths pad to the maximum, rounded
    up to ``multiple`` (the mesh's time-shard granularity).

    ``reflect_tail``: continue each row past its real end with the take's
    REFLECTION for this many samples (zeros after).  This is the solo
    restoration path's boundary convention (``track_speed_device`` reflect-
    pads by n_fft//2), so a padded row tracks bit-identically to its solo
    run — pass ``reflect_tail=n_fft`` together with
    ``restore_fused_sharded(..., lengths=...)``.
    Returns (batch, sr, lengths).
    """
    signals, srs = [], []
    for p in paths:
        sig, sr, _ = audio_io.read_file(p)
        signals.append(sig[:, channel])
        srs.append(sr)
    if len(set(srs)) != 1:
        raise ValueError(f"Sample rates differ: {srs}")
    lengths = [len(s) for s in signals]
    n = max(lengths) + reflect_tail
    n = -(-n // multiple) * multiple
    batch = np.zeros((len(signals), n), dtype=np.float32)
    for i, s in enumerate(signals):
        batch[i, :len(s)] = s
        reflect_continue(batch[i], len(s), reflect_tail)
    return batch, srs[0], lengths


def reflect_continue(row, L, tail):
    """Continue ``row`` past its real end ``L`` with the take's clamped
    single reflection for up to ``tail`` samples, in place.

    THE host-side twin of the device ``reflect_row`` in
    ``restore_fused_sharded`` (respeeder_device.py: src = clip(2(L-1)-pos,
    0, ...)); keep the two in lockstep — every batched tier's bit-parity
    with the solo restore rides on the boundary convention matching.
    Handles tails longer than the take (the reflection clamps at sample 0
    rather than crashing or zero-filling)."""
    k = min(len(row) - L, tail)
    if k <= 0 or L < 1:
        return row
    idx = np.clip(2 * (L - 1) - (L + np.arange(k)), 0, L - 1)
    row[L:L + k] = row[idx]
    return row


def restore_batch(mesh, batch, f0_hz, sr, **kwargs):
    """Sharded restore step over an already-built (files, time) batch."""
    xs = pmesh.shard_time_batch(mesh, batch)
    return sharded.restore_step(mesh, xs, f0_hz, sr, **kwargs)


def validate_plan(base_int, base_frac, step: int, t_real: int,
                  slack: int, wrap_bits: int = 32):
    """Unwrap one take's (possibly mod-``2**wrap_bits`` wrapped) plan anchors
    and check the fused step's advance invariant before compaction.

    The dithered plan guarantees segment t's sinc window starts within
    ``nt + drift + base_slack`` of ``t*step`` ("one hop by construction",
    restore_fused_sharded) — the one invariant a halo-exchange, carry-combine
    or dither bug would break while still producing a plausibly-shaped
    output.  Past 2**31 input samples the device plan wraps (int32), so the
    check runs on :func:`sharded.unwrap_base_int`'s int64 reconstruction —
    this is the production consumer of the unwrap contract.  Reference
    anchor: the implicit-int64 float64 planner, resampling.py:93-137.
    """
    pos = sharded.unwrap_base_int(base_int[:t_real], base_frac[:t_real],
                                  bits=wrap_bits)
    want = np.arange(t_real, dtype=np.float64) * step
    err = np.abs(pos - want)
    if err.size and err.max() > slack:
        t_bad = int(err.argmax())
        raise RuntimeError(
            f"sharded plan violates the one-hop advance invariant at segment "
            f"{t_bad}: window start {pos[t_bad]:.1f} vs expected "
            f"~{want[t_bad]:.0f} (|err| {err.max():.1f} > slack {slack}); "
            f"refusing to write a corrupt export")
    return pos


def restore_batch_files_fused(paths, f0_hz=None, tolerance_st: float = 1.0,
                              fft_size: int = 4096, fft_overlap: int = 8,
                              zeropad: int = 2, sinc_quality: int = 50,
                              drift: int = 32, n_files_axis=None,
                              out_suffix="_res", _wrap_bits: int = 32):
    """End-to-end FAST-TIER batch restore over the mesh: read files ->
    ('files','time') mesh -> ``restore_fused_sharded`` (banded-DFT tracking,
    exact dithered plan, quality-taps banded sinc — the same kernels as the
    single-chip flagship) -> host compaction -> write ``*_res`` files.

    Each file tracks its OWN speed curve (independent takes).  Files pad to
    a common length, but the pad does NOT perturb the result: rows carry the
    solo reflect continuation (``load_batch(reflect_tail=n_fft)``) and the
    per-take ``lengths`` mask the centering mean and the sinc tail, so every
    take's output is bit-identical to its solo dense restore.
    ``f0_hz=None`` probes the pilot tone from the first file.
    """
    import jax

    from ..pipelines.respeeder_device import _band_limits, _probe_f0

    step = fft_size // fft_overlap
    n_dev = len(jax.devices())
    n_files_axis = n_files_axis or max(1, min(len(paths), n_dev))
    while n_dev % n_files_axis:
        n_files_axis -= 1
    mesh = pmesh.make_mesh(n_files=n_files_axis, n_time=n_dev // n_files_axis)
    n_time = mesh.shape["time"]
    out_paths = []
    for i in range(0, len(paths), n_files_axis):
        group = paths[i:i + n_files_axis]
        pad_group = list(group) + [group[-1]] * (n_files_axis - len(group))
        batch, sr, lengths = load_batch(pad_group, multiple=n_time * step,
                                        reflect_tail=fft_size)
        n = batch.shape[1]
        if f0_hz is None:
            f0_hz = _probe_f0(batch[0], sr)
        NLv, NUv = _band_limits(f0_hz, tolerance_st, fft_size, zeropad, sr)
        F = n // step + 1
        NL = np.full(F, NLv, np.int32)
        NU = np.full(F, NUv, np.int32)
        xs = pmesh.shard_time_batch(mesh, batch)
        padded, nn, bi, bf = sharded.restore_fused_sharded(
            mesh, xs, NL, NU, fft_size, step, zeropad,
            max_n=int(step * 1.25), nt=int(sinc_quality), drift=drift,
            lengths=lengths, wrap_bits=_wrap_bits)
        padded = np.asarray(padded)
        nn = np.asarray(nn)
        bi, bf = np.asarray(bi), np.asarray(bf)
        slack = int(sinc_quality) + drift + 16 + 2  # nt+drift+base_slack
        for j, (path, row, counts, length) in enumerate(
                zip(group, padded, nn, lengths)):
            t_real = min(len(counts), length // step)  # the solo segment count
            validate_plan(bi[j], bf[j], step, t_real, slack,
                          wrap_bits=_wrap_bits)
            flat = sharded.compact_padded_host(row[:t_real], counts[:t_real])
            out_paths.append(audio_io.write_file(path, flat, sr, 1,
                                                 suffix=out_suffix))
    return out_paths


def restore_file_sharded(path, f0_hz=None, tolerance_st: float = 1.0,
                         fft_size: int = 4096, fft_overlap: int = 8,
                         zeropad: int = 2, sinc_quality: int = 50,
                         drift: int = 32, out_suffix="_res",
                         _wrap_bits: int = 32):
    """ALL channels of one recording through the mesh fast tier with the
    reference's shared-curve export contract (resampling.py:211-231):
    channels ride the ``files`` axis, ``share_curve=True`` broadcasts
    channel 0's tracked curve over it, and the time axis shards the
    recording.  Writes one multi-channel ``*_res`` file."""
    import jax

    from ..pipelines.respeeder_device import _band_limits, _probe_f0

    step = fft_size // fft_overlap
    sig, sr, C = audio_io.read_file(path)
    n_dev = len(jax.devices())
    n_files_axis = max(1, min(C, n_dev))
    while n_dev % n_files_axis:
        n_files_axis -= 1
    rows = -(-C // n_files_axis) * n_files_axis
    mesh = pmesh.make_mesh(n_files=n_files_axis, n_time=n_dev // n_files_axis)
    n_time = mesh.shape["time"]
    mult = n_time * step
    n = -(-sig.shape[0] // mult) * mult
    batch = np.zeros((rows, n), np.float32)
    batch[:C] = np.pad(sig.T, ((0, 0), (0, n - sig.shape[0])))
    if f0_hz is None:
        f0_hz = _probe_f0(batch[0], sr)
    NLv, NUv = _band_limits(f0_hz, tolerance_st, fft_size, zeropad, sr)
    F = n // step + 1
    NL = np.full(F, NLv, np.int32)
    NU = np.full(F, NUv, np.int32)
    xs = pmesh.shard_time_batch(mesh, batch)
    padded, nn, bi, bf = sharded.restore_fused_sharded(
        mesh, xs, NL, NU, fft_size, step, zeropad, max_n=int(step * 1.25),
        nt=int(sinc_quality), drift=drift, share_curve=True,
        wrap_bits=_wrap_bits)
    padded = np.asarray(padded)
    counts = np.asarray(nn)[0]
    t_real = min(len(counts), -(-sig.shape[0] // step))
    validate_plan(np.asarray(bi)[0], np.asarray(bf)[0], step, t_real,
                  int(sinc_quality) + drift + 16 + 2, wrap_bits=_wrap_bits)
    out = np.stack([sharded.compact_padded_host(padded[c][:t_real],
                                                counts[:t_real])
                    for c in range(C)], axis=-1)
    return audio_io.write_file(path, out, sr, C, suffix=out_suffix)


def lag_resample_file_sharded(path, sampletimes_s, lags_s, hop: int = 256,
                              sinc_quality: int = 50, drift: int = 32,
                              out_suffix="_res"):
    """The tapesynch export on the mesh: resample ALL channels of ``path``
    through one lag curve (seconds), channels riding the files axis and the
    recording sharded along time (``sharded.lag_resample_sharded``).

    Fixed-length output (the reference's variable-length tail trim happens
    at file write: samples past the input end read zeros).  Writes one
    multi-channel ``*_res`` file; reference semantics
    pytapesynch_gui.py:145-155 / resampling.py:189-206."""
    import jax

    sig, sr, C = audio_io.read_file(path)
    st = np.asarray(sampletimes_s, np.float64) * sr
    lg = np.asarray(lags_s, np.float64) * sr
    n_dev = len(jax.devices())
    n_files_axis = max(1, min(C, n_dev))
    while n_dev % n_files_axis:
        n_files_axis -= 1
    rows = -(-C // n_files_axis) * n_files_axis
    mesh = pmesh.make_mesh(n_files=n_files_axis, n_time=n_dev // n_files_axis)
    mult = mesh.shape["time"] * hop
    n = -(-sig.shape[0] // mult) * mult
    batch = np.zeros((rows, n), np.float32)
    batch[:C] = np.pad(sig.T, ((0, 0), (0, n - sig.shape[0])))
    xs = pmesh.shard_time_batch(mesh, batch)
    out = np.asarray(sharded.lag_resample_sharded(
        mesh, xs, st, lg, hop=hop, nt=int(sinc_quality), drift=drift))
    return audio_io.write_file(path, out[:C, :sig.shape[0]].T, sr, C,
                               suffix=out_suffix)


def restore_batch_files(paths, f0_hz, n_files_axis=None, out_suffix="_res", **kwargs):
    """End-to-end: read files -> mesh -> sharded restore -> write outputs."""
    import jax

    n_dev = len(jax.devices())
    n_files_axis = n_files_axis or max(1, min(len(paths), n_dev))
    while n_dev % n_files_axis:
        n_files_axis -= 1
    mesh = pmesh.make_mesh(n_files=n_files_axis, n_time=n_dev // n_files_axis)
    n_time = mesh.shape["time"]
    step = kwargs.get("step", 128)
    out_paths = []
    for i in range(0, len(paths), n_files_axis):
        group = paths[i:i + n_files_axis]
        pad_group = list(group) + [group[-1]] * (n_files_axis - len(group))
        batch, sr, lengths = load_batch(pad_group, multiple=n_time * step)
        out = np.asarray(restore_batch(mesh, batch, f0_hz, sr, **kwargs))
        for path, row, length in zip(group, out, lengths):
            out_paths.append(audio_io.write_file(path, row[:length], sr, 1,
                                                 suffix=out_suffix))
    return out_paths
