"""Time-sharded STFT / iSTFT / restoration step with halo exchange between devices.

The reference's answer to long recordings is blockwise streaming with
``overlap*hop`` halos and boundary trimming (experiments/pyrespeeder_cmd.py:
16-49); here the time axis shards across devices instead, and the halos are
``jax.lax.ppermute`` neighbor exchanges inside ``shard_map``:

* STFT: a frame straddling a shard boundary needs ``n_fft - step`` samples
  from the right neighbor -> one left-directed ppermute before framing.
* iSTFT overlap-add: each shard's trailing ``n_fft - step`` samples belong to
  the right neighbor's head -> one right-directed ppermute plus an add.
* The varispeed resamplers run the banded shift-MAC within a bounded
  drift halo (segment-local anchors keep windows shard-local).

All functions are pure and jit/shard_map compiled; they compose into
``restore_step`` — the flagship "training-step equivalent" that the multichip
dry-run compiles over a ('files', 'time') mesh.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.fourier import get_window

__all__ = ["stft_sharded", "istft_sharded", "restore_step", "halo_exchange_right",
           "hpss_sharded", "cog_sharded", "renoise_sharded", "heal_sharded",
           "restore_fused_sharded", "compact_padded_host",
           "adaptive_peak_sharded", "lag_resample_sharded"]


_EXEC_CACHE: dict = {}


def _mesh_key(mesh: Mesh):
    return (tuple(d.id for d in mesh.devices.flat), mesh.axis_names,
            tuple(mesh.shape.items()))


def _cached_exec(key, build, cap: int = 64):
    """Per-(mesh, static-config, shapes) cache of jitted shard_map callables.

    Every public entry here builds its shard_map over a fresh Python closure;
    without this cache each CALL would retrace and recompile the collective
    program (measured 5.9 s vs 60 ms warm on the fused step).  LRU-capped so
    shape churn cannot grow the cache without bound."""
    fn = _EXEC_CACHE.pop(key, None)
    if fn is None:
        fn = build()
        if len(_EXEC_CACHE) >= cap:
            _EXEC_CACHE.pop(next(iter(_EXEC_CACHE)))
    _EXEC_CACHE[key] = fn
    return fn


def _left_ppermute(x, axis_name, n_shards):
    """Send my leading block to my left neighbor (receive from the right;
    last shard receives zeros)."""
    perm = [(d, d - 1) for d in range(1, n_shards)]
    return jax.lax.ppermute(x, axis_name, perm)


def _right_ppermute(x, axis_name, n_shards):
    """Send my block to my right neighbor (first shard receives zeros)."""
    perm = [(d, d + 1) for d in range(n_shards - 1)]
    return jax.lax.ppermute(x, axis_name, perm)


def halo_exchange_right(local, halo: int, axis_name: str, n_shards: int):
    """Append the right neighbor's first ``halo`` samples along the last axis."""
    head = local[..., :halo]
    recv = _left_ppermute(head, axis_name, n_shards)
    return jnp.concatenate([local, recv], axis=-1)


def _stft_local(x_ext, n_fft: int, step: int, window, zeropad: int, n_frames: int):
    if n_fft % step == 0:
        # static shifted views instead of a gather with a baked index constant
        ratio = n_fft // step
        need = (n_frames + ratio - 1) * step
        xb = jnp.pad(x_ext, [(0, 0)] * (x_ext.ndim - 1)
                     + [(0, max(0, need - x_ext.shape[-1]))])[..., :need]
        blocks = xb.reshape(*xb.shape[:-1], -1, step)
        frames = jnp.concatenate(
            [blocks[..., j:j + n_frames, :] for j in range(ratio)], axis=-1)
    else:
        i0 = jax.lax.broadcasted_iota(jnp.int32, (n_frames, n_fft), 0) * step
        i1 = jax.lax.broadcasted_iota(jnp.int32, (n_frames, n_fft), 1)
        frames = x_ext[..., i0 + i1]
    frames = frames * window
    spec = jnp.fft.rfft(frames, n=n_fft * zeropad, axis=-1)
    return jnp.swapaxes(spec, -1, -2) / np.sqrt(n_fft)  # (..., F, T_local)


def stft_sharded(mesh: Mesh, x, n_fft: int = 1024, step: int = 256,
                 window_name: str = "blackmanharris", zeropad: int = 1):
    """STFT of a (files, time) batch sharded over the mesh.

    Left-aligned frames (center=False): global frame t covers samples
    [t*step, t*step + n_fft).  Output (files, n_freqs, n_frames) sharded as
    (files, None, time).  Requires local_len % step == 0.
    """
    n_time = mesh.shape["time"]
    batch, total = x.shape
    local = total // n_time
    assert local % step == 0, "local shard length must be a multiple of step"
    halo = n_fft - step
    window = jnp.asarray(get_window(window_name, n_fft))
    n_frames_local = local // step

    def fn(xb):  # xb: (B_local, local)
        ext = halo_exchange_right(xb, halo, "time", n_time)
        return _stft_local(ext, n_fft, step, window, zeropad, n_frames_local)

    key = ("stft", _mesh_key(mesh), x.shape, n_fft, step, window_name, zeropad)
    return _cached_exec(key, lambda: jax.jit(shard_map(
        fn, mesh=mesh,
        in_specs=P("files", "time"),
        out_specs=P("files", None, "time"),
    )))(x)


def istft_sharded(mesh: Mesh, spec, n_fft: int = 1024, step: int = 256,
                  window_name: str = "blackmanharris"):
    """Inverse of ``stft_sharded`` (least-squares OLA, periodic interior
    normalization).  spec: (files, F, T) sharded (files, None, time); returns
    (files, time) samples."""
    n_time = mesh.shape["time"]
    halo = n_fft - step
    window = np.asarray(get_window(window_name, n_fft), dtype=np.float64)
    # periodic interior window-sumsquare envelope (one hop period)
    wss = np.zeros(step)
    for k in range(n_fft // step + 2):
        seg = window[k * step:(k + 1) * step] ** 2
        wss[:len(seg)] += seg
    wss = np.maximum(wss, np.finfo(np.float32).tiny).astype(np.float32)

    assert n_fft % step == 0, "sharded iSTFT requires hop | n_fft"
    ratio = n_fft // step

    def fn(sb):  # (B_local, F, T_local)
        mat = sb * np.sqrt(n_fft)
        ytmp = jnp.fft.irfft(mat, n=n_fft, axis=-2)  # (B, n_fft, T_local)
        ytmp = jnp.swapaxes(ytmp, -1, -2) * jnp.asarray(window, jnp.float32)  # (B,T,n_fft)
        b, t_local, _ = ytmp.shape
        # overlap-add as ratio static shifted adds over hop blocks: frame t's
        # j-th hop chunk lands on output block t + j
        blocks = ytmp.reshape(b, t_local, ratio, step)
        n_blocks = t_local + ratio - 1  # == (t_local*step + halo) / step
        acc = jnp.zeros((b, n_blocks, step), ytmp.dtype)
        for j in range(ratio):
            acc = acc + jnp.pad(blocks[:, :, j, :], ((0, 0), (j, ratio - 1 - j), (0, 0)))
        flat = acc.reshape(b, n_blocks * step)
        local = flat[:, :t_local * step]
        tail = flat[:, t_local * step:]
        recv = _right_ppermute(tail, "time", n_time)
        local = local.at[:, :halo].add(recv)
        env = jnp.tile(jnp.asarray(wss), t_local)
        return local / env

    key = ("istft", _mesh_key(mesh), spec.shape, n_fft, step, window_name)
    return _cached_exec(key, lambda: jax.jit(shard_map(
        fn, mesh=mesh,
        in_specs=P("files", None, "time"),
        out_specs=P("files", "time"),
    )))(spec)


def hpss_sharded(mesh: Mesh, spec_mag, kernel_size: int = 31, power: float = 2.0):
    """Time-sharded HPSS masks with halo exchange for the harmonic median.

    spec_mag: (files, F, T) magnitude sharded (files, None, time).  The
    harmonic median filter runs along time and needs ``kernel_size//2``
    frames from each neighbor; the percussive median runs along frequency
    (shard-local).  Returns (mask_harm, mask_perc) with the same sharding.
    """
    from ..ops.decompose import softmask

    n_time = mesh.shape["time"]
    half = kernel_size // 2

    def fn(sb):  # (B, F, T_local)
        # bidirectional halos along time
        left_recv = _right_ppermute(sb[..., -half:], "time", n_time)
        right_recv = _left_ppermute(sb[..., :half], "time", n_time)
        ext = jnp.concatenate([left_recv, sb, right_recv], axis=-1)
        # shard_map edges (global start/end) fall back to the halo zeros;
        # emulate 'symmetric' there by reflecting the local edge
        first = jax.lax.axis_index("time") == 0
        last = jax.lax.axis_index("time") == n_time - 1
        sym_l = sb[..., :half][..., ::-1]
        sym_r = sb[..., -half:][..., ::-1]
        ext = ext.at[..., :half].set(jnp.where(first, sym_l, ext[..., :half]))
        ext = ext.at[..., -half:].set(jnp.where(last, sym_r, ext[..., -half:]))
        # harmonic: median along time via static shifted stacks
        windows = jnp.stack([ext[..., j:j + sb.shape[-1]]
                             for j in range(kernel_size)], axis=-1)
        harm = jnp.sort(windows, axis=-1)[..., half]
        # percussive: median along frequency (local)
        pad_cfg = [(0, 0)] * (sb.ndim - 2) + [(half, half), (0, 0)]
        fext = jnp.pad(sb, pad_cfg, mode="symmetric")
        fwin = jnp.stack([fext[..., j:j + sb.shape[-2], :]
                          for j in range(kernel_size)], axis=-1)
        perc = jnp.sort(fwin, axis=-1)[..., half]
        mask_h = softmask(harm, perc, power=power, split_zeros=True)
        mask_p = softmask(perc, harm, power=power, split_zeros=True)
        return mask_h, mask_p

    key = ("hpss", _mesh_key(mesh), spec_mag.shape, kernel_size, power)
    return _cached_exec(key, lambda: jax.jit(shard_map(
        fn, mesh=mesh,
        in_specs=P("files", None, "time"),
        out_specs=(P("files", None, "time"), P("files", None, "time")),
        check_vma=False,
    )))(spec_mag)


def renoise_sharded(mesh: Mesh, x, profile, gain: float, n_fft: int = 1024,
                    step: int = 256, window_name: str = "blackmanharris"):
    """Time-sharded masked denoise of a (files, time) batch: sharded STFT ->
    per-bin noise-threshold gain mask -> sharded iSTFT.

    The mask itself (renoiser_gui.py:273-278: ``gain`` dB below the profile
    threshold, 0 dB above) is elementwise per (bin, frame), so it runs
    shard-local between the two halo-exchanging transforms; ``profile`` is a
    (n_freqs,) dB threshold curve replicated to every device.
    """
    from ..pipelines.renoiser import _mask_fac

    spec = stft_sharded(mesh, x, n_fft, step, window_name)
    mag_db = 20.0 * jnp.log10(jnp.abs(spec) + 1e-7)
    # the canonical mask (same code as the dense tier, so the tiers cannot
    # drift); _mask_fac's profile[:, None] broadcasts over (files, F, T)
    fac = _mask_fac(mag_db, jnp.asarray(profile, jnp.float32), float(gain))
    return istft_sharded(mesh, spec * fac, n_fft, step, window_name)


def heal_sharded(mesh: Mesh, x, gain_db, n_fft: int = 512, step: int = 128,
                 window_name: str = "blackmanharris"):
    """Time-sharded dropout healing: sharded STFT -> marker-driven dB gain
    mask (computed on the host at frame rate by pipelines/dropouts.py's
    marker logic and passed in as ``gain_db``) -> sharded iSTFT.

    ``x``: (files, time) batch; ``gain_db``: (files, n_freqs, n_frames)
    boost mask in dB (0 = untouched), laid out to match ``stft_sharded``'s
    left-aligned frames.  The multiply is elementwise/shard-local; only the
    two transforms exchange halos.
    """
    spec = stft_sharded(mesh, x, n_fft, step, window_name)
    fac = jnp.power(10.0, jnp.asarray(gain_db, jnp.float32) / 20.0)
    return istft_sharded(mesh, spec * fac, n_fft, step, window_name)


def cog_sharded(mesh: Mesh, spec_mag, NL0, NU0, tolerance, fft_size: int, sr: int):
    """Time-sharded Center-of-Gravity tracking with cross-shard band handoff.

    The CoG tracker is sequential — frame t+1's band depends on frame t's
    result (wow_detection.py:256-291) — so the time shards form a dependency
    chain.  Each shard runs its local ``lax.scan`` exactly once, on its turn,
    starting from the (NL, NU) carry its left neighbor computed; the carry
    rides a right-directed ``ppermute`` each turn (SURVEY §7 step 7's
    "per-shard scans with boundary-state handoff").  Wall-clock stays
    sequential (inherent to the recurrence) but compute and memory are
    distributed, and the result is bit-identical to the dense scan.

    spec_mag: (files, F, T) magnitudes sharded (files, None, time);
    NL0/NU0: (files,) int32 initial band per file.  Returns (files, T) cogs.
    """
    from ..models.trackers import cog_step_core

    n_time = mesh.shape["time"]
    from ..ops.fourier import fft_freqs

    with np.errstate(divide="ignore"):
        lff = jnp.asarray(np.log2(np.maximum(
            fft_freqs(fft_size, sr), 1e-12)).astype(np.float32))

    def local_scan(sb, nl, nu):  # sb (B, F, T_local); nl/nu (B,) int32
        def step(carry, frame):  # frame (B, F)
            cnl, cnu = carry
            nl2, nu2, cog = cog_step_core(frame, cnl, cnu, lff, tolerance,
                                          fft_size, sr)
            return (nl2, nu2), cog

        (nl, nu), cogs = jax.lax.scan(step, (nl, nu), jnp.moveaxis(sb, -1, 0))
        return nl, nu, jnp.moveaxis(cogs, 0, -1)  # (B, T_local)

    def fn(sb, nl0, nu0):
        idx = jax.lax.axis_index("time")
        out0 = jnp.zeros((sb.shape[0], sb.shape[-1]), jnp.float32)

        def body(s, state):
            carry_nl, carry_nu, out = state
            my_turn = idx == s
            nl2, nu2, cogs = jax.lax.cond(
                my_turn,
                lambda args: local_scan(sb, *args),
                lambda args: (args[0], args[1], jnp.zeros_like(out)),
                (carry_nl, carry_nu))
            out = jnp.where(my_turn, cogs, out)
            # hand the carry to the right neighbor for its turn
            nl_recv = _right_ppermute(nl2, "time", n_time)
            nu_recv = _right_ppermute(nu2, "time", n_time)
            return nl_recv, nu_recv, out

        _, _, out = jax.lax.fori_loop(0, n_time, body, (nl0, nu0, out0))
        return out

    key = ("cog", _mesh_key(mesh), spec_mag.shape, float(tolerance),
           fft_size, sr)
    return _cached_exec(key, lambda: jax.jit(shard_map(
        fn, mesh=mesh,
        in_specs=(P("files", None, "time"), P("files"), P("files")),
        out_specs=P("files", "time"),
        check_vma=False,
    )))(spec_mag, NL0, NU0)


def _split_total(ci, cf, x):
    """Total of ``x`` as an exact (int32, frac<1) pair, given the exclusive
    split prefixes (ci, cf) of x.  1D; vmap for batches."""
    xi = jnp.floor(x[-1])
    s = cf[-1] + (x[-1] - xi)
    w = jnp.floor(s)
    return ci[-1] + xi.astype(jnp.int32) + w.astype(jnp.int32), s - w


def _cross_shard_exclusive(ti, tf, axis_name: str, n_shards: int):
    """Exclusive prefix of per-shard (int32, frac) totals across the mesh
    axis: all_gather the D split totals, then each shard sums its
    predecessors in split arithmetic (D is tiny, the loop is static).

    ``ti``/``tf``: (...,) local totals.  Returns the (..., ) split offset of
    this shard — the global exclusive cumsum carry the single-chip
    ``_split_cumsum_exclusive`` scan computes sequentially."""
    tis = jax.lax.all_gather(ti, axis_name)  # (D, ...)
    tfs = jax.lax.all_gather(tf, axis_name)
    idx = jax.lax.axis_index(axis_name)
    oi = jnp.zeros_like(ti)
    of = jnp.zeros_like(tf)
    for d in range(n_shards - 1):
        take = d < idx
        nf = of + jnp.where(take, tfs[d], 0.0)
        w = jnp.floor(nf)
        oi = oi + jnp.where(take, tis[d], 0) + w.astype(jnp.int32)
        of = nf - w
    return oi, of


def _sharded_split_exclusive(vals, axis_name: str, n_shards: int):
    """Globally-exclusive split cumsum of (..., T_local) positive values
    sharded along the mesh axis: shard-local exact (int, frac) prefixes plus
    one all_gather carry combine.  The distributed twin of
    ``respeeder_device._split_cumsum_exclusive``."""
    from ..pipelines.respeeder_device import _split_cumsum_exclusive

    def local(x):
        ci, cf = _split_cumsum_exclusive(x)
        ti, tf = _split_total(ci, cf, x)
        return ci, cf, ti, tf

    for _ in range(vals.ndim - 1):
        local = jax.vmap(local)
    ci, cf, ti, tf = local(vals)
    oi, of = _cross_shard_exclusive(ti, tf, axis_name, n_shards)
    nf = cf + of[..., None]
    w = jnp.floor(nf)
    return ci + oi[..., None] + w.astype(jnp.int32), nf - w


def restore_fused_sharded(mesh: Mesh, x, NL, NU, n_fft: int, step: int,
                          zeropad: int = 1, max_n: int = None, nt: int = 50,
                          drift: int = 32, window_name: str = "blackmanharris",
                          band=None, speed_curve=None, base_slack: int = 16,
                          chunk_frames: int = 4096, share_curve: bool = False,
                          lengths=None, wrap_bits: int = 32,
                          interpret: bool = False):
    """The single-chip fused restoration step on a ('files', 'time') mesh.

    Same kernels and conventions as ``respeeder_device.restore_fused_device``
    (docstring there; reference semantics resampling.py:93-137, 162-240) —
    banded-DFT matmul peak tracking, exact split-cumsum dithered position plan,
    and the gather-free banded shift-MAC sinc with quality taps — with the
    three global couplings becoming collectives:

    * speed normalization: the global log-speed mean is a ``psum`` over time
      shards (``TraceLine`` centering, markers.py:190-192);
    * the dither cumsum and the base-position cumsum: shard-local exact
      (int32, frac) prefixes plus an ``all_gather`` carry combine
      (:func:`_sharded_split_exclusive`);
    * STFT frames and sinc windows at shard boundaries: ``ppermute`` halos.

    Per-segment input advance is one hop by construction (the dithered count
    ``n_i ~ step*s_i`` cancels the ``1/s_i`` step size), so segment i's sinc
    window starts within ~1 sample of ``i*step`` and every window is
    shard-local given a ``base_slack`` halo margin.

    ``x``: (files, n) batch — each file tracks its OWN curve (the
    independent-takes contract of ``restore_fused_takes``); with
    ``share_curve=True`` every row resamples through row 0's curve instead
    (the files axis then carries the CHANNELS of one take — the reference's
    multi-channel export contract, resampling.py:211-231).  ``NL``/``NU``:
    (n_frames,) per-frame band limits shared across files (n_frames =
    n//step + 1).  ``speed_curve``: optional (files, n_frames) frame-rate
    speed override (project-replay / master-curve path, pyrespeeder_gui.py:
    133-140) — skips tracking.  Returns (padded, n, base_int, base_frac):
    (files, T, max_n) output grid and (files, T) plan arrays, T = n//step.

    Length contract: unlike the single-chip tier (HBM-bound long before
    int32), recordings past 2**31 samples are CORRECT on-device here — the
    global int32 cumsums wrap, but every on-device consumer (count diffs,
    window starts ``base_int - shard_start``) takes small DIFFERENCES of
    equally-wrapped values, which two's-complement arithmetic recovers
    exactly.  Only the RETURNED ``base_int`` is then wrapped mod 2**32;
    hosts unwrap it with :func:`unwrap_base_int` (the export wrappers in
    ``parallel.batch`` do, to validate the plan before compaction).
    ``wrap_bits`` < 32 artificially lowers the wrap modulus of the RETURNED
    ``base_int`` only (on-device consumers keep the int32 value) so the
    wrapped-plan export contract is testable on sub-2**31 fixtures.

    ``lengths``: optional host (batch,) real sample counts for a
    MIXED-LENGTH batch.  The TraceLine centering mean then runs over each
    take's own frames only, and sinc taps past a take's end read zero — the
    first ``length//step`` output segments are bit-identical to the take's
    solo ``restore_fused_device`` run PROVIDED rows carry the solo reflect
    continuation for >= n_fft//2 samples past their end (build the batch
    with ``parallel.batch.load_batch(..., reflect_tail=n_fft)``); tracked
    masking requires lengths < 2**31 (the dense tier's own bound).

    ``interpret`` (tests) runs the sinc kernel through the Pallas interpreter
    on any platform; otherwise the kernel runs where the mesh is on GPUs.
    """
    from ..kernels.sinc_triton import sinc_rows
    from ..pipelines.respeeder_device import (
        _sinc_by_platform, banded_refined_chunk, exact_log_center,
        inv_count_limbs, log_center_for_band, quantized_log_sums,
        segment_advances, segment_grids, sinc_shift_mac)

    n_time = mesh.shape["time"]
    batch, total = x.shape
    assert batch % mesh.shape["files"] == 0, \
        "files-axis batch must divide the mesh's files dimension"
    S = total // n_time
    assert S % step == 0 and S * n_time == total
    assert n_fft % step == 0
    pad = n_fft // 2
    assert pad <= S and n_fft <= S, "shard must cover the frame halo"
    Tl = S // step          # segments per shard
    T = total // step       # global segments
    F_total = T + 1         # global frames
    ratio = n_fft // step
    if max_n is None:
        max_n = int(step * 1.25)
    U = nt + drift
    Hl = U + base_slack
    Hr = (max_n - step) + U + base_slack
    assert Hl <= S and Hr <= S, "halos must fit one neighbor shard"
    num_bins = n_fft * zeropad // 2 + 1
    NL = np.asarray(NL, np.int32)
    NU = np.asarray(NU, np.int32)
    assert NL.shape == NU.shape == (F_total,)
    if band is None:
        band = (max(0, int(NL.min()) - 1), min(num_bins, int(NU.max()) + 1))
    lo, hi = int(band[0]), int(band[1])
    center = log_center_for_band((lo, hi))
    # per-shard overlapping frame windows: shard d owns frames
    # [d*Tl, d*Tl + Tl] inclusive (one-frame overlap with the right neighbor;
    # the duplicate is recomputed locally, bit-identical from the same halo)
    NL_ov = np.stack([NL[d * Tl: d * Tl + Tl + 1] for d in range(n_time)])
    NU_ov = np.stack([NU[d * Tl: d * Tl + Tl + 1] for d in range(n_time)])
    if speed_curve is not None:
        sc = np.asarray(speed_curve, np.float32)
        assert sc.shape == (batch, F_total)
        # (files, n_time, Tl+1) overlap layout so both axes shard naturally
        sc_ov = np.stack([sc[:, d * Tl: d * Tl + Tl + 1] for d in range(n_time)],
                         axis=1)
    d_bound = min(0.9, max(drift - 2, 1) / max_n)
    if lengths is not None:
        lengths_h = np.asarray(lengths, np.int64)
        assert lengths_h.shape == (batch,)
        # host-computed 1/count limb factors (bit-parity with a static
        # count, see respeeder_device.inv_count_limbs)
        inv_np = inv_count_limbs(lengths_h // step + 1)
        len_np = lengths_h.astype(np.int32)

    def track_local(xb, nl, nu, is_first, is_last):
        # reflect-centered frames: frame t covers x[t*step - pad, ...+n_fft)
        left = _right_ppermute(xb[..., -pad:], "time", n_time)
        right = _left_ppermute(xb[..., :pad], "time", n_time)
        sym_l = xb[..., 1:pad + 1][..., ::-1]
        sym_r = xb[..., -pad - 1:-1][..., ::-1]
        left = jnp.where(is_first, sym_l, left)
        right = jnp.where(is_last, sym_r, right)
        ext = jnp.concatenate([left, xb, right], axis=-1)  # (B, S + n_fft)
        n_frames_loc = Tl + 1
        n_chunks = -(-n_frames_loc // chunk_frames)
        span = (chunk_frames + ratio - 1) * step
        extp = jnp.pad(ext, [(0, 0)] * (ext.ndim - 1)
                       + [(0, max(0, n_chunks * chunk_frames * step + span
                                  - ext.shape[-1]))])
        pad_t = n_chunks * chunk_frames - n_frames_loc
        nlp = jnp.pad(nl, (0, pad_t), constant_values=lo + 1)
        nup = jnp.pad(nu, (0, pad_t), constant_values=lo + 2)

        def one_chunk(args):
            c, nlc, nuc = args
            xs = jax.lax.dynamic_slice_in_dim(extp, c * chunk_frames * step,
                                              span, axis=-1)
            # the same banded-DFT chunk kernel as the dense tier
            # (respeeder_device.banded_refined_chunk) — shared code so the
            # tiers cannot drift (its docstring explains why this exact
            # formulation is what keeps dense/sharded bit-identical)
            return banded_refined_chunk(xs, nlc, nuc, n_fft, step, zeropad,
                                        window_name, (lo, hi), chunk_frames)

        refined = jax.lax.map(one_chunk, (
            jnp.arange(n_chunks),
            nlp.reshape(n_chunks, chunk_frames),
            nup.reshape(n_chunks, chunk_frames)))
        # (n_chunks, B, chunk) -> (B, n_frames_loc)
        return jnp.moveaxis(refined, 0, 1).reshape(ext.shape[0], -1)[:, :n_frames_loc]

    def fn(xb, nl_ov, nu_ov, *extra):
        extra = list(extra)
        sc_arg = extra.pop(0) if speed_curve is not None else None
        len_b = inv_b = None
        if lengths is not None:
            len_b, inv_b = extra  # (B_local,), (B_local, 3)
        idx = jax.lax.axis_index("time")
        is_first = idx == 0
        is_last = idx == n_time - 1
        nl = nl_ov[0]
        nu = nu_ov[0]
        if speed_curve is None:
            refined = track_local(xb, nl, nu, is_first, is_last)  # (B, Tl+1)
            log_speed = jnp.log2(jnp.maximum(refined, 1.0))
            # global TraceLine centering: EXACT partition-invariant mean over
            # ALL F_total frames (quantized_log_sums limbs + psum) so the
            # curve is bit-identical to the dense tier's.  The overlap frame
            # counts once (only the last shard owns frame T).
            mask = jnp.concatenate([
                jnp.ones((Tl,), jnp.float32),
                jnp.where(is_last, 1.0, 0.0)[None]])
            if len_b is None:
                limbs = quantized_log_sums(log_speed, center, mask=mask)
                limbs = tuple(jax.lax.psum(l, "time") for l in limbs)
                mean = exact_log_center(limbs, F_total, center)
            else:
                # mixed-length batch: the mean runs over each take's OWN
                # frames (global frame index <= length//step) — the pad must
                # not perturb the TraceLine centering (markers.py:190-192)
                gframe = idx * Tl + jnp.arange(Tl + 1, dtype=jnp.int32)
                valid = (gframe[None, :] <= (len_b // step)[:, None])
                limbs = quantized_log_sums(
                    log_speed, center, mask=mask[None, :] * valid)
                limbs = tuple(jax.lax.psum(l, "time") for l in limbs)
                mean = exact_log_center(limbs, F_total, center,
                                        inv_limbs=inv_b)
            speeds = jnp.power(2.0, log_speed - mean[:, None])
        else:
            speeds = sc_arg[:, 0]  # (B_local, Tl+1)
        if share_curve:
            # the reference's multi-channel export contract: every row (the
            # CHANNELS of one take on the files axis) resamples through row
            # 0's tracked curve (resampling.py:211-231) — one all_gather
            # over the files axis broadcasts it
            allsp = jax.lax.all_gather(speeds, "files", axis=0, tiled=True)
            speeds = jnp.broadcast_to(allsp[:1], speeds.shape)
        speeds = jnp.clip(speeds, 1.0 / (1.0 + d_bound), 1.0 / (1.0 - d_bound))
        s_lo, s_hi = speeds[:, :-1], speeds[:, 1:]  # (B, Tl)
        n_raw = step * (s_lo + s_hi) / 2.0

        # globally-dithered output counts (exact split arithmetic)
        ci, cf = _sharded_split_exclusive(n_raw, "time", n_time)
        inc_i = ci + jnp.floor(cf + n_raw).astype(jnp.int32)
        inc_f = cf + n_raw - jnp.floor(cf + n_raw)
        rounded = inc_i + (inc_f >= 0.5).astype(jnp.int32)
        pred0 = ci[:, :1] + (cf[:, :1] >= 0.5).astype(jnp.int32)
        nn = jnp.diff(jnp.concatenate([pred0, rounded], axis=-1))
        nn = jnp.clip(nn, 0, max_n)

        # exact segment advances + global base positions
        A = jax.vmap(lambda a, b, c: segment_advances(a, b, c, max_n))(
            s_lo, s_hi, nn)
        base_int, base_frac = _sharded_split_exclusive(A, "time", n_time)
        # Pin the plan's codegen exactly like the dense tier's _fused_plan:
        # without a barrier XLA may fuse the sinc consumers into this
        # subgraph differently than in the dense program, and 1-ulp
        # differences flip dither roundings — which would break the
        # dense/sharded BIT-parity the fast tier guarantees (see
        # respeeder_device._fused_plan and docs/ARCHITECTURE.md §13).
        speeds, nn, base_int, base_frac = jax.lax.optimization_barrier(
            (speeds, nn, base_int, base_frac))
        s_lo, s_hi = speeds[:, :-1], speeds[:, 1:]  # re-derive POST-barrier

        # shard-local sinc windows with bounded halos
        left = _right_ppermute(xb[..., -Hl:], "time", n_time)
        right = _left_ppermute(xb[..., :Hr], "time", n_time)
        ext = jnp.concatenate([left, xb, right], axis=-1)  # (B, S + Hl + Hr)
        ext_len = S + Hl + Hr
        if len_b is not None:
            # sinc taps past a take's real end read ZERO (the dense tier's
            # out-of-range convention) — rows carry reflect continuation for
            # the tracker, so mask it out of the resampler's view.  Wrapped
            # int32 subtraction keeps this exact past 2**31 samples.
            gpos = (idx * S - Hl) + jnp.arange(ext_len, dtype=jnp.int32)
            ext = jnp.where((gpos[None, :] - len_b[:, None]) < 0, ext, 0.0)
        L = max_n + 2 * U
        anchors = base_int - idx * S + Hl  # window anchors in ext coords

        # the single-chip tier's kernel on the halo-extended local signal
        # (windows are shard-local, so it applies unchanged), one call per
        # local file (B_local is 1-2 on real meshes)
        def kernel_file(b, interp):
            bs, rel, _ = segment_grids(s_lo[b], s_hi[b], nn[b], base_frac[b],
                                       max_n)
            return sinc_rows(ext[b], anchors[b] - U, bs, rel, nn[b], nt=nt,
                             drift=drift, interpret=interp)

        def xla_file(ext1, sl, sh, nn1, st1, bf1):
            bs, rel, in_seg = segment_grids(sl, sh, nn1, bf1, max_n)
            idx2 = (st1 - U)[:, None] + np.arange(L)[None, :]
            buf = ext1[jnp.clip(idx2, 0, ext_len - 1)]
            return sinc_shift_mac(buf, bs, rel, in_seg, max_n, nt, drift)

        padded = _sinc_by_platform(
            lambda interp: jnp.stack([kernel_file(b, interp)
                                      for b in range(ext.shape[0])]),
            lambda: jax.vmap(xla_file)(ext, s_lo, s_hi, nn, anchors,
                                       base_frac),
            interpret)
        if wrap_bits < 32:
            # test hook: wrap the RETURNED plan at a low modulus (see the
            # length contract above) — anchors above already consumed the
            # int32 value, exactly like production past 2**31
            half = 1 << (wrap_bits - 1)
            ret_base = ((base_int + half) & ((1 << wrap_bits) - 1)) - half
        else:
            ret_base = base_int
        return padded, nn, ret_base, base_frac

    in_specs = [P("files", "time"), P("time", None), P("time", None)]
    args = [x, jnp.asarray(NL_ov), jnp.asarray(NU_ov)]
    if speed_curve is not None:
        in_specs.append(P("files", "time", None))
        args.append(jnp.asarray(sc_ov))
    if lengths is not None:
        in_specs += [P("files"), P("files", None)]
        args += [jnp.asarray(len_np), jnp.asarray(inv_np)]
    # jit the whole sharded step: besides dispatch cost, XLA's elementwise
    # simplifications (log2/exp2 fusion) must match the jitted dense tier's
    # ulp-for-ulp, or the centering mean drifts and flips dither roundings.
    # The compiled executable is CACHED per (mesh, static config) — a fresh
    # jit(shard_map(closure)) every call would retrace and recompile the
    # whole step each time (measured 5.9 s/call vs 60 ms warm).
    key = (_mesh_key(mesh), batch, total, n_fft, step,
           zeropad, max_n, nt, drift, window_name, (lo, hi),
           speed_curve is not None, base_slack, chunk_frames, share_curve,
           lengths is not None, wrap_bits, interpret)
    return _cached_exec(("fused",) + key, lambda: jax.jit(shard_map(
        fn, mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(P("files", "time", None), P("files", "time"),
                   P("files", "time"), P("files", "time")),
        check_vma=False,
    )))(*args)


def unwrap_base_int(base_int_np, base_frac_np=None, bits: int = 32):
    """Host: unwrap the mod-``2**bits`` ``base_int`` returned by
    :func:`restore_fused_sharded` into true int64 sample positions.

    On-device the global position cumsum runs in int32 and wraps past
    ~2.1e9 samples (every DEVICE consumer takes small differences of
    equally-wrapped values, which two's-complement arithmetic recovers —
    see the restore_fused_sharded length contract).  A host consumer that
    needs absolute positions (stitching, resume bookkeeping, cross-checks
    against the float64 planner) reconstructs them by monotonicity: segment
    advances are small positives (~hop), so the wrapped int32 difference of
    consecutive entries IS the true delta, and an int64 prefix sum rebuilds
    the positions.  Works on (T,) or (files, T) arrays; segment 0's base is
    0 by construction (t0 = 0), so the first entry anchors the unwrap.
    Returns int64 positions, or float64 ``base + frac`` when ``base_frac_np``
    is given.  Reference anchor: the implicit int64 positions of the
    float64 host planner, resampling.py:93-137."""
    w = np.asarray(base_int_np).astype(np.int64)
    half = np.int64(1) << (bits - 1)
    # wrapped deltas, recovered to signed range: exact for |true| < 2**(bits-1)
    d = ((np.diff(w, axis=-1) + half) & ((np.int64(1) << bits) - 1)) - half
    first = w[..., :1]
    pos = np.concatenate(
        [first, first + np.cumsum(d, axis=-1)], axis=-1)
    if base_frac_np is not None:
        return pos.astype(np.float64) + np.asarray(base_frac_np, np.float64)
    return pos


def compact_padded_host(padded_np, n_np, n_out=None):
    """Host: (T, max_n) padded grid + (T,) counts -> flat (n_out,) output.
    The sharded twin of ``respeeder_device.compact_output`` (which takes the
    host plan dict instead)."""
    T, max_n = padded_np.shape
    mask = np.arange(max_n)[None, :] < np.asarray(n_np)[:, None]
    flat = np.asarray(padded_np)[mask]
    return flat[:n_out] if n_out is not None else flat


def adaptive_peak_sharded(mesh: Mesh, spec_mag, carry0, tolerance_st,
                          mode: str, fft_size: int, sr: int):
    """Time-sharded adapt_band peak tracking with cross-shard history handoff.

    The adaptive tracker is sequential — frame t's band is predicted from the
    last 4 traced frequencies (wow_detection.py:142-187) — so, exactly like
    :func:`cog_sharded`, the shards form a dependency chain: each runs its
    local ``lax.scan`` on its turn, starting from the 4-deep log2-frequency
    history its left neighbor hands over via ``ppermute``.  Per-frame math is
    ``trackers.adaptive_step_core``, shared with the dense scan.

    spec_mag: (files, F, T) sharded (files, None, time); carry0: (files, 4)
    initial history (last 4 log2 freqs, oldest first).  Returns (files, T).
    """
    from ..models.trackers import adaptive_step_core

    n_time = mesh.shape["time"]

    def local_scan(sb, hist):  # sb (B, F, T_local); hist (B, 4)
        step_b = jax.vmap(
            lambda fr, h: adaptive_step_core(fr, tuple(h), tolerance_st,
                                             mode, fft_size, sr))

        def step(carry, frame):  # frame (B, F)
            h2, freq = step_b(frame, carry)
            return jnp.stack(h2, axis=-1), freq

        hist2, freqs = jax.lax.scan(step, hist, jnp.moveaxis(sb, -1, 0))
        return hist2, jnp.moveaxis(freqs, 0, -1)

    def fn(sb, h0):
        idx = jax.lax.axis_index("time")
        out0 = jnp.zeros((sb.shape[0], sb.shape[-1]), jnp.float32)

        def body(s, state):
            hist, out = state
            my_turn = idx == s
            hist2, freqs = jax.lax.cond(
                my_turn,
                lambda h: local_scan(sb, h),
                lambda h: (h, jnp.zeros_like(out)),
                hist)
            out = jnp.where(my_turn, freqs, out)
            return _right_ppermute(hist2, "time", n_time), out

        _, out = jax.lax.fori_loop(0, n_time, body, (h0, out0))
        return out

    key = ("adaptive", _mesh_key(mesh), spec_mag.shape, float(tolerance_st),
           mode, fft_size, sr)
    return _cached_exec(key, lambda: jax.jit(shard_map(
        fn, mesh=mesh,
        in_specs=(P("files", None, "time"), P("files", None)),
        out_specs=P("files", "time"),
        check_vma=False,
    )))(spec_mag, jnp.asarray(carry0, jnp.float32))


def lag_resample_sharded(mesh: Mesh, x, sampletimes, lags, hop: int = 256,
                         nt: int = 50, drift: int = 32, base_slack: int = 4):
    """Time-sharded lag-curve varispeed resample — the tapesynch export on a
    mesh (pytapesynch_gui.py:145-155; positions = ``interp(j, times,
    times - lags)``, resampling.py:189-206; adaptive cutoff ``fc =
    min(1/dp, 1)``, resampling.py:14-18).

    Positions are monotone and stay within ``max|lags|`` of the output
    index, so the banded shift-MAC kernel applies unchanged: outputs shard
    along time, each shard fetches one ``max|lag|``-plus-taps halo from each
    neighbor, and segments of ``hop`` outputs run the same
    ``sinc_shift_mac`` loop as the restoration step.  The lag curve itself
    is frame-rate-sized host data, replicated to every shard.

    ``x``: (files, n) sharded (files, time) — the files axis carries the
    channels resampled through one shared curve (the reference's export
    loop, resampling.py:211-231).  ``sampletimes``/``lags``: 1D arrays in
    SAMPLES.  Returns the fixed-length (files, n) resampled batch.
    """
    from ..pipelines.respeeder_device import sinc_shift_mac

    n_time = mesh.shape["time"]
    batch, total = x.shape
    S = total // n_time
    assert S % hop == 0
    Tseg = S // hop
    st = np.asarray(sampletimes, np.float64)
    lg = np.asarray(lags, np.float64)
    max_dev = float(np.max(np.abs(lg))) if len(lg) else 0.0
    U = nt + drift
    H = int(np.ceil(max_dev)) + U + base_slack + hop
    assert H <= S, "max lag must fit one neighbor shard"
    L = hop + 2 * U
    st_j = jnp.asarray(st, jnp.float32)
    lg_j = jnp.asarray(lg, jnp.float32)

    def fn(xb):
        idx = jax.lax.axis_index("time")
        left = _right_ppermute(xb[..., -H:], "time", n_time)
        right = _left_ppermute(xb[..., :H], "time", n_time)
        ext = jnp.concatenate([left, xb, right], axis=-1)
        ext_len = S + 2 * H
        # sub-sample precision: positions are pos_j = j - lag(j); keep the
        # big output index EXACT (int) and interpolate only the small lag,
        # so no f32 rounding at recording-length magnitudes
        g0 = (idx * S).astype(jnp.float32)
        jg_rel = jnp.arange(S + 1, dtype=jnp.float32)
        lagc = jnp.interp(jg_rel, st_j - g0, lg_j)  # (S+1,) small values
        dlag = lagc[1:] - lagc[:-1]
        bs = 1.0 / jnp.maximum(1.0 - dlag, 1e-6)  # fc = min(bs,1) in the MAC
        neg_lag = (-lagc[:S]).reshape(Tseg, hop)
        anchor_off = jnp.floor(neg_lag[:, 0]).astype(jnp.int32)  # per segment
        kk = jnp.arange(hop, dtype=jnp.float32)[None, :]
        rel = kk + neg_lag - anchor_off[:, None].astype(jnp.float32)
        in_seg = jnp.ones((Tseg, hop), bool)
        # window start (ext coords): bi - g0 + H - U with
        # bi = g0 + k*hop + anchor_off
        start = jnp.arange(Tseg, dtype=jnp.int32) * hop + anchor_off + H - U
        idx2 = start[:, None] + np.arange(L)[None, :]
        idx2 = jnp.clip(idx2, 0, ext_len - 1)

        def one_file(ext1):
            buf = ext1[idx2]
            return sinc_shift_mac(buf, bs.reshape(Tseg, hop), rel, in_seg,
                                  hop, nt, drift).reshape(-1)

        return jax.vmap(one_file)(ext)

    key = ("lag", _mesh_key(mesh), x.shape, hop, nt, drift, base_slack,
           st.tobytes(), lg.tobytes())
    return _cached_exec(key, lambda: jax.jit(shard_map(
        fn, mesh=mesh,
        in_specs=P("files", "time"),
        out_specs=P("files", "time"),
        check_vma=False,
    )))(x)


def _masked_peak_local(spec_local, nl, nu):
    """Frame-parallel masked peak tracking (device part of the Peak tracker).

    ``nl``/``nu``: per-frame int32 band limits (T_local,) — fixed-f0 callers
    pass constant arrays, trail-driven tracking passes the trail's bands
    (matching pipelines/respeeder_device.track_speed_device).  Delegates to
    the shared core so the sharded tier applies the same is-a-true-local-peak
    gate as the dense trackers (this previously refined unconditionally)."""
    from ..models.trackers import masked_peak_refine

    frames = jnp.swapaxes(spec_local, -1, -2)  # (..., T, F)
    return masked_peak_refine(frames, nl, nu)


def restore_step(mesh: Mesh, x, f0_hz: float, sr: int, n_fft: int = 512,
                 step: int = 128, tolerance_st: float = 2.0, drift_halo: int = 256,
                 interp: str = "linear", nt: int = 8, band=None):
    """Fixed-length sharded wow/flutter restoration step.

    (files, time) batch -> sharded STFT -> frame-parallel peak tracking ->
    global speed normalization (psum over time) -> fixed-length varispeed
    resample with a bounded drift halo (linear, or the banded shift-MAC sinc
    with segment-local anchors) -> restored (files, time).  The
    length-preserving tier; the flagship variable-length pipeline with the
    exact dither plan is :func:`restore_fused_sharded`.

    ``band``: optional per-frame int32 band arrays (NL, NU) of global length
    ``total // step`` — trail-driven tracking (the multi-chip analogue of
    track_speed_device's NL/NU inputs).  When omitted the band is the fixed
    ``f0_hz +- tolerance_st`` window.

    This is the multichip "training step" the dry-run compiles: it exercises
    STFT halos (ppermute), collectives (psum), and cross-shard gathers.
    """
    n_time = mesh.shape["time"]
    batch, total = x.shape
    local = total // n_time
    assert local % step == 0
    halo = n_fft - step
    window = jnp.asarray(get_window("hann", n_fft))
    n_frames_local = local // step
    n_frames_total = total // step
    if band is None:
        f0_bin = int(round(f0_hz * n_fft / sr))
        tol_bins = max(2, int(round(f0_bin * (2 ** (tolerance_st / 12) - 1))))
        NL = np.full(n_frames_total, f0_bin - tol_bins, np.int32)
        NU = np.full(n_frames_total, f0_bin + tol_bins + 1, np.int32)
    else:
        NL, NU = (np.asarray(b, np.int32) for b in band)
        assert NL.shape == NU.shape == (n_frames_total,)

    def fn(xb, nl, nu):
        ext = halo_exchange_right(xb, halo, "time", n_time)
        spec = _stft_local(ext, n_fft, step, window, 1, n_frames_local)
        mag = jnp.abs(spec)
        peak_bins = _masked_peak_local(mag, nl, nu)  # (B, T_local)
        log_speed = jnp.log2(jnp.maximum(peak_bins, 1.0))
        # center the speed curve globally: mean over ALL time shards (psum)
        local_sum = jnp.sum(log_speed, axis=-1, keepdims=True)
        global_sum = jax.lax.psum(local_sum, "time")
        mean = global_sum / (n_frames_local * n_time)
        speed = jnp.power(2.0, log_speed - mean)  # (B, T_local), mean ~1
        # per-sample speed via frame-rate lerp (frame t covers t*step..)
        up = jnp.repeat(speed, step, axis=-1)  # (B, local)
        # fixed-length linear varispeed: positions = cumsum(1/speed) with the
        # global offset carried via collective prefix sum over shards
        inv = 1.0 / up
        local_total = jnp.sum(inv, axis=-1, keepdims=True)
        all_totals = jax.lax.all_gather(local_total, "time", axis=-1)  # (B,1,D)
        shard_id = jax.lax.axis_index("time")
        offset = jnp.sum(jnp.where(jnp.arange(n_time) < shard_id,
                                   all_totals[:, 0, :], 0.0), axis=-1, keepdims=True)
        pos = jnp.cumsum(inv, axis=-1) - inv + offset  # global positions
        # gather within own shard + drift halo from the right neighbor
        ext_sig = halo_exchange_right(xb, drift_halo, "time", n_time)
        base = shard_id * local
        rel = pos - base
        if interp == "linear":
            rel = jnp.clip(rel, 0.0, local + drift_halo - 2.0)
            i0 = jnp.floor(rel).astype(jnp.int32)
            frac = (rel - i0).astype(xb.dtype)
            g0 = jnp.take_along_axis(ext_sig, i0, axis=-1)
            g1 = jnp.take_along_axis(ext_sig, i0 + 1, axis=-1)
            return g0 * (1 - frac) + g1 * frac
        # windowed-sinc (round 3): segment-local anchors bound the in-segment
        # drift (positions advance ~1/speed per output), so the quality-taps
        # banded shift-MAC replaces the old per-tap gather — the
        # same rebuild as lag_resample_sharded; reference tap conventions
        # unchanged (2*nt taps, hann taper, fc = min(speed, 1))
        from ..pipelines.respeeder_device import sinc_shift_mac

        seg_drift = max(4, int(np.ceil(
            step * (2 ** (tolerance_st / 12) - 1))) + 2)
        U2 = nt + seg_drift
        Hl2 = U2 + 2
        left = _right_ppermute(xb[..., -Hl2:], "time", n_time)
        ext2 = jnp.concatenate([left, ext_sig], axis=-1)
        ext_len2 = Hl2 + local + drift_halo
        Tseg = local // step
        L2 = step + 2 * U2
        rel2 = jnp.clip(rel, 0.0, local + drift_halo - 1.0)

        def one_b(ext1, pos1, sp1):
            ps = pos1.reshape(Tseg, step)
            bi = jnp.floor(ps[:, 0]).astype(jnp.int32)
            rel_s = ps - bi[:, None].astype(jnp.float32)
            start = bi + Hl2 - U2
            idx2 = jnp.clip(start[:, None] + np.arange(L2)[None, :], 0,
                            ext_len2 - 1)
            buf = ext1[idx2]
            return sinc_shift_mac(buf, sp1.reshape(Tseg, step), rel_s,
                                  jnp.ones((Tseg, step), bool), step, nt,
                                  seg_drift).reshape(-1)

        return jax.vmap(one_b)(ext2, rel2, up)

    key = ("restore_step", _mesh_key(mesh), x.shape, float(f0_hz), sr, n_fft,
           step, float(tolerance_st), drift_halo, interp, nt, band is None)
    return _cached_exec(key, lambda: jax.jit(shard_map(
        fn, mesh=mesh,
        in_specs=(P("files", "time"), P("time"), P("time")),
        out_specs=P("files", "time"),
        check_vma=False,
    )))(x, jnp.asarray(NL), jnp.asarray(NU))
