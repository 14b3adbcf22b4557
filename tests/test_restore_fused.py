"""The fused single-jit restoration must match the hybrid host-planned path."""

import jax.numpy as jnp
import numpy as np

from pyaudiorestoration_tpu.pipelines import respeeder_device as rdev


def test_split_cumsum_exclusive_precision():
    """(int, frac) split cumsum stays sub-sample accurate at magnitudes where
    plain float32 cumsum loses whole samples."""
    rng = np.random.default_rng(11)
    x = (512.0 + rng.standard_normal(200000) * 5).astype(np.float64)  # ~1e8 total
    ints, fracs = rdev._split_cumsum_exclusive(jnp.asarray(x.astype(np.float32)))
    ref = np.concatenate([[0.0], np.cumsum(x)[:-1]])
    got = np.asarray(ints, dtype=np.float64) + np.asarray(fracs, dtype=np.float64)
    # input quantization to f32 costs ~1e-4 per element (random walk); the
    # split representation must not add magnitude-dependent error on top
    err = np.abs(got - ref)
    assert err.max() < 0.5, err.max()
    assert np.all(np.asarray(fracs) >= 0) and np.all(np.asarray(fracs) < 1)
    # against the f32-quantized truth the split cumsum is near-exact
    ref32 = np.concatenate([[0.0], np.cumsum(x.astype(np.float32).astype(np.float64))[:-1]])
    assert np.abs(got - ref32).max() < 2e-2


def test_split_cumsum_exclusive_multihour_clip_bounds():
    """Round-3 property sweep (VERDICT #8): multi-hour synthetic speed curves
    pinned at the drift-clip bounds, including the adversarial constant-frac
    cases that defeated single-level blocking (0.12-sample error at block
    ends).  The two-level split must stay within the documented ~2e-4 bound
    at any magnitude inside the int32 contract (it measures exactly 0 here)."""
    hop = 512
    rng = np.random.default_rng(0)
    d_bound = 0.3
    lo, hi = 1 / (1 + d_bound), 1 / (1 - d_bound)
    T = 1_350_000  # ~1 h at 192 kHz / hop 512
    idx = np.arange(T + 1)
    curves = {
        "const_lo": np.full(T + 1, lo),
        "const_hi": np.full(T + 1, hi),
        "square": np.where(idx // 1000 % 2 == 0, lo, hi),
        "sine+noise": np.clip(1 + 0.25 * np.sin(idx * 2e-4)
                              + rng.standard_normal(T + 1) * 0.02, lo, hi),
    }
    for name, sp in curves.items():
        sp32 = sp.astype(np.float32)
        n_raw = (hop * (sp32[:-1].astype(np.float64)
                        + sp32[1:].astype(np.float64)) / 2.0).astype(np.float32)
        ints, fracs = rdev._split_cumsum_exclusive(jnp.asarray(n_raw))
        got = np.asarray(ints, np.float64) + np.asarray(fracs, np.float64)
        ref = np.concatenate([[0.0], np.cumsum(n_raw.astype(np.float64))[:-1]])
        assert np.abs(got - ref).max() < 2e-4, name
        f = np.asarray(fracs)
        assert np.all(f >= 0) and np.all(f < 1), name


def test_fused_matches_hybrid():
    sr = 44100
    n = 2 * sr
    t = np.arange(n) / sr
    f0 = 3000.0
    speed = 1.0 + 0.02 * np.sin(2 * np.pi * 0.8 * t)
    phase = 2 * np.pi * f0 * np.cumsum(speed) / sr
    sig = (np.sin(phase) * 0.5).astype(np.float32)
    fft_size, overlap, zp = 4096, 8, 2
    hop = fft_size // overlap

    padded_h, plan = rdev.restore_device(jnp.asarray(sig), sr, f0,
                                         fft_size=fft_size, fft_overlap=overlap,
                                         zeropad=zp, sinc_quality=30)
    padded_h = np.asarray(padded_h)

    n_frames = (n + fft_size - fft_size) // hop + 1
    num_bins = fft_size * zp // 2 + 1
    tol = 1.0 / 12
    NL = int(round(max(1.0, f0 * 2 ** -tol) * fft_size * zp / sr))
    NU = int(round(min(sr / 2, f0 * 2 ** tol) * fft_size * zp / sr))
    n_frames = (n + (fft_size // 2) * 2 - fft_size) // hop + 1
    NLs = jnp.full((n_frames,), NL, jnp.int32)
    NUs = jnp.full((n_frames,), NU, jnp.int32)
    max_n = int(plan["max_n"])
    padded_f = np.asarray(rdev.restore_fused_device(
        jnp.asarray(sig), NLs, NUs, fft_size, hop, zp, max_n, 30, 64))

    assert padded_f.shape[0] == padded_h.shape[0]
    m = min(padded_f.shape[1], padded_h.shape[1])
    # device scans may place a dither boundary one sample differently in rare
    # segments; compare via the flattened valid samples
    flat_h = rdev.compact_output(padded_h, plan)
    k = np.arange(padded_f.shape[1])[None, :]
    flat_f = padded_f[k < np.asarray(plan["n"])[:, None]]
    mm = min(len(flat_h), len(flat_f)) - 100
    err = np.abs(flat_f[100:mm] - flat_h[100:mm])
    assert np.median(err) < 1e-4
    assert (err > 1e-2).mean() < 0.01  # only isolated dither-boundary samples


def test_banded_dft_matches_full_fft_tracking():
    """The banded-DFT matmul tracking path must agree with the full-FFT path."""
    import jax.numpy as jnp

    from pyaudiorestoration_tpu.pipelines import respeeder_device as rdev

    sr = 16000
    n = 4 * sr
    t = np.arange(n) / sr
    speed = 1.0 + 0.015 * np.sin(2 * np.pi * 1.7 * t)
    x = np.sin(2 * np.pi * 1000 * np.cumsum(speed) / sr).astype(np.float32)
    fft_size, hop, zp = 2048, 256, 2
    f0_bin = int(round(1000 * fft_size * zp / sr))
    NLv, NUv = f0_bin - 12, f0_bin + 13
    n_frames = (n + (fft_size // 2) * 2 - fft_size) // hop + 1
    NLs = jnp.full((n_frames,), NLv, jnp.int32)
    NUs = jnp.full((n_frames,), NUv, jnp.int32)
    full = np.asarray(rdev.track_speed_device(jnp.asarray(x), NLs, NUs,
                                              fft_size, hop, zp))
    banded = np.asarray(rdev.track_speed_device(jnp.asarray(x), NLs, NUs,
                                                fft_size, hop, zp,
                                                band=(NLv - 1, NUv + 1)))
    np.testing.assert_allclose(banded, full, atol=2e-5)


def test_restore_fused_takes_kernel_shape_is_batch_invariant():
    """Compile-once contract of the XLA sinc stage: the flattened-takes sinc
    runs through fixed seg_tile chunks, so the compiled inner map body
    depends only on
    (seg_tile, max_n, nt, drift) — NOT on the batch size.  Assert by
    intercepting the segments-level kernel call for B=2 and B=5 and checking
    the chunked shapes it receives are identical."""
    from pyaudiorestoration_tpu.pipelines import respeeder_device as rdev

    sr = 4096
    n = 2 * sr
    n_fft, step, zp = 256, 64, 1
    f0 = 512.0
    t = np.arange(n) / sr
    f0_bin = int(round(f0 * n_fft / sr))
    n_frames = (n + (n_fft // 2) * 2 - n_fft) // step + 1
    max_n = int(step * 1.1)

    def run(B):
        xb = jnp.asarray(np.stack([
            np.sin(2 * np.pi * f0 * np.cumsum(
                1.0 + 0.01 * np.sin(2 * np.pi * (1 + i) * t)) / sr)
            for i in range(B)]).astype(np.float32))
        NL = jnp.full((B, n_frames), f0_bin - 4, jnp.int32)
        NU = jnp.full((B, n_frames), f0_bin + 5, jnp.int32)
        return rdev.restore_fused_takes(xb, NL, NU, n_fft, step, zp, max_n, 8, 8)

    seen = []
    orig = rdev.sinc_banded_segments

    def spy(sig, s_lo, s_hi, nn, bi, bf, *a, **kw):
        # record the per-chunk shape the kernel is built from
        seg_tile = kw.get("seg_tile", 32768)
        seen.append((seg_tile, kw.get("force_chunk"), int(nn.shape[0]) % seg_tile
                     if int(nn.shape[0]) > seg_tile else None))
        return orig(sig, s_lo, s_hi, nn, bi, bf, *a, **kw)

    rdev.sinc_banded_segments = spy
    try:
        out2 = np.asarray(run(2))
        out5 = np.asarray(run(5))
    finally:
        rdev.sinc_banded_segments = orig
    assert out2.shape[0] == 2 and out5.shape[0] == 5
    assert len(seen) == 2
    # identical static kernel configuration for both batch sizes
    assert seen[0][0] == seen[1][0] and seen[0][1] is True and seen[1][1] is True


def test_restore_fused_takes_independent_curves():
    """Each take in the batch tracks its own curve: results equal per-take
    single calls, and takes with different wow get different outputs."""
    from pyaudiorestoration_tpu.pipelines import respeeder_device as rdev

    sr = 8192
    n = 4 * sr
    n_fft, step, zp = 512, 128, 1
    f0 = 1024.0
    t = np.arange(n) / sr

    def take(rate):
        speed = 1.0 + 0.01 * np.sin(2 * np.pi * rate * t)
        phase = 2 * np.pi * f0 * np.cumsum(speed) / sr
        return np.sin(phase).astype(np.float32)

    xb = jnp.asarray(np.stack([take(1.0), take(3.0)]))
    num_bins = n_fft * zp // 2 + 1
    f0_bin = int(round(f0 * n_fft * zp / sr))
    n_frames = (n + (n_fft // 2) * 2 - n_fft) // step + 1
    NL = jnp.full((2, n_frames), f0_bin - 6, jnp.int32)
    NU = jnp.full((2, n_frames), min(num_bins - 1, f0_bin + 6), jnp.int32)
    max_n = int(step * 1.1)

    batch = np.asarray(rdev.restore_fused_takes(xb, NL, NU, n_fft, step, zp,
                                                max_n, 8, 8))
    for i in range(2):
        single = np.asarray(rdev.restore_fused_device(
            xb[i], NL[i], NU[i], n_fft, step, zp, max_n, 8, 8))
        np.testing.assert_allclose(batch[i], single, atol=1e-6)
    assert not np.allclose(batch[0], batch[1], atol=1e-3)


def test_plan_bit_deterministic_across_enclosing_programs():
    """The dither/base plan must be BIT-identical no matter what program it
    is embedded in: XLA's `reduce` may legally reassociate per program, and
    the old `jnp.sum` segment-advance reduction did exactly that (pallas- vs
    xla-backend programs disagreed on base_frac by ~2.7e-4 at n=49999,
    breaking their 3e-5 output parity).  segment_advances now uses a
    fixed-order tree sum; this pins it by compiling the plan into two
    programs with different downstream consumers."""
    import functools

    import jax
    import jax.numpy as jnp

    from pyaudiorestoration_tpu.pipelines import respeeder_device as rdev

    sr = 22050
    fft, overlap, zp, q, drift = 2048, 4, 2, 50, 16
    hop = fft // overlap
    n = 49999
    t = np.arange(n) / sr
    speed = (1.0 + 0.02 * np.sin(2 * np.pi * 1.3 * t)
             + 0.004 * np.sin(2 * np.pi * 6.1 * t))
    sig = (np.sin(2 * np.pi * 2000 * np.cumsum(speed) / sr) * 0.5).astype(np.float32)
    num_bins = fft * zp // 2 + 1
    NL = max(1, min(num_bins - 1, int(round(2000 * 2 ** (-1 / 6) * fft * zp / sr))))
    NU = max(2, min(num_bins - 1, int(round(2000 * 2 ** (1 / 6) * fft * zp / sr))))
    n_frames = (n + (fft // 2) * 2 - fft) // hop + 1
    NLs = jnp.full((n_frames,), NL, jnp.int32)
    NUs = jnp.full((n_frames,), NU, jnp.int32)
    max_n = int(hop * 1.1)

    @functools.partial(jax.jit, static_argnames=("variant",))
    def prog(x, variant):
        speeds, nn, bi, bf = rdev._fused_plan(
            x, NLs, NUs, fft, hop, zp, max_n, q, drift, "blackmanharris",
            (NL - 1, NU + 1))
        if variant == "a":
            extra = jnp.sum(bf * 2.0) + jnp.sum(speeds[:-1] * speeds[1:])
        else:
            # a very different consumer graph: reshape/convolve-ish chain
            extra = jnp.sum(jnp.cumsum(bf) * nn.astype(jnp.float32)) + bi[-1]
        return speeds, nn, bi, bf, extra

    ra = [np.asarray(v) for v in prog(jnp.asarray(sig), "a")]
    rb = [np.asarray(v) for v in prog(jnp.asarray(sig), "b")]
    for name, a, b in zip(("speeds", "n", "base_int", "base_frac"), ra, rb):
        assert np.array_equal(a, b), f"plan {name} differs across programs"


def test_restore_fused_takes_mixed_lengths_bitexact_vs_solo():
    """A MIXED-LENGTH batch with ``lengths`` restores each take bit-identically
    to its solo ``restore_fused_device`` run (VERDICT r03 #2): the padded tail
    must not perturb the take's TraceLine centering mean (markers.py:190-192),
    its boundary tracking frames, or its final sinc taps."""
    from pyaudiorestoration_tpu.pipelines import respeeder_device as rdev

    sr = 8192
    n_fft, step, zp = 512, 128, 1
    f0 = 1024.0
    f0_bin = int(round(f0 * n_fft * zp / sr))
    band = (f0_bin - 6, f0_bin + 7)
    max_n = int(step * 1.25)

    def take(n, rate, ph=0.0):
        t = np.arange(n) / sr
        speed = 1.0 + 0.012 * np.sin(2 * np.pi * rate * t + ph)
        return np.sin(2 * np.pi * f0 * np.cumsum(speed) / sr).astype(np.float32)

    # deliberately awkward lengths: one not a multiple of step, one full
    lengths = [3 * sr + 77, 2 * sr, 4 * sr]
    N = max(lengths)
    takes = [take(L, 1.0 + 0.7 * i, 0.3 * i) for i, L in enumerate(lengths)]
    xb = np.zeros((len(takes), N), np.float32)
    for i, s in enumerate(takes):
        xb[i, :len(s)] = s
    F = N // step + 1
    NL = jnp.full((len(takes), F), band[0] + 2, jnp.int32)
    NU = jnp.full((len(takes), F), band[1] - 2, jnp.int32)

    batch = np.asarray(rdev.restore_fused_takes(
        jnp.asarray(xb), NL, NU, n_fft, step, zp, max_n, 16, 16, band=band,
        lengths=np.asarray(lengths)))
    for i, (L, sig) in enumerate(zip(lengths, takes)):
        F_i = L // step + 1
        solo = np.asarray(rdev.restore_fused_device(
            jnp.asarray(sig), NL[i, :F_i], NU[i, :F_i], n_fft, step, zp,
            max_n, 16, 16, band=band))
        T_i = solo.shape[0]           # L // step segments
        got = batch[i, :T_i]
        assert np.array_equal(got, solo), (
            f"take {i} (len {L}): batched-with-lengths output differs from "
            f"solo dense restore (max abs diff "
            f"{np.max(np.abs(got - solo)):.3e})")

    # and without lengths, the padded tail DOES perturb the curve (the bug
    # this feature fixes) — guard that the test would catch a regression
    plain = np.asarray(rdev.restore_fused_takes(
        jnp.asarray(xb), NL, NU, n_fft, step, zp, max_n, 16, 16, band=band))
    solo0 = np.asarray(rdev.restore_fused_device(
        jnp.asarray(takes[0]), NL[0, :lengths[0] // step + 1],
        NU[0, :lengths[0] // step + 1], n_fft, step, zp, max_n, 16, 16,
        band=band))
    assert not np.array_equal(plain[0, :solo0.shape[0]], solo0)


def test_compact_padded_device_matches_host():
    """Device gather compaction is bit-exact vs the host compact_output,
    including zero-count segments, full segments, and the tail zero-fill."""
    rng = np.random.default_rng(7)
    T, max_n = 57, 13
    n = rng.integers(0, max_n + 1, size=T).astype(np.int32)
    n[5] = 0
    n[6] = 0  # consecutive empty segments exercise the searchsorted dedup
    n[7] = max_n
    padded = rng.standard_normal((T, max_n)).astype(np.float32)
    plan = {"n": n, "n_out": int(n.sum())}
    host = rdev.compact_output(padded, plan)

    out_len = int(n.sum()) + 9
    dev, n_out = rdev.compact_padded_device(jnp.asarray(padded),
                                            jnp.asarray(n), out_len)
    dev = np.asarray(dev)
    assert int(n_out) == plan["n_out"]
    np.testing.assert_array_equal(dev[: plan["n_out"]], host)
    assert np.all(dev[plan["n_out"]:] == 0.0)

    # multi-channel: leading axis broadcasts through the same gather
    padded2 = rng.standard_normal((3, T, max_n)).astype(np.float32)
    dev2, _ = rdev.compact_padded_device(jnp.asarray(padded2),
                                         jnp.asarray(n), out_len)
    dev2 = np.asarray(dev2)
    for c in range(3):
        np.testing.assert_array_equal(
            dev2[c, : plan["n_out"]], rdev.compact_output(padded2[c], plan))
