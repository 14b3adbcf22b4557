"""Triton-route sinc kernel: parity in interpreter mode on the CPU (alone,
in the dense tier and in the take-batch tier), the wrapper's lane/row
padding, the choice of kernel by platform, and one compiled check that runs
only where there is a GPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyaudiorestoration_tpu.kernels import sinc_triton
from pyaudiorestoration_tpu.pipelines import respeeder_device as rdev


def _wobble_plan(n=16000, hop=256, sr=8000, depth=0.03, seed=7):
    rng = np.random.default_rng(seed)
    sig = (rng.standard_normal(n) * 0.3).astype(np.float32)
    T = n // hop
    t = np.arange(T) * hop / sr
    speeds = 1.0 + depth * np.sin(2 * np.pi * 1.3 * t)
    plan = rdev.plan_positions_fast(speeds, hop, n)
    drift = 8
    while drift < plan["drift"]:
        drift *= 2
    args = (jnp.asarray(sig), jnp.asarray(speeds.astype(np.float32)),
            jnp.asarray(plan["n"]), jnp.asarray(plan["base_int"]),
            jnp.asarray(plan["base_frac"]))
    return args, int(plan["max_n"]), drift


def test_sinc_pallas_matches_banded_xla():
    """The kernel (through the dense tier's dispatch, channels flattened
    into its segment axis) matches the XLA banded formulation."""
    args, max_n, drift = _wobble_plan()
    ref = np.asarray(rdev.sinc_banded_device(*args, max_n, 30, drift))
    got = np.asarray(rdev.run_banded_sinc(*args, max_n, 30, drift,
                                          interpret=True))
    np.testing.assert_allclose(got, ref, atol=3e-5)
    stereo = jnp.stack([args[0], 0.5 * args[0]])
    ref2 = np.asarray(rdev.sinc_banded_device(stereo, *args[1:], max_n, 30,
                                              drift))
    got2 = np.asarray(rdev.run_banded_sinc(stereo, *args[1:], max_n, 30,
                                           drift, interpret=True))
    np.testing.assert_allclose(got2, ref2, atol=3e-5)


def test_pallas_dma_unaligned_signal_length():
    """Windows near both ends of a signal whose length is no multiple of
    anything read zeros outside it, exactly as the XLA tier does."""
    rng = np.random.default_rng(3)
    n = 32768 + 940
    sig = jnp.asarray(rng.standard_normal(n).astype(np.float32) * 0.3)
    step, max_n, nt, drift = 128, 140, 8, 8
    T = n // step - 1
    speeds = jnp.ones((T + 1,), jnp.float32)
    nn = jnp.full((T,), step, jnp.int32)
    bi = jnp.arange(T, dtype=jnp.int32) * step
    bf = jnp.zeros((T,), jnp.float32)
    out_k = np.asarray(rdev.run_banded_sinc(sig, speeds, nn, bi, bf, max_n,
                                            nt, drift, interpret=True))
    out_x = np.asarray(rdev.sinc_banded_device(sig, speeds, nn, bi, bf, max_n,
                                               nt, drift))
    np.testing.assert_allclose(out_k, out_x, atol=2e-5)


@pytest.mark.parametrize("T,max_n", [(7, 140), (5, 2 * sinc_triton.LANES),
                                     (3, sinc_triton.LANES), (9, 70)])
def test_sinc_rows_pads_lanes_and_rows(T, max_n):
    """Lane tiles that overhang max_n (or exactly fit it), odd row counts:
    every valid output equals the XLA shift-MAC, and every masked entry is
    zero."""
    nt, drift = 8, 4
    U = nt + drift
    rng = np.random.default_rng(T + max_n)
    n = rng.integers(max_n // 2, max_n + 1, T).astype(np.int32)
    n[0] = max_n
    bf = rng.uniform(0, 1, T).astype(np.float32)
    s_lo = (1 + 0.01 * rng.standard_normal(T)).astype(np.float32)
    s_hi = (1 + 0.01 * rng.standard_normal(T)).astype(np.float32)
    bs, rel, in_seg = rdev.segment_grids(jnp.asarray(s_lo), jnp.asarray(s_hi),
                                         jnp.asarray(n), jnp.asarray(bf),
                                         max_n)
    L = max_n + 2 * U
    sig = rng.standard_normal(T * L).astype(np.float32)
    starts = np.arange(T, dtype=np.int32) * L
    got = np.asarray(sinc_triton.sinc_rows(
        jnp.asarray(sig), jnp.asarray(starts), bs, rel, jnp.asarray(n), nt=nt,
        drift=drift, interpret=True))
    buf = jnp.asarray(sig.reshape(T, L))
    ref = np.asarray(rdev.sinc_shift_mac(buf, bs, rel, in_seg, max_n, nt,
                                         drift))
    assert got.shape == (T, max_n)
    np.testing.assert_allclose(got, ref, atol=2e-6)
    assert not np.any(got[np.arange(max_n)[None, :] >= n[:, None]])


def _mixed_takes(lengths=(3 * 8192 + 77, 2 * 8192), step=128, n_fft=512):
    """Two takes of unequal length, zero-padded into one batch, with their
    per-frame bands: the ``restore_fused_takes`` arguments."""
    sr, f0 = 8192, 1024.0
    xb = np.zeros((len(lengths), max(lengths)), np.float32)
    for i, L in enumerate(lengths):
        t = np.arange(L) / sr
        speed = 1.0 + 0.012 * np.sin(2 * np.pi * (1.0 + 0.7 * i) * t)
        xb[i, :L] = np.sin(2 * np.pi * f0 * np.cumsum(speed) / sr)
    f0_bin = int(round(f0 * n_fft / sr))
    F = xb.shape[1] // step + 1
    NL = jnp.full((len(lengths), F), f0_bin - 4, jnp.int32)
    NU = jnp.full((len(lengths), F), f0_bin + 5, jnp.int32)
    return (jnp.asarray(xb), NL, NU, n_fft, step, 1, int(step * 1.25), 16,
            16), dict(band=(f0_bin - 6, f0_bin + 7),
                      lengths=np.asarray(lengths))


def test_restore_fused_takes_kernel_matches_xla():
    """The take-batch tier with its takes flattened into the kernel's
    segment axis (interpreted here) matches the same tier's XLA path, take by
    take, and leaves every entry past a segment's count zero."""
    args, kw = _mixed_takes()
    ref = np.asarray(rdev.restore_fused_takes(*args, **kw))
    got = np.asarray(rdev.restore_fused_takes(*args, **kw, interpret=True))
    assert got.shape == ref.shape and got.shape[0] == 2
    np.testing.assert_allclose(got, ref, atol=2e-5)
    assert not np.any(got[ref == 0])


def _lowered_for(fn, platform):
    return jax.jit(fn).trace().lower(lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("tier", ["dense", "takes"])
@pytest.mark.parametrize("platform,want", [("cuda", True), ("cpu", False)])
def test_sinc_kernel_choice_by_platform(tier, platform, want):
    """The kernel is chosen by the platform the program is lowered for (the
    devices its data is on), not by the process's default backend: lowered
    for a CUDA GPU the program holds the Triton kernel, lowered for the CPU
    it holds only the XLA shift-MAC."""
    if tier == "dense":
        args, max_n, drift = _wobble_plan()

        def fn():
            return rdev.run_banded_sinc(*args, max_n, 30, drift)
    else:
        args, kw = _mixed_takes()

        def fn():
            return rdev.restore_fused_takes(*args, **kw)
    assert ("sinc_banded_rows" in _lowered_for(fn, platform)) is want


def test_round_half_even_matches_jnp_round():
    x = jnp.asarray(np.array([-2.5, -1.5, -0.5, 0.0, 0.49999997, 0.5, 1.5,
                              2.5, 3.5, 562.5, 563.5, 1e6 + 0.5, 7.25,
                              -7.75], np.float32))
    np.testing.assert_array_equal(
        np.asarray(sinc_triton._round_half_even(x)), np.asarray(jnp.round(x)))


def test_shift_mac_weights_match_direct_transcendentals():
    """The kernel's tap weights agree with a per-pass float64
    transcendental ground truth at the adversarial cutoffs (fc == 1 exactly
    and fc at the drift-contract floor) — the residual is plain f32 MAC
    accumulation."""
    nt, drift, max_n = 30, 8, 140
    U = nt + drift
    rows = 8
    L = max_n + 2 * U
    rng = np.random.default_rng(3)
    fc_lo = 1.0 / (1.0 + (drift - 2) / max_n)
    for fc_case in ("one", "floor", "mixed"):
        if fc_case == "one":
            bs = np.ones((rows, max_n), np.float32)
        elif fc_case == "floor":
            bs = np.full((rows, max_n), fc_lo, np.float32)
        else:
            bs = (1.0 + 0.02 * rng.standard_normal((rows, max_n))).astype(np.float32)
        k = np.arange(max_n, dtype=np.float64)[None, :]
        rel = (k + rng.uniform(-drift + 1, drift - 1, (rows, max_n))).astype(np.float32)
        buf = rng.standard_normal((rows, L)).astype(np.float32) * 0.3
        got = np.asarray(sinc_triton.sinc_rows(
            jnp.asarray(buf.reshape(-1)),
            jnp.arange(rows, dtype=jnp.int32) * L, jnp.asarray(bs),
            jnp.asarray(rel), jnp.full((rows,), max_n, jnp.int32), nt=nt,
            drift=drift, interpret=True))
        # per-pass float64 transcendental ground truth
        fc = np.minimum(bs.astype(np.float64), 1.0)
        m = np.round(rel.astype(np.float64)) - k
        shift = rel.astype(np.float64) - np.round(rel.astype(np.float64))
        acc = np.zeros((rows, max_n))
        for v in range(2 * U):
            jf = (v - U) - m
            x = (jf - shift) * fc
            w = np.where(np.abs(x) < 1e-12, 1.0, np.sin(np.pi * x) / np.where(
                np.abs(x) < 1e-12, 1.0, np.pi * x)) * fc
            w = w * (0.5 - 0.5 * np.cos(np.pi / nt * (jf + nt)))
            w = np.where((jf >= -nt) & (jf < nt), w, 0.0)
            acc += buf.astype(np.float64)[:, v:v + max_n] * w
        assert np.max(np.abs(got - acc)) < 1e-5, (fc_case, np.max(np.abs(got - acc)))


@pytest.mark.chip
def test_sinc_kernel_compiles_on_gpu():
    """The compiled Triton kernel matches the XLA banded tier on the card
    (the interpreter cannot show what the GPU compiler refuses)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m chip tests/")
    args, max_n, drift = _wobble_plan()
    ref = rdev.sinc_banded_device(*args, max_n, 30, drift)
    got = rdev.run_banded_sinc(*args, max_n, 30, drift)
    assert float(jnp.max(jnp.abs(got - ref))) < 2e-5

