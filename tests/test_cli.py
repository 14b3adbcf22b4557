"""CLI smoke tests: every subcommand end-to-end on tiny inputs."""

import json
import shutil

import numpy as np
import pytest

from pyaudiorestoration_tpu import cli
from pyaudiorestoration_tpu.utils import audio_io


def run_cli(capsys, *args):
    rc = cli.main(list(args))
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def test_cli_respeed(tmp_path, capsys):
    sr = 22050
    t = np.arange(2 * sr) / sr
    speed = 1.0 + 0.02 * np.sin(2 * np.pi * 1.0 * t)
    sig = (np.sin(2 * np.pi * 2000 * np.cumsum(speed) / sr) * 0.5).astype(np.float32)
    src = tmp_path / "wow.wav"
    audio_io.write_wav(src, sig, sr)
    res = run_cli(capsys, "respeed", str(src), "--fft-size", "2048",
                  "--fft-overlap", "8", "--zeropad", "2", "--sinc-quality", "16",
                  "--save-project")
    assert res["outputs"][0].endswith("_res.wav")
    out, osr, _ = audio_io.read_file(res["outputs"][0])
    assert osr == sr and len(out) > sr
    # GUI Save parity: the traced line landed in a loadable .spd project
    from pyaudiorestoration_tpu.utils import project
    proj = project.Project.load(str(tmp_path / "wow.spd"))
    assert len(proj.marker_list("lines")) == 1
    assert proj.fft_size == 2048


def test_cli_tapesync(tmp_path, capsys, samples_dir):
    from pyaudiorestoration_tpu.utils import project
    ref = tmp_path / "rhythm.flac"
    src = tmp_path / "rhythm5.flac"
    shutil.copy(samples_dir / "rhythm.flac", ref)
    shutil.copy(samples_dir / "rhythm+5percent.flac", src)
    res = run_cli(capsys, "tapesync", str(ref), str(src), "--windows", "6",
                  "--window-s", "0.5", "--sinc-quality", "8", "--save-project")
    assert len(res["outputs"]) == 1
    assert len(res["lags"]) >= 4
    proj = project.Project.load(str(tmp_path / "rhythm5.tapesync"))
    assert len(proj.marker_list("lags")) >= 4
    assert proj.settings["reference"].endswith("rhythm.flac")


def test_cli_heal_project(tmp_path, capsys, samples_dir):
    src = tmp_path / "d.flac"
    shutil.copy(samples_dir / "dropouts_sample.flac", src)
    proj = tmp_path / "d.drop"
    shutil.copy(samples_dir / "dropouts_sample.drop", proj)
    res = run_cli(capsys, "heal", str(src), "--project", str(proj))
    assert res["num_dropouts"] > 10
    assert res["outputs"][0].endswith("_drops.wav")


def test_cli_difeq(tmp_path, capsys, samples_dir):
    res = run_cli(capsys, "difeq", str(samples_dir / "nr_signal.wav"),
                  str(samples_dir / "nr_noise.wav"), "-o", str(tmp_path / "eq.txt"))
    assert len(res["outputs"]) == 3


def test_cli_renoise(tmp_path, capsys, samples_dir):
    src = tmp_path / "nr.wav"
    shutil.copy(samples_dir / "nr_signal.wav", src)
    res = run_cli(capsys, "renoise", str(src), "--noise",
                  str(samples_dir / "nr_noise.wav"), "--gain", "-30")
    out, _, _ = audio_io.read_file(res["outputs"][0])
    assert len(out) > 1000


def test_cli_hpss(tmp_path, capsys, rng):
    sr = 8000
    sig = (rng.standard_normal(sr) * 0.2).astype(np.float32)
    src = tmp_path / "h.wav"
    audio_io.write_wav(src, sig, sr)
    res = run_cli(capsys, "hpss", str(src), "--fft-size", "512", "--kernel", "9")
    assert len(res["outputs"]) == 2


def test_cli_humspeed_analyze(tmp_path, capsys):
    sr = 44100
    t = np.arange(10 * sr) / sr
    sig = (0.05 * np.sin(2 * np.pi * 50.5 * t)).astype(np.float32)
    src = tmp_path / "hum.wav"
    audio_io.write_wav(src, sig, sr)
    res = run_cli(capsys, "humspeed", str(src), "--analyze-only", "--harmonies", "0")
    assert res["matches"]
    assert abs(res["matches"][0]["percent"] - (50 / 50.5 - 1) * 100) < 0.3


def test_cli_pan(tmp_path, capsys, rng):
    from pyaudiorestoration_tpu.models import markers as mk
    from pyaudiorestoration_tpu.utils import project
    sr = 8000
    base = rng.standard_normal(sr).astype(np.float32) * 0.2
    sig = np.stack([base * 1.5, base], -1)
    src = tmp_path / "p.wav"
    audio_io.write_wav(src, sig, sr)
    proj = project.Project(".pan", {}, {"markers": [
        mk.PanSample((0.1, 100.0), (0.9, 3000.0), 1.5)]})
    ppath = tmp_path / "p.pan"
    proj.save(str(ppath))
    res = run_cli(capsys, "pan", str(src), "--project", str(ppath))
    out, _, ch = audio_io.read_file(res["outputs"][0])
    assert ch == 1


def test_cli_respeed_flac_out(tmp_path, capsys):
    """--flac-out reroutes the standard (in-memory) respeed export to FLAC
    (regression: resampling.run hard-coded `_res.wav`, bypassing
    set_output_format)."""
    sr = 22050
    t = np.arange(2 * sr) / sr
    speed = 1.0 + 0.02 * np.sin(2 * np.pi * 1.0 * t)
    sig = (np.sin(2 * np.pi * 2000 * np.cumsum(speed) / sr) * 0.5).astype(np.float32)
    src = tmp_path / "wow.wav"
    audio_io.write_wav(src, sig, sr)
    try:
        res = run_cli(capsys, "--flac-out", "16", "respeed", str(src),
                      "--fft-size", "2048", "--fft-overlap", "8",
                      "--zeropad", "2", "--sinc-quality", "16")
    finally:
        audio_io.set_output_format("wav")
    assert res["outputs"][0].endswith("_res.flac")
    out, osr, _ = audio_io.read_file(res["outputs"][0])
    assert osr == sr and len(out) > sr


def test_cli_doctor_no_device(capsys):
    """doctor --no-device: codec + compile-cache checks, JSON contract,
    exit 0 when healthy (device probes are covered operationally — they
    need a live or deliberately wedged runtime)."""
    rc = cli.main(["doctor", "--no-device"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    rep = json.loads(out)
    assert rc == (0 if rep["healthy"] else 2)
    assert rep["native_codec"]["loaded"] is True
    assert "compile_cache" in rep
    assert "device" not in rep


def test_doctor_cpu_probe_subprocess():
    """The bounded subprocess probe reports a healthy CPU platform (a
    wedged runtime returns status='timeout' instead of hanging)."""
    from pyaudiorestoration_tpu.utils.doctor import _probe_devices

    status, info = _probe_devices(90.0, platform="cpu")
    assert status == "ok", info
    assert info["tiny_op_ok"] and info["device_count"] >= 1


def test_doctor_gates_on_wrong_result(monkeypatch):
    """A device that initializes but computes wrong results must be
    unhealthy (status 'wrong_result'), not 'ok' — orchestration gates on
    this exit code."""
    from pyaudiorestoration_tpu.utils import doctor

    def fake_probe(timeout_s, platform=None):
        if platform == "cpu":
            return "ok", {"tiny_op_ok": True, "device_count": 1}
        return "ok", {"tiny_op_ok": False, "device_count": 1,
                      "platform": "gpu"}

    monkeypatch.setattr(doctor, "_probe_devices", fake_probe)
    rep = doctor.run_doctor(device_timeout_s=5.0)
    assert rep["device"]["status"] == "wrong_result"
    assert rep["healthy"] is False
    assert rep["device"]["cpu_fallback"]["status"] == "ok"


def test_cli_decompress(tmp_path, capsys):
    """decompress: a compressed copy regains the reference's dynamics
    (experiments/decompressor_cmd.py as a subcommand, VERDICT r03 #3)."""
    sr = 22050
    t = np.arange(3 * sr) / sr
    env = 0.2 + 0.8 * (0.5 + 0.5 * np.sin(2 * np.pi * 0.7 * t)) ** 2
    carrier = np.sin(2 * np.pi * 1000 * t)
    ref = (env * carrier).astype(np.float32)
    comp = (np.sign(ref) * np.abs(ref) ** 0.4 * 0.5).astype(np.float32)
    pref, pcmp = tmp_path / "ref.wav", tmp_path / "comp.wav"
    audio_io.write_wav(pref, ref, sr)
    audio_io.write_wav(pcmp, comp, sr)
    res = run_cli(capsys, "decompress", str(pcmp), str(pref))
    out, osr, _ = audio_io.read_file(res["outputs"][0])
    assert osr == sr

    def env_ratio(x):
        x = x[:, 0] if x.ndim == 2 else x
        w = sr // 4
        rms = np.sqrt(np.convolve(x ** 2, np.ones(w) / w, mode="valid"))
        return rms.max() / max(rms.min(), 1e-9)

    # dynamics restored: the output's envelope ratio moves toward the
    # reference's and away from the compressed input's
    r_ref, r_cmp, r_out = env_ratio(ref), env_ratio(comp), env_ratio(out)
    assert abs(np.log(r_out / r_ref)) < abs(np.log(r_cmp / r_ref)) / 2


def test_cli_group_delay(tmp_path, capsys, rng):
    """group-delay: a pure delay between takes is reported per band."""
    sr = 16000
    n = 4 * sr
    base = rng.standard_normal(n + 100).astype(np.float32)
    ref = base[:n]
    src = base[50:50 + n]  # src lags ref by 50 samples
    pref, psrc = tmp_path / "r.wav", tmp_path / "s.wav"
    audio_io.write_wav(pref, ref, sr)
    audio_io.write_wav(psrc, src, sr)
    res = run_cli(capsys, "group-delay", str(pref), str(psrc),
                  "--lower", "100", "--upper", "2000", "--bandwidth", "200")
    assert res["sr"] == sr and len(res["bands"]) >= 3
    lags = [b["lag_samples"] for b in res["bands"]]
    assert all(abs(abs(l) - 50) < 3 for l in lags), lags
    assert len({np.sign(l) for l in lags}) == 1  # consistent sign across bands


def test_cli_cyclic_wow(tmp_path, capsys):
    """cyclic-wow: a synthetic 45 rpm once-per-rotation wobble is measured."""
    sr = 22050
    rpm_true = 44.0
    dur = 12.0
    t = np.arange(int(dur * sr)) / sr
    speed = 1.0 + 0.01 * np.sin(2 * np.pi * (rpm_true / 60.0) * t)
    sig = (0.5 * np.sin(2 * np.pi * 700 * np.cumsum(speed) / sr)).astype(np.float32)
    p = tmp_path / "rec.wav"
    audio_io.write_wav(p, sig, sr)
    curve_out = str(tmp_path / "cycle.txt")
    res = run_cli(capsys, "cyclic-wow", str(p), "--rpm", "45",
                  "--curve-out", curve_out)
    assert abs(res["actual_rpm"] - rpm_true) < 1.0, res
    assert 0.1 < res["wow_depth_semitones"] < 1.0
    curve = np.loadtxt(curve_out)
    assert len(curve) == res["frames_per_rotation"]


def test_cli_dropouts_batch(tmp_path, capsys):
    """dropouts-batch heuristic smoke (regression: the dispatch read
    args.stream but the flag was never defined)."""
    sr = 22050
    t = np.arange(2 * sr) / sr
    sig = (0.4 * np.sin(2 * np.pi * 500 * t)
           + 0.2 * np.sin(2 * np.pi * 200 * t)).astype(np.float32)
    sig[int(0.9 * sr):int(0.9 * sr) + 300] *= 0.05
    src = tmp_path / "drops.wav"
    audio_io.write_wav(src, np.stack([sig, 0.9 * sig], -1), sr)
    res = run_cli(capsys, "dropouts-batch", str(src), "--fft-size", "512",
                  "--num-bands", "6", "--f-lower", "100", "--f-upper", "1000")
    out, osr, ch = audio_io.read_file(res["outputs"][0])
    assert osr == sr and ch == 2 and len(out) == len(sig)
