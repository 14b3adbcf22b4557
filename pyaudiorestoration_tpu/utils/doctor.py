"""Bounded environment/health checks: the ``doctor`` CLI subcommand.

Production deployments hit three recurring operational failures that are
miserable to diagnose from a hung pipeline: a wedged device runtime
(``jax.devices()`` blocks forever), a native codec library that silently
fell back to the slow path, and a cold compile cache that makes the first
restore take minutes.  ``doctor`` checks each with hard timeouts and
reports one JSON object, so orchestration can gate on it (the reference has
no equivalent; SURVEY.md §5 "failure detection").

Device probes run in a SUBPROCESS with a timeout — a wedged PJRT runtime
hangs inside native init where in-process watchdogs (signals, faulthandler)
cannot fire.  That child opens the device, so it may run only while this
process holds none (a JAX process on the GPU reserves most of its memory).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

__all__ = ["run_doctor"]

_PROBE = """
import json, os, time
t0 = time.perf_counter()
import jax
plat = os.environ.pop("_DOCTOR_PLATFORM", "")
if plat:
    jax.config.update("jax_platforms", plat)
import jax.numpy as jnp
devs = jax.devices()
t_init = time.perf_counter() - t0
t0 = time.perf_counter()
val = float(jnp.sum(jnp.ones((128,)) * 2.0))
t_op = time.perf_counter() - t0
print(json.dumps({
    "platform": devs[0].platform,
    "device_count": len(devs),
    "device_kind": getattr(devs[0], "device_kind", ""),
    "init_s": round(t_init, 2),
    "tiny_op_s": round(t_op, 2),
    "tiny_op_ok": val == 256.0,
}))
"""


def _probe_devices(timeout_s: float, platform: str | None = None):
    """Run the device probe in a subprocess; returns (status, info dict)."""
    env = dict(os.environ)
    if platform:
        env["_DOCTOR_PLATFORM"] = platform
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE],
                           capture_output=True, text=True, env=env,
                           timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return "timeout", {"timeout_s": timeout_s}
    if r.returncode != 0:
        return "error", {"stderr": r.stderr.strip()[-400:]}
    try:
        return "ok", json.loads(r.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return "error", {"stdout": r.stdout.strip()[-400:]}


def run_doctor(device_timeout_s: float = 120.0, skip_device: bool = False):
    """Collect the health report dict (printed as JSON by the CLI)."""
    report = {"healthy": True}

    # native codec
    t0 = time.perf_counter()
    try:
        from . import audio_io

        lib = audio_io._get_lib()
        report["native_codec"] = {
            "loaded": lib is not None,
            "load_s": round(time.perf_counter() - t0, 2),
        }
        if lib is None:
            report["healthy"] = False
            report["native_codec"]["hint"] = (
                "libaudioio.so missing and build failed; check a C++ "
                "toolchain is available (make -C pyaudiorestoration_tpu/native)")
    except Exception as e:  # noqa: BLE001 - health check must not raise
        report["native_codec"] = {"loaded": False, "error": repr(e)}
        report["healthy"] = False

    # compile cache
    try:
        from .device import enable_persistent_compile_cache

        enable_persistent_compile_cache()
        import jax

        cache_dir = jax.config.jax_compilation_cache_dir
        n_entries = 0
        if cache_dir and os.path.isdir(cache_dir):
            n_entries = sum(1 for _ in os.scandir(cache_dir))
        report["compile_cache"] = {"dir": cache_dir, "entries": n_entries,
                                   "warm": n_entries > 0}
    except Exception as e:  # noqa: BLE001
        report["compile_cache"] = {"error": repr(e)}

    # device runtime (bounded; a wedged runtime must not hang the doctor)
    if not skip_device:
        status, info = _probe_devices(device_timeout_s)
        if status == "ok" and not info.get("tiny_op_ok", False):
            # initialized but computing WRONG results — worse than down
            status = "wrong_result"
        report["device"] = {"status": status, **info}
        if status != "ok":
            report["healthy"] = False
            # a CPU fallback probe tells operators whether jax itself works
            cpu_status, cpu_info = _probe_devices(60.0, platform="cpu")
            report["device"]["cpu_fallback"] = {"status": cpu_status, **cpu_info}

    return report
