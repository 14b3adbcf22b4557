"""Device selection and the persistent compile cache, plus a profiler-trace
helper (SURVEY.md §5 tracing rebuild note)."""

from __future__ import annotations

import contextlib
import logging
import os

__all__ = ["best_device", "card_description", "compile_cache_dir",
           "profile_trace", "enable_persistent_compile_cache"]

# one fixed directory inside the checkout (listed in .gitignore): the cache
# key includes the path, so a directory that moves never hits
_DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compile_cache_dir() -> str:
    """Where compiled programs persist: ``JAX_COMPILATION_CACHE_DIR`` when
    set (JAX reads that variable itself), else ``.jax_cache`` at the root of
    the checkout."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT_CACHE_DIR


def enable_persistent_compile_cache():
    """Turn on JAX's on-disk compilation cache (idempotent).

    Called by the CLI entry point, the benchmark and the chip smoke run;
    library users can call it themselves.  Failures (read-only filesystems)
    downgrade to a debug log.
    """
    import jax

    if "PYTEST_CURRENT_TEST" in os.environ:
        # Never flip process-global cache config from inside a test process:
        # tests drive cli.main()/doctor in-process, and a crashed run once
        # left a truncated cache entry that SEGFAULTED the next full suite
        # during cache READ (jax compilation_cache.get_executable_and_time).
        return

    try:
        cache_dir = compile_cache_dir()
        os.makedirs(cache_dir, exist_ok=True)
        # a process that crashed mid-write can leave truncated entries that
        # crash the NEXT process during cache read; sweep the obviously-bad
        # ones (empty files, leftover temp files)
        for name in os.listdir(cache_dir):
            p = os.path.join(cache_dir, name)
            try:
                if name.endswith(".tmp") or os.path.getsize(p) == 0:
                    os.unlink(p)
            except OSError:
                pass
        if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
            jax.config.update("jax_compilation_cache_dir", cache_dir)
        # cache everything that took noticeable compile time
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except OSError:
        logging.debug("persistent compile cache unavailable", exc_info=True)


def best_device():
    """The GPU this process computes on; raises when JAX finds none (a
    measurement or a smoke run must not fall back to the CPU)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's default device is {dev}")
    return dev


def card_description() -> str:
    """Each card's name and power limit as ``nvidia-smi`` reports them, to
    print beside every time (a card capped below its maximum power runs
    slower under load)."""
    import subprocess

    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return "; ".join(r.stdout.strip().splitlines())


@contextlib.contextmanager
def profile_trace(log_dir: str | None = None):
    """jax.profiler trace context; no-op when no log_dir is given."""
    if not log_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        logging.info(f"Wrote profiler trace to {log_dir}")
