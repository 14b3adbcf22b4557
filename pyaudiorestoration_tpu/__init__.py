"""pyaudiorestoration_tpu: a JAX audio-restoration framework.

Headless, jit-compiled, shard-aware rebuild of the capabilities of
HENDRIX-ZT2/pyaudiorestoration (see SURVEY.md for the reference analysis,
docs/ARCHITECTURE.md for the design, docs/PARITY.md for the component map).

Subpackages:
    ops        device DSP primitives (STFT, xcorr, filters, resampler, HPSS)
    models     trackers, marker/master-curve model, spectra, visualization
    pipelines  one module per restoration tool
    parallel   (files, time) device-mesh sharding with halo exchange
    kernels    the Pallas (Triton-route) sinc kernel for the GPU
    utils      native audio I/O, project files, cache, undo, streaming
"""

__version__ = "0.1.0"
