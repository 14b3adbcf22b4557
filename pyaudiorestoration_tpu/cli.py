"""Command-line interface for the audio-restoration framework.

The reference ships GUI tools only (no CLI flags anywhere, SURVEY.md §5);
here every tool pipeline is a subcommand consuming the same JSON project
formats the GUIs write:

    python -m pyaudiorestoration_tpu respeed   <audio|project.spd> [...]
    python -m pyaudiorestoration_tpu tapesync  <ref> <src> [...]
    python -m pyaudiorestoration_tpu heal      <audio> [--project x.drop] [...]
    python -m pyaudiorestoration_tpu difeq     <src> <ref> -o out [...]
    python -m pyaudiorestoration_tpu expand    <audio> [...]
    python -m pyaudiorestoration_tpu humspeed  <audio> [...]
    python -m pyaudiorestoration_tpu pan       <audio> --project x.pan
    python -m pyaudiorestoration_tpu renoise   <audio> --noise noise.wav [...]
    python -m pyaudiorestoration_tpu hpss      <audio> [...]
    python -m pyaudiorestoration_tpu dropouts-batch <audio> [...]
"""

from __future__ import annotations

import argparse
import json
import logging
import sys


def _add_fft_args(p, fft_size=1024, overlap=4, zeropad=1):
    p.add_argument("--fft-size", type=int, default=fft_size)
    p.add_argument("--fft-overlap", type=int, default=overlap)
    p.add_argument("--zeropad", type=int, default=zeropad)


def build_parser():
    p = argparse.ArgumentParser(prog="pyaudiorestoration_tpu",
                                description="JAX audio restoration")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="force the JAX backend; 'cpu' runs without the GPU "
                        "when its runtime is unhealthy (must be set before "
                        "first device use)")
    p.add_argument("--flac-out", nargs="?", const=24, type=int, default=None,
                   metavar="BITS",
                   help="write outputs as FLAC (native encoder) instead of "
                        "float32 WAV; optional bit depth 16 or 24 (default 24)."
                        " Applies to in-memory AND streamed export paths")
    p.add_argument("--flac-fast", action="store_true",
                   help="with --flac-out: fixed-predictor-only encoding "
                        "(like `flac -0`) — ~20%% faster encode and ~2.5x "
                        "faster decode of the produced archive, ~1/3 larger")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("respeed", help="wow & flutter removal (pyrespeeder)")
    sp.add_argument("input", help="audio file or .spd project")
    sp.add_argument("--mode", default="Peak",
                    choices=["Peak", "Peak Track", "Center of Gravity",
                             "Zero-Crossing", "Freehand Draw", "Correlation"])
    sp.add_argument("--trail", type=float, nargs="+", default=None,
                    metavar="T F", help="trail points t0 f0 t1 f1 ...")
    _add_fft_args(sp, 1024, 8, 4)
    sp.add_argument("--tolerance", type=float, default=1.0)
    sp.add_argument("--adaptation", default="None",
                    choices=["None", "Constant", "Linear", "Average"],
                    help="band prediction mode for Peak tracing "
                         "(adapt_band, wow_detection.py:142-187)")
    sp.add_argument("--resampling-mode", default="Sinc", choices=["Sinc", "Linear"])
    sp.add_argument("--sinc-quality", type=int, default=50)
    sp.add_argument("--suffix", default="")
    sp.add_argument("--fast", action="store_true",
                    help="device-resident pipeline (auto pilot-tone tracking)")
    sp.add_argument("--stream", action="store_true",
                    help="two-pass streamed restore for files larger than "
                         "memory (implies --fast)")
    sp.add_argument("--f0", type=float, default=None,
                    help="target frequency for --fast tracking")
    sp.add_argument("--save-project", action="store_true",
                    help="write the traced markers to <audio>.spd (GUI Save parity)")

    sp = sub.add_parser("respeed-batch",
                        help="data-parallel wow/flutter fix over the device mesh")
    sp.add_argument("inputs", nargs="+")
    sp.add_argument("--f0", type=float, default=None,
                    help="pilot/target frequency to track (fused tier "
                         "auto-probes when omitted)")
    sp.add_argument("--fft-size", type=int, default=512)
    sp.add_argument("--step", type=int, default=128)
    sp.add_argument("--tier", default="fused", choices=["fused", "fixed"],
                    help="fused = the fast single-chip kernels on the mesh "
                         "(banded-DFT + quality sinc); fixed = the "
                         "fixed-length linear tier")
    sp.add_argument("--sinc-quality", type=int, default=50)
    sp.add_argument("--zeropad", type=int, default=1)

    sp = sub.add_parser("tapesync", help="align source to reference (pytapesynch)")
    sp.add_argument("reference")
    sp.add_argument("source", nargs="?", help="omit when reference is a .tapesync project")
    sp.add_argument("--windows", type=int, default=8)
    sp.add_argument("--window-s", type=float, default=1.0)
    sp.add_argument("--lower", type=float, default=100.0)
    sp.add_argument("--upper", type=float, default=None)
    sp.add_argument("--smoothing", type=int, default=3)
    sp.add_argument("--sinc-quality", type=int, default=50)
    sp.add_argument("--suffix", default="")
    sp.add_argument("--save-project", action="store_true",
                    help="write lag markers to <source>.tapesync (GUI Save parity)")
    sp.add_argument("--compare", metavar="PNG_OR_HTML",
                    help="write a red/green overlay of reference vs aligned "
                         "output (the GUI's 2-source compare view); a .html "
                         "target gets the interactive pan/zoom viewer")

    sp = sub.add_parser("heal", help="dropout healing (dropout_healer)")
    sp.add_argument("input")
    sp.add_argument("--project", help=".drop project with markers")
    sp.add_argument("--detect", nargs=4, type=float, metavar=("T0", "T1", "F0", "F1"),
                    help="auto-detect inside this region instead")
    sp.add_argument("--width-ms", type=float, default=20.0)
    sp.add_argument("--sensitivity", type=float, default=5.0)
    _add_fft_args(sp, 512, 16)
    sp.add_argument("--suffix", default="")
    sp.add_argument("--stream", action="store_true",
                    help="force the blockwise larger-than-memory path")

    sp = sub.add_parser("dropouts-batch", help="batch heuristic dropout repair")
    sp.add_argument("inputs", nargs="+")
    sp.add_argument("--mode", default="Heuristic", choices=["Heuristic", "MaxMono"])
    _add_fft_args(sp, 1024, 4)
    # heuristic tuning (the reference's DropsWidget, widgets.py:686-765)
    sp.add_argument("--max-width", type=float, default=0.02,
                    help="max dropout width in seconds")
    sp.add_argument("--max-slope", type=float, default=0.5,
                    help="max dB/frame slant around a dropout")
    sp.add_argument("--num-bands", type=int, default=12)
    sp.add_argument("--bottom-freedom", type=float, default=2.0)
    sp.add_argument("--f-lower", type=float, default=3000.0)
    sp.add_argument("--f-upper", type=float, default=12000.0)
    sp.add_argument("--suffix", default="")
    sp.add_argument("--stream", action="store_true",
                    help="force the blockwise larger-than-memory path")

    sp = sub.add_parser("difeq", help="differential EQ (difeq)")
    sp.add_argument("source")
    sp.add_argument("reference")
    sp.add_argument("-o", "--output", required=True, help="output base path (.txt)")
    sp.add_argument("--channels", default="L+R", choices=["L+R", "L", "R"])
    sp.add_argument("--smoothing", type=int, default=50)
    sp.add_argument("--strength", type=float, default=1.0)
    sp.add_argument("--keep-gain", action="store_true")
    sp.add_argument("--highpass", type=float, default=0)
    sp.add_argument("--rolloff-start", type=float, default=21000)
    sp.add_argument("--rolloff-end", type=float, default=22000)

    sp = sub.add_parser("expand", help="spectral expander (expander)")
    sp.add_argument("input")
    sp.add_argument("--channels", default="L+R", choices=["L+R", "L", "R", "Mean"])
    sp.add_argument("--band-lower", type=float, default=13000)
    sp.add_argument("--band-upper", type=float, default=17000)
    sp.add_argument("--clip-lower", type=float, default=-120)
    sp.add_argument("--clip-upper", type=float, default=-85)
    sp.add_argument("--smoothing-s", type=float, default=0.11)
    sp.add_argument("--transition", type=float, default=0)
    sp.add_argument("--order", type=int, default=1)
    sp.add_argument("--suffix", default="_decompressed")
    sp.add_argument("--stream", action="store_true",
                    help="force the blockwise larger-than-memory path")

    sp = sub.add_parser("humspeed", help="hum-based speed analysis/correction")
    sp.add_argument("input")
    sp.add_argument("--base-hum", type=int, default=50)
    sp.add_argument("--harmonies", type=int, default=2)
    sp.add_argument("--tolerance", type=float, default=8)
    sp.add_argument("--analyze-only", action="store_true")
    sp.add_argument("--stream", action="store_true",
                    help="force the blockwise larger-than-memory resample")

    sp = sub.add_parser("pan", help="pan matching (pypan)")
    sp.add_argument("input")
    sp.add_argument("--project", required=True, help=".pan project with markers")

    sp = sub.add_parser("renoise", help="renoiser / denoiser")
    sp.add_argument("input")
    sp.add_argument("--noise", help="noise profile audio file")
    sp.add_argument("--selection", nargs=2, type=float, metavar=("T0", "T1"),
                    help="noise span inside the input")
    sp.add_argument("--gain", type=float, default=-40.0)
    sp.add_argument("--overhead", type=float, default=0.0)
    sp.add_argument("--preview", metavar="PNG",
                    help="write a before/after masked-spectrogram image via "
                         "the re-mask-only fast path (no audio output)")
    _add_fft_args(sp, 1024, 4)
    sp.add_argument("--suffix", default=None,
                    help="output suffix (default: ' fft=<size>')")
    sp.add_argument("--stream", action="store_true",
                    help="force the blockwise larger-than-memory path")


    sp = sub.add_parser("hpss", help="harmonic/percussive separation")
    sp.add_argument("inputs", nargs="+")
    sp.add_argument("--kernel", type=int, default=31)
    sp.add_argument("--power", type=float, default=2.0)
    sp.add_argument("--margin", type=float, default=1.0)
    _add_fft_args(sp, 2048, 4)
    sp.add_argument("--suffix", default="")
    sp.add_argument("--stream", action="store_true",
                    help="force the blockwise larger-than-memory path")


    sp = sub.add_parser("view", help="interactive HTML spectrogram viewer")
    sp.add_argument("input")
    sp.add_argument("-o", "--output", default=None, help="output .html (default <input>.html)")
    _add_fft_args(sp, 1024, 4)
    sp.add_argument("--channel", type=int, default=0)
    sp.add_argument("--cmap", default="izo")
    sp.add_argument("--trail", type=float, nargs="+", default=None,
                    metavar="T F", help="overlay a traced Peak curve from this trail")

    sp = sub.add_parser("listen", help="self-contained HTML audition page "
                        "(playback cursor + A/B, the GUI AudioWidget headless)")
    sp.add_argument("inputs", nargs="+", help="one or two audio files (A/B)")
    sp.add_argument("-o", "--output", default="audition.html")
    sp.add_argument("--start", type=float, default=0.0, help="start seconds")
    sp.add_argument("--seconds", type=float, default=60.0,
                    help="max embedded duration")

    sp = sub.add_parser("measure", help="quality metrics (flutter / SNR / spectral distance)")
    sp.add_argument("input")
    sp.add_argument("compare_to", nargs="?", default=None,
                    help="second file for SNR / spectral distance")
    sp.add_argument("--metric", default="all",
                    choices=["all", "flutter", "snr", "spectral"])

    sp = sub.add_parser("decompress", help="transfer a reference's dynamics "
                        "onto a compressed source (decompressor)")
    sp.add_argument("source", help="dynamically compressed file to fix")
    sp.add_argument("reference", help="file with the target dynamics")
    sp.add_argument("--hop", type=int, default=32)
    sp.add_argument("--rms-size", type=int, default=512,
                    help="RMS window size (samples)")
    sp.add_argument("--lower", type=float, default=80.0)
    sp.add_argument("--upper", type=float, default=9000.0)
    sp.add_argument("--smoothing", type=float, default=0.08,
                    metavar="SEC", help="gain-curve smoothing (seconds)")
    sp.add_argument("--sync", action="store_true",
                    help="cross-correlate the RMS envelopes and align first")
    sp.add_argument("--stream", action="store_true",
                    help="force the blockwise larger-than-memory path")

    sp = sub.add_parser("group-delay", help="per-band delay & correlation "
                        "between two takes (group_delay diagnostics)")
    sp.add_argument("reference")
    sp.add_argument("source")
    sp.add_argument("--lower", type=float, default=10.0)
    sp.add_argument("--upper", type=float, default=2000.0)
    sp.add_argument("--bandwidth", type=float, default=45.0)
    sp.add_argument("--order", type=int, default=1)
    sp.add_argument("--min-corr", type=float, default=0.6,
                    help="report only bands above this correlation")

    sp = sub.add_parser("cyclic-wow", help="once-per-rotation wow analysis "
                        "of a record transfer (cyclic_wow)")
    sp.add_argument("input")
    sp.add_argument("--rpm", type=float, default=45.0,
                    help="nominal record speed")
    sp.add_argument("--f0", type=float, default=700.0,
                    help="tone to trace")
    sp.add_argument("--fft-size", type=int, default=16384)
    sp.add_argument("--tolerance", type=float, default=0.1,
                    help="cycle-length search range (fraction of nominal)")
    sp.add_argument("--curve-out", metavar="TXT",
                    help="write the averaged cycle curve (one value per "
                         "frame, semitones) to a text file")

    sp = sub.add_parser("bench", help="run the benchmark")

    sp = sub.add_parser("doctor", help="bounded environment/device health "
                        "checks (codec, compile cache, device runtime)")
    sp.add_argument("--device-timeout", type=float, default=120.0,
                    help="seconds before declaring the device runtime wedged")
    sp.add_argument("--no-device", action="store_true",
                    help="skip the device probe (codec/cache checks only)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(levelname)s | %(message)s")
    if args.platform:
        import jax

        jax.config.update("jax_platforms",
                          {"gpu": "cuda"}.get(args.platform, args.platform))
    from .utils.device import enable_persistent_compile_cache

    enable_persistent_compile_cache()  # a no-op under pytest (see there)
    if args.flac_out is not None:
        from .utils import audio_io

        audio_io.set_output_format("flac", bits=args.flac_out,
                                   level=0 if args.flac_fast else 1)
    try:
        return _dispatch(args)
    except (OSError, ValueError) as e:
        # user-facing input problems get a clean one-line exit, not a traceback
        if args.verbose:
            raise
        print(f"error: {e}", file=sys.stderr)
        return 1


def _dispatch(args):
    if args.cmd == "respeed":
        from .pipelines import respeeder
        if args.input.endswith(".spd"):
            out = respeeder.run_project(
                args.input, out_suffix=args.suffix,
                stream=True if args.stream else "auto")
        elif args.fast or args.stream:
            from .pipelines import respeeder_device
            out = [respeeder_device.restore_file_fast(
                args.input, f0_hz=args.f0, tolerance_st=args.tolerance,
                fft_size=args.fft_size, fft_overlap=args.fft_overlap,
                zeropad=args.zeropad, sinc_quality=args.sinc_quality,
                suffix=args.suffix, stream=True if args.stream else "auto")]
        else:
            trail = None
            if args.trail:
                pts = args.trail
                trail = [(pts[i], pts[i + 1]) for i in range(0, len(pts), 2)]
            out = respeeder.restore_file(
                args.input, mode=args.mode, fft_size=args.fft_size,
                fft_overlap=args.fft_overlap, zeropad=args.zeropad,
                tolerance=args.tolerance, trail=trail,
                resampling_mode=args.resampling_mode,
                sinc_quality=args.sinc_quality, suffix=args.suffix,
                save_project=args.save_project, adapt=args.adaptation)
        print(json.dumps({"outputs": out}))
    elif args.cmd == "respeed-batch":
        from .parallel import batch
        if args.tier == "fused":
            outs = batch.restore_batch_files_fused(
                args.inputs, args.f0, fft_size=args.fft_size,
                fft_overlap=max(1, args.fft_size // args.step),
                zeropad=args.zeropad, sinc_quality=args.sinc_quality)
        else:
            if args.f0 is None:
                raise ValueError("--tier fixed requires --f0")
            outs = batch.restore_batch_files(args.inputs, args.f0,
                                             n_fft=args.fft_size,
                                             step=args.step)
        print(json.dumps({"outputs": outs}))
    elif args.cmd == "tapesync":
        from .pipelines import tapesynch
        from .utils import project
        ref, src = args.reference, args.source
        if ref.endswith(".tapesync"):
            proj = project.Project.load(ref)
            ref = proj.settings.get("reference")
            src = src or proj.settings.get("source")
        paths, samples, curve = tapesynch.align_files(
            ref, src, out_suffix=args.suffix, num_windows=args.windows,
            window_s=args.window_s, lower=args.lower, upper=args.upper,
            smoothing=args.smoothing, sinc_quality=args.sinc_quality,
            save_project=args.save_project)
        out = {"outputs": paths, "lags": [s.to_cfg() for s in samples]}
        if args.compare:
            import numpy as np
            from .models import viz
            from .ops import fourier
            from .utils import audio_io
            ref_sig, sr, _ = audio_io.read_file(ref)
            out_sig, _, _ = audio_io.read_file(paths[0])
            fft, hop = 1024, 256
            mag_a = np.asarray(fourier.get_mag(ref_sig[:, 0], fft, hop))
            mag_b = np.asarray(fourier.get_mag(out_sig[:, 0], fft, hop))
            if args.compare.endswith(".html"):
                from .models import viz_html
                out["compare"] = viz_html.save_interactive_compare_html(
                    args.compare, mag_a, mag_b, sr, hop)
            else:
                out["compare"] = viz.save_comparison(args.compare, mag_a,
                                                     mag_b, sr, hop)
        print(json.dumps(out))
    elif args.cmd == "heal":
        from .pipelines import dropouts
        from .utils import audio_io, project
        from .ops import fourier, units
        import numpy as np
        if args.project:
            proj = project.Project.load(args.project)
            drops = proj.marker_list("dropouts")
            fft_size, overlap = proj.fft_size, proj.fft_overlap
        elif args.detect is None:
            raise ValueError("heal needs either --project or --detect T0 T1 F0 F1")
        else:
            fft_size, overlap = args.fft_size, args.fft_overlap
            signal, sr, _ = audio_io.read_file(args.input)
            hop = fft_size // overlap
            mag = np.asarray(fourier.get_mag(signal[:, 0], fft_size, hop))
            t0, t1, f0, f1 = args.detect
            drops = dropouts.detect_dropouts(units.to_dB(mag), sr, hop, fft_size,
                                             t0, t1, f0, f1, args.width_ms,
                                             args.sensitivity)
        out = dropouts.heal_file(args.input, drops, fft_size, overlap,
                                 suffix=args.suffix,
                                 stream=True if args.stream else "auto")
        print(json.dumps({"outputs": [out], "num_dropouts": len(drops)}))
    elif args.cmd == "dropouts-batch":
        from .pipelines import dropouts
        outs = []
        for path in args.inputs:
            if args.mode == "Heuristic":
                outs.append(dropouts.process_heuristic(
                    path, args.fft_size, args.fft_overlap,
                    max_width=args.max_width, max_slope=args.max_slope,
                    num_bands=args.num_bands,
                    bottom_freedom=args.bottom_freedom,
                    f_lower=args.f_lower, f_upper=args.f_upper,
                    suffix=args.suffix,
                    stream=True if args.stream else "auto"))
            else:
                outs.extend(dropouts.process_max_mono(
                    path, args.fft_size, args.fft_overlap,
                    suffix=args.suffix,
                    stream=True if args.stream else "auto"))
        print(json.dumps({"outputs": outs}))
    elif args.cmd == "view":
        import numpy as np
        from .models import viz_html
        from .ops import fourier
        from .utils import audio_io
        sig, sr, _ch = audio_io.read_file(args.input)
        hop = args.fft_size // args.fft_overlap
        mag = np.asarray(fourier.get_mag(sig[:, args.channel], args.fft_size,
                                         hop, zeropad=args.zeropad))
        markers = []
        if args.trail:
            from .models import trackers
            pts = list(zip(args.trail[::2], args.trail[1::2]))
            times, freqs = trackers.trace("Peak", mag, sig, pts,
                                          args.fft_size * args.zeropad, hop, sr)
            markers.append({"t": list(times), "f": list(freqs)})
        out = args.output or (args.input.rsplit(".", 1)[0] + ".html")
        import os as _os
        viz_html.save_interactive_html(out, mag, sr, hop, markers=markers,
                                       title=_os.path.basename(args.input),
                                       cmap=args.cmap)
        print(json.dumps({"outputs": [out]}))
    elif args.cmd == "measure":
        from .utils import metrics
        print(json.dumps(metrics.measure_files(args.input, args.compare_to,
                                               args.metric)))
    elif args.cmd == "difeq":
        from .pipelines import difeq
        base = args.output[:-4] if args.output.endswith(".txt") else args.output
        freqs_av, av, paths = difeq.difeq_files(
            args.source, args.reference, base, channel_mode=args.channels,
            smoothing=args.smoothing, strength=args.strength,
            keep_gain=args.keep_gain, highpass=args.highpass,
            rolloff_start=args.rolloff_start, rolloff_end=args.rolloff_end)
        print(json.dumps({"outputs": paths}))
    elif args.cmd == "expand":
        from .pipelines import expander
        out = expander.expand_file(
            args.input, channel_mode=args.channels, band_lower=args.band_lower,
            band_upper=args.band_upper, clip_lower=args.clip_lower,
            clip_upper=args.clip_upper, smoothing_s=args.smoothing_s,
            transition=args.transition, order=args.order, suffix=args.suffix,
            stream=True if args.stream else "auto")
        print(json.dumps({"outputs": [out]}))
    elif args.cmd == "humspeed":
        from .pipelines import humspeed
        matches = humspeed.analyze_hum(args.input, base_hum=args.base_hum,
                                       num_harmonies=args.harmonies,
                                       tolerance=args.tolerance)
        if args.analyze_only or not matches:
            print(json.dumps({"matches": matches}))
        else:
            out = humspeed.resample_file(
                args.input, ratio=matches[-1]["ratio"],
                stream=True if args.stream else "auto")
            print(json.dumps({"matches": matches, "outputs": [out]}))
    elif args.cmd == "pan":
        from .pipelines import pan
        from .utils import project
        proj = project.Project.load(args.project)
        out = pan.pan_file(args.input, proj.marker_list("markers"))
        print(json.dumps({"outputs": [out]}))
    elif args.cmd == "renoise":
        from .pipelines import renoiser
        if args.preview:
            import matplotlib
            matplotlib.use("Agg", force=False)
            import matplotlib.pyplot as plt

            from .models import viz
            from .utils import audio_io
            signal, sr, _ = audio_io.read_file(args.input)
            pv = renoiser.RenoisePreview(signal, sr, args.fft_size,
                                         args.fft_overlap)
            if args.noise:
                profile = renoiser.noise_profile_from_file(
                    args.noise, sr, args.fft_size, args.fft_overlap)
            elif args.selection:
                profile = pv.noise_profile_from_selection(*args.selection)
            else:
                raise ValueError("preview needs --noise or --selection")
            masked = pv.remask(profile, args.gain, overhead=args.overhead)
            fig, axes = plt.subplots(2, 1, figsize=(12, 9))
            viz.plot_spectrogram(pv.magnitude(), sr, pv.hop, ax=axes[0])
            axes[0].set_title("original")
            viz.plot_spectrogram(masked, sr, pv.hop, ax=axes[1])
            axes[1].set_title(f"masked (gain {args.gain} dB)")
            fig.savefig(args.preview, dpi=120, bbox_inches="tight")
            plt.close(fig)
            print(json.dumps({"preview": args.preview}))
        else:
            out = renoiser.process_file(
                args.input, noise_path=args.noise,
                selection=tuple(args.selection) if args.selection else None,
                gain=args.gain, overhead=args.overhead, fft_size=args.fft_size,
                fft_overlap=args.fft_overlap, suffix=args.suffix,
                stream=True if args.stream else "auto")
            print(json.dumps({"outputs": [out]}))
    elif args.cmd == "hpss":
        from .pipelines import hpss_tool
        outs = []
        for path in args.inputs:
            outs.extend(hpss_tool.separate_file(
                path, args.fft_size, args.fft_overlap, args.kernel,
                args.power, args.margin, suffix=args.suffix,
                stream=True if args.stream else "auto"))
        print(json.dumps({"outputs": outs}))
    elif args.cmd == "listen":
        from .models import audition
        from .utils import audio_io
        takes = []
        sr = None
        for path in args.inputs:
            sig, sr_i, _ = audio_io.read_file(path)
            if sr is None:
                sr = sr_i
            elif sr_i != sr:
                raise ValueError("all takes must share one sample rate")
            s0 = int(args.start * sr)
            import os as _os
            takes.append((_os.path.basename(path), sig[s0:]))
        out = audition.save_audition_html(args.output, takes, sr,
                                          title=" vs ".join(
                                              n for n, _ in takes),
                                          max_seconds=args.seconds)
        print(json.dumps({"outputs": [out]}))
    elif args.cmd == "decompress":
        from .pipelines import decompressor
        out = decompressor.decompress_file(
            args.source, args.reference,
            stream=True if args.stream else "auto",
            hop=args.hop, sz=args.rms_size, lower=args.lower,
            upper=args.upper, smoothing_sec=args.smoothing,
            do_sync=args.sync)
        print(json.dumps({"outputs": [out]}))
    elif args.cmd == "group-delay":
        from .pipelines import group_delay
        from .utils import audio_io
        ref, sr, _ = audio_io.read_file(args.reference)
        src, sr2, _ = audio_io.read_file(args.source)
        if sr != sr2:
            raise ValueError("Both files must have the same sample rate")
        bands = group_delay.band_delays(
            ref[:, 0], src[:, 0], sr, f_lower=args.lower, f_upper=args.upper,
            bandwidth=args.bandwidth, order=args.order,
            min_corr=args.min_corr)
        print(json.dumps({"sr": sr, "bands": bands}))
    elif args.cmd == "cyclic-wow":
        import numpy as np

        from .pipelines import cyclic_wow
        from .utils import audio_io
        sig, sr, _ = audio_io.read_file(args.input)
        res = cyclic_wow.analyze(sig, sr, rpm=args.rpm, f0=args.f0,
                                 fft_size=args.fft_size,
                                 tolerance=args.tolerance)
        curve = np.asarray(res.pop("cycle_curve"))
        res.pop("scan", None)
        if args.curve_out:
            np.savetxt(args.curve_out, 12.0 * (curve - np.mean(curve)))
            res["curve_out"] = args.curve_out
        print(json.dumps(res))
    elif args.cmd == "bench":
        import runpy
        runpy.run_path("bench.py", run_name="__main__")
    elif args.cmd == "doctor":
        from .utils.doctor import run_doctor

        report = run_doctor(device_timeout_s=args.device_timeout,
                            skip_device=args.no_device)
        print(json.dumps(report))
        return 0 if report["healthy"] else 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
