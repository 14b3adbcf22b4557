"""Headless audio audition — the playback half of the reference's GUI shell.

The reference plays audio through Qt (`AudioWidget`, util/snd.py:13-147) with
a 25 Hz wall-clock playback cursor thread (`CursorUpdater`,
util/qt_threads.py:38-68).  Accelerator hosts are headless, so the
equivalent here is a self-contained HTML page: native ``<audio>`` transport
(play/pause/seek/volume — snd.py's whole surface), a spectrogram strip with
a playback cursor driven by ``requestAnimationFrame`` (frame-accurate where
the reference's thread loop self-describes as "inaccurate"), and optional
A/B switching between the original and a restored take — the audition loop
every restoration session ends with.

No external assets: audio embeds as a base64 16-bit WAV data URI, the
spectrogram as the same stdlib PNG used by models/viz_html.py.
"""

from __future__ import annotations

import base64
import html as _html
import io
import json
import struct

import numpy as np

from ..ops import units

__all__ = ["save_audition_html"]

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>{title}</title><style>
body {{ background:#181818; color:#ddd; font:14px sans-serif; margin:0 }}
#bar {{ padding:8px 12px; background:#222 }}
.lane {{ margin:12px; position:relative }}
.lane img {{ width:100%; height:160px; display:block; image-rendering:auto }}
.cursor {{ position:absolute; top:0; bottom:0; width:1.5px; background:#ff5050;
          left:0; pointer-events:none }}
audio {{ width:calc(100% - 24px); margin:4px 12px }}
button {{ margin-left:12px }}
.name {{ position:absolute; left:6px; top:4px; color:#fff;
        text-shadow:0 0 3px #000 }}
</style></head><body>
<div id="bar">{title} <span id="which"></span>
<button onclick="toggle()" id="tg" {tg_hidden}>A / B</button></div>
{lanes}
<script>
const metas = {metas};
const audios = [], lanes = [];
metas.forEach((m, i) => {{
  audios.push(document.getElementById('au' + i));
  lanes.push(document.getElementById('cur' + i));
}});
let active = 0;
function show() {{
  document.getElementById('which').textContent =
    metas.length > 1 ? ' — playing: ' + metas[active].name : '';
}}
function toggle() {{
  const t = audios[active].currentTime, playing = !audios[active].paused;
  audios[active].pause();
  active = (active + 1) % audios.length;
  audios[active].currentTime = t;
  if (playing) audios[active].play();
  show();
}}
function tick() {{
  audios.forEach((a, i) => {{
    const m = metas[i];
    const img = document.getElementById('im' + i);
    lanes[i].style.left = (a.currentTime / m.duration * img.clientWidth) + 'px';
  }});
  requestAnimationFrame(tick);
}}
metas.forEach((m, i) => {{
  const img = document.getElementById('im' + i);
  img.addEventListener('click', ev => {{
    const frac = (ev.clientX - img.getBoundingClientRect().left) / img.clientWidth;
    audios[i].currentTime = frac * m.duration;
  }});
}});
show(); tick();
</script></body></html>
"""


def _wav16_b64(signal, sr):
    """Base64 of a 16-bit PCM WAV (the audition transport format)."""
    x = np.asarray(signal)
    if x.ndim == 1:
        x = x[:, None]
    pcm = np.clip(x, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    data = pcm.tobytes()
    ch = x.shape[1]
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
           + struct.pack("<IHHIIHH", 16, 1, ch, sr, sr * ch * 2, ch * 2, 16)
           + b"data" + struct.pack("<I", len(data)))
    return base64.b64encode(hdr + data).decode("ascii")


def _strip_png(signal, sr, n_fft=1024, hop=512, height=160, vmin=-90, vmax=0):
    """Small mel-ish spectrogram strip for the audition lane."""
    from ..ops import fourier
    from .viz_html import _png_b64

    x = np.asarray(signal)
    if x.ndim == 2:
        x = x[:, 0]
    # magnitude on device: complex downloads are unsupported on some backends
    mag = np.asarray(fourier.get_mag(x.astype(np.float32), n_fft, hop))
    db = 20.0 * np.log10(mag + 1e-7)
    norm = np.clip((db - vmin) / (vmax - vmin), 0.0, 1.0)
    n_bins = norm.shape[0]
    freqs = np.arange(n_bins) / n_fft * sr
    mel_grid = np.linspace(float(units.to_mel(sr / 2)),
                           float(units.to_mel(30.0)), height)
    rows = np.clip(np.searchsorted(freqs, np.asarray(units.to_Hz(mel_grid))),
                   0, n_bins - 1)
    img = norm[rows]
    rgb = np.stack([img, img * 0.8 + 0.1 * (1 - img), img * 0.5], -1)
    return _png_b64((rgb * 255).astype(np.uint8))


def save_audition_html(path, takes, sr, title="audition", max_seconds=60.0):
    """Write a self-contained playback page.

    ``takes``: list of (name, signal) pairs — one lane each, A/B-switchable
    with position carry-over (the renoiser/respeeder listening workflow).
    Signals longer than ``max_seconds`` are truncated (the page embeds raw
    16-bit audio).  Returns ``path``.
    """
    lanes = []
    metas = []
    for i, (name, signal) in enumerate(takes):
        x = np.asarray(signal)
        n_max = int(max_seconds * sr)
        if len(x) > n_max:
            x = x[:n_max]
        dur = len(x) / sr
        metas.append({"name": str(name), "duration": dur})
        lanes.append(
            f'<div class="lane"><img id="im{i}" '
            f'src="data:image/png;base64,{_strip_png(x, sr)}">'
            f'<div class="cursor" id="cur{i}"></div>'
            f'<span class="name">{_html.escape(str(name))}</span></div>\n'
            f'<audio id="au{i}" controls '
            f'src="data:audio/wav;base64,{_wav16_b64(x, sr)}"></audio>')
    page = _PAGE.format(title=_html.escape(str(title)),
                        metas=json.dumps(metas),
                        lanes="\n".join(lanes),
                        tg_hidden="" if len(takes) > 1 else "hidden")
    with io.open(path, "w", encoding="utf-8") as f:
        f.write(page)
    return path
