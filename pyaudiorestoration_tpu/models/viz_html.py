"""Self-contained interactive HTML spectrogram viewer.

The reference's main interactive affordance is the vispy canvas: pan/zoom a
mel-scaled spectrogram, read time/frequency under the cursor, see marker
overlays (spectrum.py:224-605, vispy_ext.py:148-199).  On a headless accelerator
deployment there is no Qt/GL stack, so this module renders the spectrogram
once (device -> dB -> izo/magma colormap -> PNG) and embeds it in a single
HTML file with ~100 lines of dependency-free JavaScript providing:

* wheel zoom around the cursor (X-only with Shift, like PanZoomCameraExt's
  modifier zoom, vispy_ext.py:19-145), drag pan, double-click reset
* a cursor readout of time (m:s:ms) and frequency in Hz (inverting the mel
  row mapping in JS, the MelTransform imap, vispy_ext.py:185-195)
* marker polylines (e.g. traced frequency curves) drawn over the image

Open the file in any browser; nothing is fetched from the network.
"""

from __future__ import annotations

import base64
import io
import json

import numpy as np

from ..ops import units

__all__ = ["save_interactive_html", "save_interactive_compare_html"]

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title><style>
 body {{ margin:0; background:#111; color:#ddd; font:13px monospace; }}
 #bar {{ padding:6px 10px; }} #wrap {{ position:relative; }}
 canvas {{ display:block; width:100vw; height:calc(100vh - 30px); cursor:crosshair; }}
</style></head><body>
<div id="bar">{title} &nbsp; <span id="readout"></span>
 &nbsp;&nbsp;<span style="color:#888">drag: pan &middot; wheel: zoom
 (shift: X only) &middot; dblclick: reset</span></div>
<div id="wrap"><canvas id="c"></canvas></div>
<script>
const META = {meta};
const MARKERS = {markers};
const img = new Image();
img.src = "data:image/png;base64,{png}";
const cv = document.getElementById("c"), ctx = cv.getContext("2d");
const readout = document.getElementById("readout");
let sx = 1, sy = 1, tx = 0, ty = 0;   // view transform (image px -> canvas px)
function resize() {{
  cv.width = cv.clientWidth; cv.height = cv.clientHeight;
  sx = cv.width / META.w; sy = cv.height / META.h; tx = 0; ty = 0; draw();
}}
function draw() {{
  ctx.setTransform(1,0,0,1,0,0);
  ctx.fillStyle = "#111"; ctx.fillRect(0,0,cv.width,cv.height);
  ctx.setTransform(sx,0,0,sy,tx,ty);
  ctx.imageSmoothingEnabled = false;
  ctx.drawImage(img, 0, 0);
  ctx.lineWidth = 1.5 / Math.max(sx, sy);
  for (const m of MARKERS) {{
    ctx.strokeStyle = m.color; ctx.beginPath();
    for (let i = 0; i < m.t.length; i++) {{
      const x = m.t[i] / META.duration * META.w;
      const y = hz2row(m.f[i]);
      if (i) ctx.lineTo(x, y); else ctx.moveTo(x, y);
    }}
    ctx.stroke();
  }}
}}
// mel mapping (vispy_ext.py:185-195): row 0 = top = mel(f_max)
function mel(f) {{ return 1127.01048 * Math.log(1 + f / 700.0); }}
function imel(m) {{ return 700.0 * (Math.exp(m / 1127.01048) - 1); }}
function row2hz(r) {{
  const frac = 1 - r / META.h;
  return imel(mel(META.fmin) + frac * (mel(META.fmax) - mel(META.fmin)));
}}
function hz2row(f) {{
  const frac = (mel(f) - mel(META.fmin)) / (mel(META.fmax) - mel(META.fmin));
  return (1 - frac) * META.h;
}}
cv.addEventListener("mousemove", ev => {{
  const r = cv.getBoundingClientRect();
  const ix = (ev.clientX - r.left - tx) / sx, iy = (ev.clientY - r.top - ty) / sy;
  const t = ix / META.w * META.duration, f = row2hz(iy);
  if (t >= 0 && t <= META.duration && f >= 0)
    readout.textContent = (t/60|0) + ":" + String((t%60).toFixed(3)).padStart(6,"0")
      + "  " + f.toFixed(1) + " Hz";
  if (dragging) {{ tx += ev.movementX; ty += ev.movementY; draw(); }}
}});
let dragging = false;
cv.addEventListener("mousedown", () => dragging = true);
window.addEventListener("mouseup", () => dragging = false);
cv.addEventListener("wheel", ev => {{
  ev.preventDefault();
  const r = cv.getBoundingClientRect();
  const px = ev.clientX - r.left, py = ev.clientY - r.top;
  const k = Math.exp(-ev.deltaY * 0.0015);
  sx *= k; tx = px - (px - tx) * k;
  if (!ev.shiftKey) {{ sy *= k; ty = py - (py - ty) * k; }}
  draw();
}}, {{ passive: false }});
cv.addEventListener("dblclick", resize);
img.onload = resize;
window.addEventListener("resize", resize);
</script></body></html>
"""


def _png_b64(rgb_u8):
    """Encode an (H, W, 3) uint8 image as base64 PNG (pure stdlib: zlib
    deflate of filtered scanlines — no imaging dependency)."""
    import struct
    import zlib

    h, w, _ = rgb_u8.shape
    raw = b"".join(b"\x00" + rgb_u8[r].tobytes() for r in range(h))

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    return base64.b64encode(png).decode("ascii")


def save_interactive_html(path, mag, sr, hop, markers=(), title="spectrogram",
                          vmin=-120, vmax=0, cmap="izo", fmin=20.0,
                          max_rows=1024):
    """Write a dependency-free interactive viewer for a magnitude
    spectrogram.  ``markers``: iterable of dicts {"t": [...], "f": [...],
    "color": "#f00"} (e.g. a traced frequency curve).  Returns ``path``."""
    from .viz import get_cmap

    mag = np.asarray(mag)
    n_bins, n_frames = mag.shape
    db = 20.0 * np.log10(mag + 1e-7)
    norm = np.clip((db - vmin) / (vmax - vmin), 0.0, 1.0)

    # resample rows onto a mel grid (top row = f_max), like the GL transform
    n_fft = 2 * (n_bins - 1)
    freqs = np.arange(n_bins) / n_fft * sr
    h = min(max_rows, n_bins)
    mel_grid = np.linspace(float(units.to_mel(sr / 2)),
                           float(units.to_mel(fmin)), h)
    hz_grid = np.asarray(units.to_Hz(mel_grid))
    rows = np.clip(np.searchsorted(freqs, hz_grid), 0, n_bins - 1)
    img = norm[rows]

    import matplotlib

    cm = matplotlib.colormaps.get_cmap(get_cmap(cmap)) if isinstance(
        get_cmap(cmap), str) else get_cmap(cmap)
    rgb = (cm(img)[..., :3] * 255).astype(np.uint8)

    meta = {"w": n_frames, "h": h, "duration": n_frames * hop / sr,
            "fmin": fmin, "fmax": sr / 2}
    mk = [{"t": list(map(float, m["t"])), "f": list(map(float, m["f"])),
           "color": m.get("color", "#ff5050")} for m in markers]
    import html as _html

    html = _PAGE.format(title=_html.escape(str(title)), meta=json.dumps(meta),
                        markers=json.dumps(mk), png=_png_b64(rgb))
    with io.open(path, "w", encoding="utf-8") as f:
        f.write(html)
    return path


def save_interactive_compare_html(path, mag_a, mag_b, sr, hop, offset_b=0.0,
                                  title="compare", vmin=-120, vmax=0,
                                  fmin=20.0, max_rows=1024):
    """Interactive red/green 2-source overlay (the tapesynch alignment
    check, spectrum.py:15-31): source A -> red, source B (shifted by
    ``offset_b`` seconds) -> green; aligned content fuses to yellow.  Same
    pan/zoom/readout page as ``save_interactive_html``."""
    mag_a = np.asarray(mag_a)
    mag_b = np.asarray(mag_b)
    if mag_a.shape[0] != mag_b.shape[0]:
        raise ValueError("both spectrograms must share fft settings")

    def norm(m):
        return np.clip((20.0 * np.log10(m + 1e-7) - vmin) / (vmax - vmin),
                       0.0, 1.0)

    a, b = norm(mag_a), norm(mag_b)
    off = int(round(offset_b * sr / hop))
    n_frames = max(a.shape[1], b.shape[1] + max(0, off)) - min(0, off)
    n_bins = a.shape[0]
    rgbf = np.zeros((n_bins, n_frames, 3), np.float32)
    a0 = max(0, -off)
    rgbf[:, a0:a0 + a.shape[1], 0] = a
    b0 = max(0, off)
    rgbf[:, b0:b0 + b.shape[1], 1] = b

    # mel row remap (top = f_max), same as the mono viewer
    n_fft = 2 * (n_bins - 1)
    freqs = np.arange(n_bins) / n_fft * sr
    h = min(max_rows, n_bins)
    mel_grid = np.linspace(float(units.to_mel(sr / 2)),
                           float(units.to_mel(fmin)), h)
    rows = np.clip(np.searchsorted(freqs, np.asarray(units.to_Hz(mel_grid))),
                   0, n_bins - 1)
    rgb = (rgbf[rows] * 255).astype(np.uint8)

    meta = {"w": n_frames, "h": h, "duration": n_frames * hop / sr,
            "fmin": fmin, "fmax": sr / 2}
    import html as _html

    html = _PAGE.format(title=_html.escape(str(title)), meta=json.dumps(meta),
                        markers="[]", png=_png_b64(rgb))
    with io.open(path, "w", encoding="utf-8") as f:
        f.write(html)
    return path
