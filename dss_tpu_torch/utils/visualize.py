"""The training run's point-cloud animation and render grids
(counterpart of dss_tpu/utils/visualize.py: the HTML half of
`animate_points`, and `save_image_grid`).

`animate_points` writes a self-contained HTML viewer of a sequence of point
clouds: inline JavaScript on a canvas, drag to rotate, wheel to zoom, a
slider to step through the frames.  The GIF half of the JAX package's
function needs matplotlib and imageio and is not ported.  `save_image_grid`
tiles a view batch into one PNG through `data/png.py`: the images only,
without matplotlib's figure, axes and margins.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from dss_tpu_torch.data.png import write_png

_HTML_PLAYER = """<!DOCTYPE html><html><head><meta charset="utf-8">
<style>body{font-family:sans-serif;margin:10px;background:#111;color:#eee}
canvas{background:#181818;border:1px solid #333;touch-action:none}
#bar{margin:8px 0}input[type=range]{width:420px;vertical-align:middle}
</style></head><body>
<div id="title">__TITLE__</div>
<canvas id="c" width="720" height="640"></canvas>
<div id="bar"><input id="s" type="range" min="0" max="__MAXF__" value="0" step="1">
<span id="lab"></span></div>
<script>
const FRAMES = __DATA__;          // [{name, pts: [x,y,z,...] flat}]
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
const sl = document.getElementById('s'), lab = document.getElementById('lab');
let rx = -0.5, ry = 0.6, scale = 0.42*Math.min(cv.width, cv.height), fi = 0;
function draw(){
  const f = FRAMES[fi]; lab.textContent = f.name;
  ctx.clearRect(0,0,cv.width,cv.height);
  const cx=Math.cos(rx),sx=Math.sin(rx),cy=Math.cos(ry),sy=Math.sin(ry);
  const p = f.pts, n = p.length/3, ox = cv.width/2, oy = cv.height/2;
  // depth-sorted splats, shaded by depth
  const order = new Array(n); const zz = new Float32Array(n);
  const xx = new Float32Array(n), yy = new Float32Array(n);
  for(let i=0;i<n;i++){
    let X=p[3*i],Y=p[3*i+1],Z=p[3*i+2];
    let x1 =  cy*X + sy*Z, z1 = -sy*X + cy*Z;          // yaw
    let y2 =  cx*Y - sx*z1, z2 = sx*Y + cx*z1;          // pitch
    xx[i]=x1; yy[i]=y2; zz[i]=z2; order[i]=i;
  }
  order.sort((a,b)=>zz[a]-zz[b]);
  for(const i of order){
    const t = Math.max(0, Math.min(1, 0.5 + zz[i]));
    const c = Math.round(90 + 150*t);
    ctx.fillStyle = `rgb(${c},${Math.round(0.75*c)},${Math.round(120-40*t)})`;
    ctx.fillRect(ox + scale*xx[i], oy - scale*yy[i], 2.2, 2.2);
  }
}
let drag=false, lx=0, ly=0;
cv.addEventListener('pointerdown',e=>{drag=true;lx=e.clientX;ly=e.clientY});
window.addEventListener('pointerup',()=>drag=false);
window.addEventListener('pointermove',e=>{ if(!drag)return;
  ry += (e.clientX-lx)*0.01; rx += (e.clientY-ly)*0.01; lx=e.clientX; ly=e.clientY; draw();});
cv.addEventListener('wheel',e=>{e.preventDefault(); scale*=e.deltaY<0?1.1:0.9; draw();});
sl.addEventListener('input',()=>{fi=+sl.value; draw();});
draw();
</script></body></html>
"""


def _normalize_frames(frames):
    """Center/scale all frames jointly into [-0.5, 0.5]^3 for the viewer."""
    allp = np.concatenate([np.asarray(f, np.float32) for f in frames], axis=0)
    lo, hi = allp.min(0), allp.max(0)
    center = (lo + hi) / 2.0
    scale = max(float((hi - lo).max()), 1e-9)
    return [(np.asarray(f, np.float32) - center) / scale for f in frames]


def animate_points(
    frames,
    save_html: str,
    names: Optional[Sequence[str]] = None,
    max_points: int = 4000,
    title: str = "point-cloud animation",
) -> str:
    """Step-slider animation over a sequence of point clouds.

    frames: list of (P_i, 3) arrays; names: per-frame labels; each frame
    is subsampled to max_points.  Writes the viewer to save_html and
    returns its path."""
    loaded = [np.asarray(f, np.float32) for f in frames]
    if names is None:
        names = [str(i) for i in range(len(loaded))]
    rng = np.random.default_rng(0)
    dec = []
    for f in loaded:
        if f.shape[0] > max_points:
            f = f[rng.choice(f.shape[0], max_points, replace=False)]
        dec.append(f)
    dec = _normalize_frames(dec)

    data = [
        {"name": str(n), "pts": [round(float(v), 4) for v in f.reshape(-1)]}
        for n, f in zip(names, dec)
    ]
    html = (
        _HTML_PLAYER.replace("__DATA__", json.dumps(data))
        .replace("__MAXF__", str(len(dec) - 1))
        .replace("__TITLE__", title)
    )
    os.makedirs(os.path.dirname(os.path.abspath(save_html)), exist_ok=True)
    with open(save_html, "w") as fh:
        fh.write(html)
    return save_html


def save_image_grid(images, path: str, ncols: int = 4) -> str:
    """A rendered view batch (V, H, W, C), C = 1 or ≥ 3, → one PNG grid of
    min(ncols, V) columns, row-major, values clipped to [0, 1]; the empty
    cells of the last row are white.  Returns the path."""
    images = np.asarray(images, np.float32)
    v, h, w = images.shape[:3]
    ncols = min(ncols, v)
    nrows = (v + ncols - 1) // ncols
    tiles = np.clip(images, 0.0, 1.0)
    tiles = (np.repeat(tiles, 3, axis=-1) if tiles.shape[-1] == 1
             else tiles[..., :3])
    grid = np.ones((nrows * h, ncols * w, 3), np.float32)
    for i in range(v):
        r, c = divmod(i, ncols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = tiles[i]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_png(path, np.round(grid * 255.0).astype(np.uint8))
    return path
