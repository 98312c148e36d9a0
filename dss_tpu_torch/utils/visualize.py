"""Debug plots, the point-cloud animation and render grids (counterpart
of dss_tpu/utils/visualize.py).

The JAX package draws its plots with matplotlib; here every plot is drawn
in numpy into a uint8 canvas and written through `data/png.py`: the
content only, without axes, legends, titles or margins.

- `plot_2d_quiver`: negative-gradient arrows at the projected points over
  the GT mask, one colour per gradient source, in the image's pixels;
- `plot_3d_quiver`: the world-space gradients in one fixed orthographic
  view (matplotlib's default 3D view: elevation 30°, azimuth −60°, z up);
- `plot_iso_surface`: an SDF's level set meshed by marching tetrahedra,
  rasterized by `render/mesh_raster.py` and shaded by |n · view|;
- `plot_cuts`: three axis-aligned SDF slices (red inside, blue outside),
  the zero set in black;
- `animate_points` / `animate_mesh`: a self-contained HTML viewer (inline
  JavaScript on a canvas: drag to rotate, wheel to zoom, a slider to step
  through the frames).  The GIF half needs matplotlib and imageio and is
  not ported;
- `save_image_grid` tiles a view batch into one PNG; `figures_to_html`
  embeds images (arrays or PNG paths, in place of matplotlib figures) in
  one HTML page.
"""
from __future__ import annotations

import base64
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from dss_tpu_torch.data.png import encode_png, write_png

# matplotlib's tab10 colours, in the JAX package's order per plot
_TAB = {"red": (214, 39, 40), "blue": (31, 119, 180), "green": (44, 160, 44),
        "orange": (255, 127, 14), "purple": (148, 103, 189)}
_COLORS_2D = ("red", "blue", "green", "orange", "purple")
_COLORS_3D = ("red", "blue", "green", "orange")
# side of the 3D views' square canvases, in pixels
_CANVAS = 512

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


def ndc_to_pixel_np(xy: np.ndarray, image_size: int) -> np.ndarray:
    """NDC xy → pixel (col, row) under the flipped +X-left/+Y-up convention."""
    s = image_size
    col = (s * (1.0 - xy[..., 0]) - 1.0) * 0.5
    row = (s * (1.0 - xy[..., 1]) - 1.0) * 0.5
    return np.stack([col, row], axis=-1)


def _save(path: str, canvas: np.ndarray) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_png(path, canvas)
    return path


def _draw_segments(canvas: np.ndarray, start: np.ndarray, end: np.ndarray,
                   color) -> None:
    """Draw (N, 2) → (N, 2) segments of (col, row) pixel coordinates, one
    pixel wide, clipped to the canvas; a segment of length 0 is its start
    pixel."""
    if len(start) == 0:
        return
    h, w = canvas.shape[:2]
    n = int(min(np.ceil(np.abs(end - start).max()), 4 * max(h, w))) + 1
    t = np.linspace(0.0, 1.0, n)[None, :, None]
    xy = np.rint(start[:, None] + t * (end - start)[:, None]).reshape(-1, 2)
    ok = np.isfinite(xy).all(-1)
    xy = xy[ok].astype(np.int64)
    ok = (xy[:, 0] >= 0) & (xy[:, 0] < w) & (xy[:, 1] >= 0) & (xy[:, 1] < h)
    canvas[xy[ok, 1], xy[ok, 0]] = color


def _draw_arrows(canvas: np.ndarray, tail: np.ndarray, vec: np.ndarray,
                 color) -> None:
    """Arrows from (N, 2) tails along (N, 2) vectors (pixels), with a head
    of two strokes at ±25° whose length is 30% of the arrow's, at most
    6 pixels."""
    tip = tail + vec
    length = np.linalg.norm(vec, axis=-1, keepdims=True)
    back = -vec / np.maximum(length, 1e-12) * np.minimum(0.3 * length, 6.0)
    for ang in (np.deg2rad(25.0), -np.deg2rad(25.0)):
        c, s = np.cos(ang), np.sin(ang)
        rot = np.stack([c * back[:, 0] - s * back[:, 1],
                        s * back[:, 0] + c * back[:, 1]], axis=-1)
        _draw_segments(canvas, tip, tip + rot, color)
    _draw_segments(canvas, tail, tip, color)


def _draw_dots(canvas: np.ndarray, xy: np.ndarray, color) -> None:
    _draw_segments(canvas, xy, xy, color)


def plot_2d_quiver(
    pts_ndc: np.ndarray,
    grads_ndc: Dict[str, np.ndarray],
    mask_img: Optional[np.ndarray],
    path: str,
    image_size: int = 256,
    n_arrows: int = 400,
) -> str:
    """Negative-gradient arrows at the projected points (every
    len/n_arrows-th point) over the GT mask, on an image_size² canvas in
    the image's pixels: white, the mask in gray at 60% (nearest-resized to
    the canvas), the points as black dots, then one colour per source
    (red, blue, green, orange, purple in `grads_ndc`'s order).  Returns
    the path."""
    s = image_size
    canvas = np.full((s, s, 3), 255, np.uint8)
    if mask_img is not None:
        m = np.asarray(mask_img, np.float32)
        m = m[(np.arange(s) * m.shape[0]) // s][:, (np.arange(s) * m.shape[1]) // s]
        gray = np.rint(255.0 * 0.4 + 255.0 * 0.6 * np.clip(m, 0.0, 1.0))
        canvas[:] = gray.astype(np.uint8)[..., None]
    xy = np.asarray(pts_ndc)[:, :2]
    pix = ndc_to_pixel_np(xy, s)
    step = max(1, len(pix) // n_arrows)
    _draw_dots(canvas, pix[::step], (0, 0, 0))
    for i, g in enumerate(grads_ndc.values()):
        gp = ndc_to_pixel_np(-np.asarray(g)[:, :2] + xy, s) - pix
        _draw_arrows(canvas, pix[::step], gp[::step],
                     _TAB[_COLORS_2D[i % len(_COLORS_2D)]])
    return _save(path, canvas)


def _view_rotation(elev: float = 30.0, azim: float = -60.0) -> np.ndarray:
    """(3, 3) world → (right, up, toward the viewer) for matplotlib's 3D
    view convention: z up, the eye at elevation `elev`, azimuth `azim`."""
    e, a = np.deg2rad(elev), np.deg2rad(azim)
    eye = np.array([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)])
    right = np.array([-np.sin(a), np.cos(a), 0.0])
    up = np.cross(eye, right)
    return np.stack([right, up, eye])


def plot_3d_quiver(
    pts_world: np.ndarray,
    grads_world: Dict[str, np.ndarray],
    path: str,
    n_arrows: int = 300,
) -> str:
    """World-space negative gradients (each source scaled so its longest
    arrow is 0.2 world units) at every len/n_arrows-th point, in one fixed
    orthographic view fitted to the points, on a white square canvas:
    black dots, then red, blue, green, orange per source.  Returns the
    path."""
    p = np.asarray(pts_world, np.float64)
    step = max(1, len(p) // n_arrows)
    rot = _view_rotation()[:2]
    uv = p @ rot.T
    center = (uv.max(0) + uv.min(0)) / 2.0 if len(uv) else np.zeros(2)
    extent = max(float(np.abs(uv - center).max()) if len(uv) else 0.0,
                 1e-9) + 0.2
    scale = 0.45 * _CANVAS / extent

    def to_pix(q):
        d = (q @ rot.T - center) * scale
        return np.stack([_CANVAS / 2.0 + d[:, 0], _CANVAS / 2.0 - d[:, 1]],
                        axis=-1)

    canvas = np.full((_CANVAS, _CANVAS, 3), 255, np.uint8)
    tail = to_pix(p[::step])
    _draw_dots(canvas, tail, (0, 0, 0))
    for i, g in enumerate(grads_world.values()):
        g = -np.asarray(g, np.float64)
        g = g * (0.2 / max(np.abs(g).max(), 1e-12))
        _draw_arrows(canvas, tail, to_pix(p[::step] + g[::step]) - tail,
                     _TAB[_COLORS_3D[i % len(_COLORS_3D)]])
    return _save(path, canvas)


def _sdf_on_grid(sdf_fn, pts: np.ndarray, device) -> np.ndarray:
    with torch.no_grad():
        f = sdf_fn(torch.as_tensor(pts, dtype=torch.float32, device=device))
    return f.detach().cpu().numpy()


def plot_iso_surface(sdf_fn, path: str, bound: float = 1.2,
                     resolution: int = 48, level: float = 0.0,
                     device=None) -> str:
    """Mesh the level set of `sdf_fn` ((N, 3) tensor → (N,)) on a
    resolution³ grid over [−bound, bound]³ by marching tetrahedra and
    render it from elevation 30°, azimuth −60° (z up), each face gray by
    |n · view|, on a white square canvas.  The grid goes to `device` (the
    card unless it says otherwise).  Returns the path."""
    from dss_tpu_torch.geometry.cameras import (
        FoVPerspectiveCameras,
        look_at_rotation,
    )
    from dss_tpu_torch.geometry.meshing import marching_tetrahedra
    from dss_tpu_torch.render.mesh_raster import rasterize_mesh
    from dss_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    lin = np.linspace(-bound, bound, resolution)
    grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    sdf = _sdf_on_grid(sdf_fn, grid, dev).reshape((resolution,) * 3)
    verts, faces = marching_tetrahedra(sdf, np.full(3, -bound),
                                       np.full(3, bound), level)
    canvas = np.full((_CANVAS, _CANVAS, 3), 255, np.uint8)
    if len(faces):
        # z up in the plot: the camera's up axis is world z
        eye = _view_rotation()[2] * bound * 4.0
        pos = torch.tensor(eye[None], dtype=torch.float32)
        r = look_at_rotation(pos, up=torch.tensor([0.0, 0.0, 1.0]))
        cam = FoVPerspectiveCameras.create(r, -torch.einsum("ni,nij->nj", pos, r),
                                           fov=40.0, device=dev)
        v = torch.as_tensor(verts, device=dev)
        f = torch.as_tensor(faces, device=dev)
        fid = rasterize_mesh(v, f, cam, _CANVAS)[0].cpu().numpy()
        tri = verts[faces].astype(np.float64)
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        view = eye[None] - tri.mean(axis=1)
        view /= np.linalg.norm(view, axis=-1, keepdims=True)
        shade = np.rint(40.0 + 190.0 * np.abs(np.sum(n * view, -1)))
        hit = fid >= 0
        canvas[hit] = shade[fid[hit]].astype(np.uint8)[:, None]
    return _save(path, canvas)


def plot_cuts(sdf_fn, path: str, bound: float = 1.2, resolution: int = 96,
              device=None) -> str:
    """The SDF on the planes x = 0, y = 0 and z = 0 over [−bound, bound]²,
    side by side with 4 white pixels between: red where negative, blue
    where positive, white at 0 (each slice scaled by its largest |value|),
    and black pixels where the sign changes to a 4-neighbour (the zero
    set).  In each slice the first remaining axis runs right and the
    second up.  Returns the path."""
    from dss_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    r, gap = resolution, 4
    lin = np.linspace(-bound, bound, r)
    canvas = np.full((r, 3 * r + 2 * gap, 3), 255, np.uint8)
    for axis in range(3):
        a, b = np.meshgrid(lin, lin, indexing="ij")
        pts = np.zeros((r * r, 3), np.float32)
        other = [i for i in range(3) if i != axis]
        pts[:, other[0]] = a.reshape(-1)
        pts[:, other[1]] = b.reshape(-1)
        f = _sdf_on_grid(sdf_fn, pts, dev).reshape(r, r)
        img = f.T[::-1]  # rows: the second axis, increasing upward
        x = np.clip(img / max(float(np.abs(img).max()), 1e-12), -1.0, 1.0)
        neg, pos = np.clip(-x, 0, 1)[..., None], np.clip(x, 0, 1)[..., None]
        rgb = (255.0 * (1 - neg - pos) + np.asarray(_TAB["red"]) * neg
               + np.asarray(_TAB["blue"]) * pos)
        inside = img < 0
        zero = np.zeros_like(inside)
        zero[1:] |= inside[1:] != inside[:-1]
        zero[:, 1:] |= inside[:, 1:] != inside[:, :-1]
        rgb[zero] = 0.0
        c0 = axis * (r + gap)
        canvas[:, c0:c0 + r] = np.rint(rgb).astype(np.uint8)
    return _save(path, canvas)


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


def animate_mesh(verts_frames, faces, save_html: str,
                 names: Optional[Sequence[str]] = None) -> str:
    """Mesh-sequence animation through `animate_points`' viewer: each
    frame's vertices plus its face centroids, so the surface reads as
    filled.  Returns the HTML path."""
    faces = np.asarray(faces)
    frames = []
    for v in verts_frames:
        v = np.asarray(v, np.float32)
        frames.append(np.concatenate([v, v[faces].mean(axis=1)], axis=0))
    return animate_points(frames, save_html, names=names,
                          title="mesh animation")


def figures_to_html(images, filename: str) -> str:
    """One HTML page of base64 PNG <img> blocks, one per image: a PNG path,
    or an (H, W[, C]) array, uint8 or float in [0, 1] (clipped).  Returns
    the path."""
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with open(filename, "w") as dash:
        dash.write("<html><head></head><body>\n")
        for im in images:
            if isinstance(im, (str, bytes, os.PathLike)):
                with open(im, "rb") as f:
                    data = f.read()
            else:
                a = np.asarray(im)
                if a.dtype != np.uint8:
                    a = np.rint(np.clip(a, 0.0, 1.0) * 255.0).astype(np.uint8)
                data = encode_png(a)
            b64 = base64.b64encode(data).decode("ascii")
            dash.write(f'<img src="data:image/png;base64,{b64}"/>\n')
        dash.write("</body></html>\n")
    return filename


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
