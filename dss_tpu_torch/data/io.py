"""PLY point-cloud / mesh I/O, numpy only (a copy of dss_tpu/data/io.py:
the port imports nothing of the JAX package).

Reads binary little/big endian and ascii PLY with float xyz, optional
normals, optional uchar colours and optional faces; writes the same with
normals and colours.
"""
from __future__ import annotations

import io
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


@dataclass
class PlyData:
    points: np.ndarray  # (P, 3) float32
    normals: Optional[np.ndarray] = None  # (P, 3) float32
    colors: Optional[np.ndarray] = None  # (P, 3) float32 in [0, 1]
    faces: Optional[np.ndarray] = None  # (F, 3) int32


def read_ply(path: str) -> PlyData:
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"not a ply file: {path}")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = "ascii"
    elements: List[Tuple[str, int, list]] = []  # (name, count, [(prop, type) or ('list', idx_t, cnt_t, name)])
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append(("list", tok[2], tok[3], tok[4]))
            else:
                # "property <type> <name>" → store (name, type)
                elements[-1][2].append((tok[2], tok[1]))

    endian = "<" if "little" in fmt else ">"
    result: Dict[str, dict] = {}
    offset = 0
    ascii_lines = body.decode("ascii", errors="replace").splitlines() if fmt == "ascii" else None
    ascii_i = 0

    for name, count, props in elements:
        has_list = any(p[0] == "list" for p in props)
        if fmt == "ascii":
            rows = []
            for _ in range(count):
                rows.append(ascii_lines[ascii_i].split())
                ascii_i += 1
            if not has_list:
                arr = np.array(rows, dtype=np.float64)
                result[name] = {p[0]: arr[:, i] for i, p in enumerate(props)}
            else:
                lists = []
                for r in rows:
                    n = int(r[0])
                    lists.append([float(v) for v in r[1 : 1 + n]])
                result[name] = {"__list__": lists}
        elif not has_list:
            dt = np.dtype([(p[0] if p[0] != "list" else f"l{i}", endian + _PLY_TYPES[p[1]]) for i, p in enumerate(props)])
            arr = np.frombuffer(body, dtype=dt, count=count, offset=offset)
            offset += dt.itemsize * count
            result[name] = {p[0]: arr[p[0]] for p in props}
        else:
            # Mixed/list element: parse row by row (faces etc.).
            lists = []
            pos = offset
            for _ in range(count):
                for p in props:
                    if p[0] == "list":
                        cnt_t = _PLY_TYPES[p[1]]
                        item_t = _PLY_TYPES[p[2]]
                        n = int(np.frombuffer(body, endian + cnt_t, 1, pos)[0])
                        pos += np.dtype(cnt_t).itemsize
                        vals = np.frombuffer(body, endian + item_t, n, pos)
                        pos += np.dtype(item_t).itemsize * n
                        if p[3] in ("vertex_indices", "vertex_index"):
                            lists.append(vals)
                    else:
                        pos += np.dtype(_PLY_TYPES[p[1]]).itemsize
            offset = pos
            result[name] = {"__list__": lists}

    v = result.get("vertex", {})
    pts = np.stack([np.asarray(v[c], np.float32) for c in ("x", "y", "z")], axis=-1)
    normals = None
    if "nx" in v:
        normals = np.stack([np.asarray(v[c], np.float32) for c in ("nx", "ny", "nz")], axis=-1)
    colors = None
    if "red" in v:
        colors = np.stack([np.asarray(v[c], np.float32) for c in ("red", "green", "blue")], axis=-1) / 255.0
    faces = None
    if "face" in result and result["face"].get("__list__"):
        fl = [f for f in result["face"]["__list__"] if len(f) >= 3]
        tris = []
        for f in fl:  # fan-triangulate polygons
            for i in range(1, len(f) - 1):
                tris.append([f[0], f[i], f[i + 1]])
        if tris:
            faces = np.array(tris, np.int32)
    return PlyData(points=pts, normals=normals, colors=colors, faces=faces)


def save_ply(
    path: str,
    points: np.ndarray,
    normals: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
    faces: Optional[np.ndarray] = None,
    binary: bool = True,
) -> None:
    points = np.asarray(points, np.float32)
    p = points.shape[0]
    props = ["property float x", "property float y", "property float z"]
    cols = [points]
    if normals is not None:
        props += ["property float nx", "property float ny", "property float nz"]
        cols.append(np.asarray(normals, np.float32))
    header = ["ply", f"format {'binary_little_endian' if binary else 'ascii'} 1.0",
              "comment dss_tpu generated", f"element vertex {p}"] + props
    color_u8 = None
    if colors is not None:
        color_u8 = np.clip(np.asarray(colors) * 255.0, 0, 255).astype(np.uint8)
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    if faces is not None:
        header += [f"element face {len(faces)}", "property list uchar int vertex_indices"]
    header += ["end_header"]

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            fl = np.concatenate(cols, axis=-1)
            if color_u8 is None:
                f.write(fl.astype("<f4").tobytes())
            else:
                dt = np.dtype([("f", "<f4", fl.shape[1]), ("c", "u1", 3)])
                rec = np.empty(p, dt)
                rec["f"] = fl
                rec["c"] = color_u8
                f.write(rec.tobytes())
            if faces is not None:
                fa = np.asarray(faces, np.int32)
                dt = np.dtype([("n", "u1"), ("v", "<i4", 3)])
                rec = np.empty(len(fa), dt)
                rec["n"] = 3
                rec["v"] = fa
                f.write(rec.tobytes())
        else:
            fl = np.concatenate(cols, axis=-1)
            for i in range(p):
                row = " ".join(f"{x:.7g}" for x in fl[i])
                if color_u8 is not None:
                    row += " " + " ".join(str(int(c)) for c in color_u8[i])
                f.write((row + "\n").encode("ascii"))
            if faces is not None:
                for tri in np.asarray(faces, np.int64):
                    f.write((f"3 {tri[0]} {tri[1]} {tri[2]}\n").encode("ascii"))
