"""ASCII PLY writers for meshes and oriented point clouds.

Matches the reference's output formats:
  * mesh PLY with uchar vertex colors + triangle faces
    (cpp/third/mesh/MarchingCubes.cpp:659-697)
  * point-cloud PLY with float normals + uchar colors
    (cpp/include/sdf_tracker/VolumetricGradSdf.cpp:350-373)
"""

from __future__ import annotations

import numpy as np


def write_mesh_ply(
    path: str,
    vertices: np.ndarray,        # [V,3] float
    faces: np.ndarray,           # [F,3] int
    colors: np.ndarray = None,   # [V,3] float in [0,1] or uint8
) -> bool:
    # float32 up front: the native writer formats float32, and identical
    # output regardless of which writer runs requires matching precision
    vertices = np.asarray(vertices, dtype=np.float32)
    faces = np.asarray(faces)
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
    # native C++ writer (same byte format); Python loop as fallback
    from psgradientsdf.native import ply_write_mesh_native

    ok = ply_write_mesh_native(path, vertices, faces, colors if has_color else None)
    if ok is not None:
        return ok
    try:
        with open(path, "w") as fh:
            fh.write("ply\nformat ascii 1.0\n")
            fh.write(f"element vertex {len(vertices)}\n")
            fh.write("property float x\nproperty float y\nproperty float z\n")
            if has_color:
                fh.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
            fh.write(f"element face {len(faces)}\n")
            fh.write("property list uchar int vertex_indices\n")
            fh.write("end_header\n")
            for i, v in enumerate(vertices):
                line = f"{v[0]:g} {v[1]:g} {v[2]:g}"
                if has_color:
                    c = colors[i]
                    line += f" {int(c[0])} {int(c[1])} {int(c[2])}"
                fh.write(line + "\n")
            for f in faces:
                fh.write(f"3 {int(f[0])} {int(f[1])} {int(f[2])}\n")
        return True
    except OSError:
        return False


def write_pointcloud_ply(
    path: str,
    points: np.ndarray,    # [N,3]
    normals: np.ndarray,   # [N,3]
    colors: np.ndarray,    # [N,3] float [0,1]
) -> bool:
    points = np.asarray(points, dtype=np.float32)
    normals = np.asarray(normals, dtype=np.float32)
    colors = np.clip(np.asarray(colors) * 255.0, 0, 255).astype(np.int32)
    from psgradientsdf.native import ply_write_pointcloud_native

    ok = ply_write_pointcloud_native(
        path, points, normals, colors.astype(np.uint8))
    if ok is not None:
        return ok
    try:
        with open(path, "w") as fh:
            fh.write("ply\nformat ascii 1.0\n")
            fh.write(f"element vertex {len(points)}\n")
            fh.write("property float x\nproperty float y\nproperty float z\n")
            fh.write("property float nx\nproperty float ny\nproperty float nz\n")
            fh.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
            fh.write("end_header\n")
            for p, n, c in zip(points, normals, colors):
                fh.write(
                    f"{p[0]:g} {p[1]:g} {p[2]:g} {n[0]:g} {n[1]:g} {n[2]:g} "
                    f"{int(c[0])} {int(c[1])} {int(c[2])}\n"
                )
        return True
    except OSError:
        return False


def read_ply_header(path: str):
    """Parse a PLY header -> (n_vertices, n_faces). Works for the ASCII
    meshes written by write_mesh_ply (MarchingCubes.cpp:659-697 format)."""
    nv = nf = 0
    with open(path, "rb") as fh:
        for raw in fh:
            line = raw.decode("latin1").strip()
            if line.startswith("element vertex"):
                nv = int(line.split()[-1])
            elif line.startswith("element face"):
                nf = int(line.split()[-1])
            elif line == "end_header":
                break
    return nv, nf
