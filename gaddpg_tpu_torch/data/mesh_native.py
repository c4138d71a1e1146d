"""ctypes bindings for native/mesh_tools.cc, with numpy fallbacks
(counterpart of gaddpg_tpu/data/mesh_native.py).

The library is the repository's host code, `native/libmesh_tools.so`,
built from `native/mesh_tools.cc` by `make -C native` at first use. It
runs on the host, not on the card. Without it the numpy versions run:
`sphere_pack`'s is bit for bit the native one's and `voxel_occupancy`'s
counts the same ray parities, while `surface_distance_grid`'s measures
the distance to vertices and surface samples and `surface_sample` draws
from `RandomState`, so a host without the library makes other assets,
and a seed index's grasp counts do not reproduce there.
"""

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None


_BUILD_TRIED = False


def _try_build(native_dir: str) -> None:
    """Best-effort one-shot `make -C native` on fresh checkouts.

    The .so is a build product (not committed), so a clean clone would
    otherwise silently run the ~50x slower numpy fallbacks for every
    mesh import. Disable with GADDPG_NO_NATIVE_BUILD=1.
    """
    global _BUILD_TRIED
    if _BUILD_TRIED or os.environ.get("GADDPG_NO_NATIVE_BUILD") == "1":
        return
    _BUILD_TRIED = True
    src = os.path.join(native_dir, "mesh_tools.cc")
    if not os.path.exists(src):
        return
    import subprocess
    try:
        subprocess.run(["make", "-C", native_dir], timeout=120,
                       capture_output=True, check=False)
    except Exception:
        pass


# Must match mesh_tools_version() in native/mesh_tools.cc. Bumped when
# any kernel's semantics change (e.g. the sphere-pack scoring).
EXPECTED_VERSION = 3


def _load_if_current(so_path: str):
    """CDLL the library only if its embedded version symbol matches.

    mtime comparison is unreliable (a fresh git checkout stamps sources
    with checkout time, so a genuinely current prebuilt .so is judged
    stale and a failed rebuild silently drops to the ~50x slower numpy
    fallback). An outdated .so predating the
    version symbol simply lacks it and is rejected the same way."""
    try:
        lib = ctypes.CDLL(so_path)
        lib.mesh_tools_version.restype = ctypes.c_long
        if lib.mesh_tools_version() == EXPECTED_VERSION:
            return lib
    except (OSError, AttributeError):
        pass
    return None


def _find_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cands = (
        os.path.join(here, "native", "libmesh_tools.so"),
        os.path.join(os.path.dirname(__file__), "libmesh_tools.so"),
    )
    lib = next((l for c in cands if (l := _load_if_current(c))), None)
    if lib is None:
        # missing OR version-mismatched: (re)build once, then re-check
        _try_build(os.path.join(here, "native"))
        lib = next((l for c in cands if (l := _load_if_current(c))), None)
    if lib is not None:
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
        lib.voxel_occupancy.argtypes = [f32p, ctypes.c_int, f32p, f32p,
                                        ctypes.c_int, u8p]
        lib.surface_distance_grid.argtypes = [f32p, ctypes.c_int, f32p, f32p,
                                              ctypes.c_int, f32p]
        lib.sphere_pack.argtypes = [u8p, f32p, f32p, f32p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_float, f32p]
        lib.sphere_pack.restype = ctypes.c_int
        lib.surface_sample.argtypes = [f32p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_uint64, f32p]
        _LIB = lib
    return lib


def native_available() -> bool:
    return _find_lib() is not None


def _grid_centers(lo, hi, res):
    axes = [np.linspace(lo[i], hi[i], res, endpoint=False)
            + (hi[i] - lo[i]) / res / 2 for i in range(3)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)


def voxel_occupancy(tris: np.ndarray, lo, hi, res: int) -> np.ndarray:
    """(res, res, res) uint8 interior flags via z-ray parity counting."""
    tris = np.ascontiguousarray(tris, np.float32).reshape(-1, 3, 3)
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    lib = _find_lib()
    if lib is not None:
        out = np.zeros(res**3, np.uint8)
        lib.voxel_occupancy(tris.reshape(-1), len(tris), lo, hi, res, out)
        return out.reshape(res, res, res)
    # numpy fallback: vectorized Moller-Trumbore per (x, y) column
    centers = _grid_centers(lo, hi, res)
    out = np.zeros((res, res, res), np.uint8)
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    e1, e2 = v1 - v0, v2 - v0
    d = np.array([0.0, 0.0, 1.0])
    p = np.cross(d, e2)
    det = np.einsum("tj,tj->t", e1, p)
    ok0 = np.abs(det) > 1e-12
    inv = np.where(ok0, 1.0 / np.where(ok0, det, 1.0), 0.0)
    for ix in range(res):
        for iy in range(res):
            o = np.array([centers[ix, iy, 0, 0], centers[ix, iy, 0, 1], lo[2] - 1.0])
            tv = o - v0
            u = np.einsum("tj,tj->t", tv, p) * inv
            q = np.cross(tv, e1)
            vv = q[:, 2] * inv
            t = np.einsum("tj,tj->t", e2, q) * inv
            hit = ok0 & (u >= 0) & (u <= 1) & (vv >= 0) & (u + vv <= 1) & (t > 1e-12)
            ts = np.sort(t[hit])
            zs = centers[ix, iy, :, 2] - (lo[2] - 1.0)
            out[ix, iy] = (np.searchsorted(ts, zs) % 2).astype(np.uint8)
    return out


def surface_distance_grid(tris: np.ndarray, lo, hi, res: int) -> np.ndarray:
    """(res,res,res) float32 unsigned distance to the mesh surface."""
    tris = np.ascontiguousarray(tris, np.float32).reshape(-1, 3, 3)
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    lib = _find_lib()
    if lib is not None:
        out = np.zeros(res**3, np.float32)
        lib.surface_distance_grid(tris.reshape(-1), len(tris), lo, hi, res, out)
        return out.reshape(res, res, res)
    # fallback: distance to triangle VERTICES + dense surface samples
    # (approximation adequate for sphere seeding). Chunked over grid
    # centers: the full (res^3, n_pts, 3) float64 broadcast is ~1-2 GB
    # per object at res=24 with ~6k points;
    # 2048-center blocks keep the peak under ~100 MB at identical output.
    samples = surface_sample(tris, 4096, seed=0)
    pts = np.concatenate([tris.reshape(-1, 3), samples]).astype(np.float32)
    centers = _grid_centers(lo, hi, res).reshape(-1, 3).astype(np.float32)
    d = np.empty(len(centers), np.float32)
    block = 2048
    for s in range(0, len(centers), block):
        c = centers[s:s + block]
        d[s:s + block] = np.sqrt(
            ((c[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        ).min(axis=1)
    return d.reshape(res, res, res).astype(np.float32)


def sphere_pack(occ: np.ndarray, dist: np.ndarray, lo, hi,
                max_spheres: int = 32, min_radius: float = 0.004) -> np.ndarray:
    """Greedy deepest-first interior sphere packing -> (n, 4) [xyz r]."""
    res = occ.shape[0]
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    lib = _find_lib()
    if lib is not None:
        out = np.zeros(max_spheres * 4, np.float32)
        n = lib.sphere_pack(
            np.ascontiguousarray(occ.reshape(-1)),
            np.ascontiguousarray(dist.reshape(-1), np.float32),
            lo, hi, res, max_spheres, np.float32(min_radius), out,
        )
        return out.reshape(-1, 4)[:n].copy()
    return _sphere_pack_numpy(occ, dist, lo, hi, max_spheres, min_radius)


def _sphere_pack_numpy(occ, dist, lo, hi, max_spheres, min_radius):
    """numpy fallback of the same greedy loop (depth + spread score).

    Bit-exact mirror of the native kernel (mesh_tools.cc sphere_pack):
    centers/distances/carve tests in float64 over float32 inputs, mind
    stored float32 -- symmetric meshes produce exact score ties that
    must break toward the same cell on both paths, else a missing .so
    silently changes every packing. tests/test_procgen.py pins parity."""
    res = occ.shape[0]
    lo64 = np.ascontiguousarray(lo, np.float32).astype(np.float64)
    hi64 = np.ascontiguousarray(hi, np.float32).astype(np.float64)
    step = (hi64 - lo64) / res
    ax = [lo64[k] + (np.arange(res) + 0.5) * step[k] for k in range(3)]
    centers = np.stack(np.meshgrid(*ax, indexing="ij"), -1).reshape(-1, 3)
    d = dist.reshape(-1).astype(np.float32).copy()
    occf = occ.reshape(-1).astype(bool)
    mind = np.zeros_like(d)
    minr = np.float32(min_radius)
    spheres = []
    while len(spheres) < max_spheres:
        eligible = occf & (d > minr)
        if not eligible.any():
            break
        score = np.where(
            eligible, d.astype(np.float64) + 0.5 * mind.astype(np.float64),
            -1.0,
        )
        i = int(np.argmax(score))
        c, r = centers[i], d[i]  # c float64, r float32
        spheres.append([np.float32(c[0]), np.float32(c[1]),
                        np.float32(c[2]), r])
        dist_c = np.sqrt(((centers - c) ** 2).sum(-1))  # float64
        covered = (d > 0) & (dist_c + 0.6 * d.astype(np.float64)
                             < np.float64(r))
        d[covered] = 0.0
        fd = dist_c.astype(np.float32)
        mind = fd if len(spheres) == 1 else np.minimum(mind, fd)
    return np.asarray(spheres, np.float32).reshape(-1, 4)


def surface_sample(tris: np.ndarray, n_samples: int, seed: int = 0) -> np.ndarray:
    """(n_samples, 3) area-weighted surface samples."""
    tris = np.ascontiguousarray(tris, np.float32).reshape(-1, 3, 3)
    lib = _find_lib()
    if lib is not None:
        out = np.zeros(n_samples * 3, np.float32)
        lib.surface_sample(tris.reshape(-1), len(tris), n_samples,
                           np.uint64(seed), out)
        return out.reshape(-1, 3)
    rng = np.random.RandomState(seed)
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    probs = area / max(area.sum(), 1e-12)
    t = rng.choice(len(tris), size=n_samples, p=probs)
    u = rng.rand(n_samples, 1)
    w = rng.rand(n_samples, 1)
    flip = (u + w) > 1
    u = np.where(flip, 1 - u, u)
    w = np.where(flip, 1 - w, w)
    return (tris[t, 0] + u * e1[t] + w * e2[t]).astype(np.float32)
