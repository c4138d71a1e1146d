"""Object library: sphere sets, surface points, grasp databases
(counterpart of gaddpg_tpu/envs/assets.py).

The reference's YCB / ShapeNet meshes and ACRONYM grasps are not
vendored, so objects are parameterised proxies with the published names
and dimensions: boxes, solid cylinders and hollow cylinders. Contact
geometry is a padded sphere set, render geometry surface samples, and
the grasp database antipodal hand poses in the object frame
(reference: env/panda_scene.py:523-573, 1252-1255). Mesh indexes,
procedural libraries and seed indexes go through the mesh pipeline of
`data/` (`library_from_index`). The builders are
seeded numpy (`RandomState(0)` / `(1)`), the JAX package's code, so both
packages build the same library; `ObjectLibrary` holds float32 tensors
as the JAX package holds float32 arrays.

Grasp frame convention: hand +z approaches the object, fingers close
along hand +-y, the closing point sits `GRASP_DEPTH` ahead of the hand
origin along +z.
"""

import dataclasses
import json
import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

GRASP_DEPTH = 0.10          # hand origin -> closing point along +z
GRIPPER_MAX_WIDTH = 0.078   # usable opening (0.08 minus margin)

NS = 32    # spheres per object (padded; contact cost is linear in NS)
NP = 1024  # surface points per object (padded; point-splat render density)
NG = 64    # grasps per object (padded)
NC = 12    # coarse spheres per object (object<->object contact proxies)


def coarse_sphere_subset(sph: np.ndarray, target: int = NC) -> np.ndarray:
    """Greedy farthest-point subset of a sphere set (host-side).

    Object-object contact (physics/multi.py) runs on NC x NC sphere
    pairs per body pair; a dozen well-spread spheres capture the shape
    at ~7x less contact work than the full NS set. Starts from the
    largest sphere, then maximizes center spread. Padding rows are
    radius 0 parked at z=1e3, like the NS padding.
    """
    sph = np.asarray(sph, dtype=np.float64)
    live = sph[sph[:, 3] > 0]
    out = np.zeros((target, 4))
    out[:, 2] = 1e3
    if len(live) == 0:
        return out
    chosen = [int(np.argmax(live[:, 3]))]
    d = np.linalg.norm(live[:, :3] - live[chosen[0], :3], axis=1)
    while len(chosen) < min(target, len(live)):
        i = int(np.argmax(d))
        if d[i] <= 0 and len(chosen) >= 1:
            break
        chosen.append(i)
        d = np.minimum(d, np.linalg.norm(live[:, :3] - live[i, :3], axis=1))
    out[: len(chosen)] = live[chosen]
    return out


@dataclasses.dataclass
class AssetSpec:
    name: str
    kind: str                  # 'box' | 'cylinder' | 'hollow'
    dims: Tuple[float, ...]    # box: full extents; cyl: (r, h); hollow: (r, h, wall)
    mass: float


def _box_spheres(half, target=NS):
    """Grid-fill a box with spheres flush to the faces.

    Center spacing <= sphere radius wherever the budget allows, so flat
    faces stay flat to the finger pads (edge-only contacts make grasps
    torquey and unstable).
    """
    half = np.asarray(half)
    r = float(min(half.min(), 0.015))
    # spacing (2h-2r)/(c-1) <= r  =>  c >= 2h/r - 1
    counts = np.maximum(1, np.minimum(5, np.ceil(2 * half / r - 1 + 1e-6).astype(int)))
    while np.prod(counts) > target:
        counts[np.argmax(counts)] -= 1
    axes = [
        np.linspace(-h + r, h - r, c) if c > 1 else np.array([0.0])
        for h, c in zip(half, counts)
    ]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    return np.concatenate([grid, np.full((len(grid), 1), r)], axis=-1)


def _cyl_spheres(r, h, target=NS):
    rs = float(min(r, h / 2, 0.02))
    n_z = max(1, min(6, int(round(h / (2 * rs)))))
    zs = np.linspace(-h / 2 + rs, h / 2 - rs, n_z) if n_z > 1 else np.array([0.0])
    rows = []
    for z in zs:
        rows.append([0.0, 0.0, z, rs])
        ring_r = r - rs
        if ring_r > rs * 0.5:
            n_ring = min(8, max(4, int(round(2 * np.pi * ring_r / (2 * rs)))))
            for k in range(n_ring):
                a = 2 * np.pi * k / n_ring
                rows.append([ring_r * np.cos(a), ring_r * np.sin(a), z, rs])
    rows = np.asarray(rows)
    if len(rows) > target:
        rows = rows[np.linspace(0, len(rows) - 1, target).astype(int)]
    return rows


def _hollow_spheres(r, h, wall, target=NS):
    """Wall annulus + bottom disk (bowl/mug).

    The top (rim) ring must be dense enough that a 2.2 cm finger pad
    always straddles at least one sphere -- rim pinches are THE grasp
    for these objects, so the rim gets most of the budget.
    """
    rs = float(max(wall / 2, 0.006))
    ring_r = r - rs
    rows = []
    # rim ring: spacing <= 1.5 cm along the circumference
    n_rim = max(8, int(np.ceil(2 * np.pi * ring_r / 0.015)))
    n_rim = min(n_rim, target - 10)
    for k in range(n_rim):
        a = 2 * np.pi * k / n_rim
        rows.append([ring_r * np.cos(a), ring_r * np.sin(a), h / 2 - rs, rs])
    # mid wall ring (side support)
    for k in range(6):
        a = 2 * np.pi * k / 6 + 0.3
        rows.append([ring_r * np.cos(a), ring_r * np.sin(a), 0.0, rs])
    # bottom disk
    rows.append([0.0, 0.0, -h / 2 + rs, rs])
    for k in range(3):
        a = 2 * np.pi * k / 3
        rr = ring_r * 0.6
        rows.append([rr * np.cos(a), rr * np.sin(a), -h / 2 + rs, rs])
    rows = np.asarray(rows)
    if len(rows) > target:
        rows = rows[np.linspace(0, len(rows) - 1, target).astype(int)]
    return rows


def _box_surface(half, n=NP, rng=None):
    rng = rng or np.random.RandomState(0)
    half = np.asarray(half)
    areas = np.array([half[1] * half[2], half[0] * half[2], half[0] * half[1]]) * 2
    probs = np.repeat(areas, 2)
    probs = probs / probs.sum()
    face = rng.choice(6, size=n, p=probs)
    uv = rng.uniform(-1, 1, (n, 2))
    pts = np.zeros((n, 3))
    axis = face // 2
    sign = np.where(face % 2 == 0, 1.0, -1.0)
    for i in range(n):
        a = axis[i]
        others = [j for j in range(3) if j != a]
        pts[i, a] = sign[i] * half[a]
        pts[i, others[0]] = uv[i, 0] * half[others[0]]
        pts[i, others[1]] = uv[i, 1] * half[others[1]]
    return pts


def _cyl_surface(r, h, n=NP, rng=None, hollow=False, wall=0.0):
    rng = rng or np.random.RandomState(1)
    side_area = 2 * np.pi * r * h
    cap_area = np.pi * r * r * (1 if hollow else 2)
    p_side = side_area / (side_area + cap_area)
    pts = np.zeros((n, 3))
    for i in range(n):
        if rng.rand() < p_side:
            a = rng.uniform(0, 2 * np.pi)
            z = rng.uniform(-h / 2, h / 2)
            rr = r if (not hollow or rng.rand() < 0.5) else r - wall
            pts[i] = [rr * np.cos(a), rr * np.sin(a), z]
        else:
            a = rng.uniform(0, 2 * np.pi)
            rr = r * np.sqrt(rng.rand())
            z = -h / 2 if hollow else (h / 2 if rng.rand() < 0.5 else -h / 2)
            pts[i] = [rr * np.cos(a), rr * np.sin(a), z]
    return pts


def _grasp_pose(center, approach, closing):
    """4x4 hand pose from grasp center, approach (+z), closing (+y)."""
    z = approach / np.linalg.norm(approach)
    y = closing - z * np.dot(closing, z)
    y = y / np.linalg.norm(y)
    x = np.cross(y, z)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2] = x, y, z
    T[:3, 3] = center - GRASP_DEPTH * z
    return T


# How deep the closing point sits past the approach-facing surface.
# Bounded by palm clearance: palm front face is GRASP_DEPTH - 0.058 =
# 0.042 m behind the closing point, so depth <= ~0.03 keeps the palm
# clear of the object.
MAX_INSERT_DEPTH = 0.030


def _box_grasps(half, max_g=NG):
    """Antipodal pinches near the approach-facing surface of a box."""
    grasps = []
    half = np.asarray(half)
    for close_ax in range(3):
        width = 2 * half[close_ax]
        if width > GRIPPER_MAX_WIDTH:
            continue
        for appr_ax in range(3):
            if appr_ax == close_ax:
                continue
            free_ax = 3 - close_ax - appr_ax
            depth = min(MAX_INSERT_DEPTH, float(half[appr_ax]))
            for sgn in (1.0, -1.0):
                approach = np.zeros(3)
                approach[appr_ax] = -sgn  # approach toward the +sgn face
                # centered along the free axis: offset pinches land the
                # 2.2 cm pad asymmetrically and topple the object
                offsets = [0.0]
                for off in offsets:
                    center = np.zeros(3)
                    center[appr_ax] = sgn * (half[appr_ax] - depth)
                    center[free_ax] = off
                    closing = np.zeros(3)
                    closing[close_ax] = 1.0
                    grasps.append(_grasp_pose(center, approach, closing))
                    grasps.append(_grasp_pose(center, approach, -closing))
    return grasps[:max_g]


def _cyl_grasps(r, h, max_g=NG, hollow=False, wall=0.0):
    grasps = []
    if 2 * r <= GRIPPER_MAX_WIDTH:
        # side pinches across the diameter at several heights/azimuths
        for z in np.linspace(-0.3, 0.3, 3) * h:
            for k in range(6):
                a = 2 * np.pi * k / 6
                radial = np.array([np.cos(a), np.sin(a), 0.0])
                closing = np.array([-np.sin(a), np.cos(a), 0.0])
                grasps.append(_grasp_pose(np.array([0, 0, z]), -radial, closing))
        # top-down with closing across the diameter, pinching near the top
        depth = min(MAX_INSERT_DEPTH, h / 2)
        for k in range(4):
            a = np.pi * k / 4
            closing = np.array([np.cos(a), np.sin(a), 0.0])
            grasps.append(
                _grasp_pose(
                    np.array([0, 0, h / 2 - depth]), np.array([0, 0, -1.0]), closing
                )
            )
    if hollow:
        # rim pinch: close across the wall, approach top-down
        ring_r = r - wall / 2
        depth = min(MAX_INSERT_DEPTH, h / 2)
        for k in range(8):
            a = 2 * np.pi * k / 8
            center = np.array([ring_r * np.cos(a), ring_r * np.sin(a), h / 2 - depth])
            closing = np.array([np.cos(a), np.sin(a), 0.0])
            grasps.append(_grasp_pose(center, np.array([0, 0, -1.0]), closing))
    return grasps[:max_g]


# ---------------------------------------------------------------------------
# Named libraries mirroring the reference object splits
# ---------------------------------------------------------------------------

def ycb_proxy_specs() -> List[AssetSpec]:
    """Proxies for experiments/object_index/ycb_large.json with published
    YCB dimensions/masses."""
    return [
        AssetSpec("003_cracker_box", "box", (0.060, 0.158, 0.210), 0.411),
        AssetSpec("004_sugar_box", "box", (0.038, 0.089, 0.175), 0.514),
        AssetSpec("005_tomato_soup_can", "cylinder", (0.033, 0.101), 0.349),
        AssetSpec("006_mustard_bottle", "cylinder", (0.032, 0.190), 0.603),
        AssetSpec("021_bleach_cleanser", "cylinder", (0.034, 0.250), 1.131),
        AssetSpec("019_pitcher_base", "cylinder", (0.054, 0.242), 0.178),
        AssetSpec("010_potted_meat_can", "box", (0.057, 0.097, 0.082), 0.370),
        AssetSpec("024_bowl", "hollow", (0.080, 0.055, 0.008), 0.147),
        AssetSpec("025_mug", "hollow", (0.047, 0.081, 0.007), 0.118),
        AssetSpec("061_foam_brick", "box", (0.050, 0.075, 0.050), 0.028),
    ]


def extra_shape_specs(seed: int = 0, n_boxes: int = 16, n_cyls: int = 15) -> List[AssetSpec]:
    """Random graspable primitives mirroring extra_shape.json's box/cyl set."""
    rng = np.random.RandomState(seed)
    specs = []
    for i in range(n_boxes):
        w = rng.uniform(0.03, 0.075)
        d = rng.uniform(0.03, 0.12)
        h = rng.uniform(0.05, 0.20)
        specs.append(AssetSpec(f"box_box{i:03d}", "box", (w, d, h), 0.2 * w * d * h / 3e-4))
    for i in range(n_cyls):
        r = rng.uniform(0.015, 0.037)
        h = rng.uniform(0.05, 0.22)
        specs.append(AssetSpec(f"box_cylinder{i:03d}", "cylinder", (r, h), 0.25))
    return specs


@dataclasses.dataclass
class ObjectLibrary:
    """Padded per-object tensors (O = number of objects)."""

    names: List[str]
    spheres: torch.Tensor         # (O, NS, 4) centres + radius, radius 0 = pad
    coarse_spheres: torch.Tensor  # (O, NC, 4) subset for object-object contact
    surface_points: torch.Tensor  # (O, NP, 3)
    extents: torch.Tensor         # (O, 3) full extents
    mass: torch.Tensor            # (O,)
    inertia: torch.Tensor         # (O, 3) diagonal body-frame inertia
    grasps: torch.Tensor          # (O, NG, 4, 4)
    grasp_valid: torch.Tensor     # (O, NG) bool
    rest_height: torch.Tensor     # (O,) centre height resting upright

    @property
    def num_objects(self) -> int:
        return len(self.names)

    def to(self, device) -> "ObjectLibrary":
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(device) for k in LIBRARY_FIELDS})


LIBRARY_FIELDS = (
    "spheres", "coarse_spheres", "surface_points", "extents", "mass",
    "inertia", "grasps", "grasp_valid", "rest_height",
)


def library_from_arrays(names, **arrays) -> ObjectLibrary:
    """An ObjectLibrary from numpy arrays of every field in LIBRARY_FIELDS
    (for example the fields of the JAX package's library): bool stays
    bool, every other field becomes float32."""
    missing = set(LIBRARY_FIELDS) - set(arrays)
    if missing:
        raise ValueError(f"library_from_arrays: missing {sorted(missing)}")
    conv = {}
    for k in LIBRARY_FIELDS:
        a = np.asarray(arrays[k])
        conv[k] = torch.as_tensor(np.array(a, dtype=bool if a.dtype == bool else np.float32))
    return ObjectLibrary(names=list(names), **conv)


def _build_one(spec: AssetSpec):
    if spec.kind == "box":
        half = np.asarray(spec.dims) / 2.0
        spheres = _box_spheres(half)
        surface = _box_surface(half)
        grasps = _box_grasps(half)
        extents = np.asarray(spec.dims)
        inertia = spec.mass / 12.0 * np.array(
            [
                extents[1] ** 2 + extents[2] ** 2,
                extents[0] ** 2 + extents[2] ** 2,
                extents[0] ** 2 + extents[1] ** 2,
            ]
        )
        rest_h = half[2]
    elif spec.kind == "cylinder":
        r, h = spec.dims
        spheres = _cyl_spheres(r, h)
        surface = _cyl_surface(r, h)
        grasps = _cyl_grasps(r, h)
        extents = np.array([2 * r, 2 * r, h])
        izz = 0.5 * spec.mass * r * r
        ixx = spec.mass / 12.0 * (3 * r * r + h * h)
        inertia = np.array([ixx, ixx, izz])
        rest_h = h / 2
    elif spec.kind == "hollow":
        r, h, wall = spec.dims
        spheres = _hollow_spheres(r, h, wall)
        surface = _cyl_surface(r, h, hollow=True, wall=wall)
        grasps = _cyl_grasps(r, h, hollow=True, wall=wall)
        extents = np.array([2 * r, 2 * r, h])
        izz = spec.mass * r * r
        ixx = spec.mass / 12.0 * (3 * r * r + h * h) + 0.5 * izz
        inertia = np.array([ixx, ixx, izz])
        rest_h = h / 2
    else:
        raise ValueError(spec.kind)

    # padding spheres: radius 0 AND parked far above the scene so they can
    # never register phantom contacts inside a contact primitive
    sph = np.zeros((NS, 4))
    sph[:, 2] = 1e3
    sph[: len(spheres)] = spheres[:NS]
    surf = np.zeros((NP, 3))
    surf[: len(surface)] = surface[:NP]
    if len(surface) < NP:
        surf[len(surface):] = surface[np.arange(NP - len(surface)) % len(surface)]
    g = np.tile(np.eye(4), (NG, 1, 1))
    gv = np.zeros(NG, bool)
    for i, gp in enumerate(grasps[:NG]):
        g[i] = gp
        gv[i] = True
    # inertia floor keeps the implicit integrator well-conditioned
    inertia = np.maximum(inertia, 1e-5)
    coarse = coarse_sphere_subset(sph)
    return sph, surf, extents, spec.mass, inertia, g, gv, rest_h, coarse


def build_library(specs: Sequence[AssetSpec]) -> ObjectLibrary:
    if not specs:
        raise ValueError("build_library: no specs")
    rows = [_build_one(s) for s in specs]
    stack = lambda i: np.stack([r[i] for r in rows])
    return library_from_arrays(
        [s.name for s in specs],
        spheres=stack(0), coarse_spheres=stack(8), surface_points=stack(1),
        extents=stack(2), mass=np.array([r[3] for r in rows]), inertia=stack(4),
        grasps=stack(5), grasp_valid=stack(6), rest_height=np.array([r[7] for r in rows]),
    )


def empty_library() -> ObjectLibrary:
    """An ObjectLibrary with no objects (the start of `extend_library`)."""
    z = lambda *shape: torch.zeros(shape)  # noqa: E731
    return ObjectLibrary(
        names=[], spheres=z(0, NS, 4), coarse_spheres=z(0, NC, 4),
        surface_points=z(0, NP, 3), extents=z(0, 3), mass=z(0), inertia=z(0, 3),
        grasps=z(0, NG, 4, 4), grasp_valid=torch.zeros((0, NG), dtype=torch.bool),
        rest_height=z(0),
    )


def verify_library_grasps(lib: ObjectLibrary, params=None) -> ObjectLibrary:
    """Physics-verify every grasp in the library and mask out failures.

    Runs the close-and-hold rig (data/mesh_import.verify_grasps_physics,
    on the CPU) over each object's padded grasp set -- the library-wide
    analogue of ACRONYM's simulation-verified grasp labels (reference:
    misc/grasp_data_reader.py:338-357). Objects where no grasp survives
    keep their analytic set (better a shaky grasp DB than an
    ungraspable object). `params`: the PhysicsParams the env will
    simulate with (e.g. `EnvParams.physics`); default PhysicsParams()."""
    from gaddpg_tpu_torch.data.mesh_import import verify_grasps_physics

    if lib.num_objects == 0:
        return lib
    gv = lib.grasp_valid.cpu().numpy().copy()
    sph, grs = lib.spheres.cpu().numpy(), lib.grasps.cpu().numpy()
    masses, inert = lib.mass.cpu().numpy(), lib.inertia.cpu().numpy()
    held = np.zeros_like(gv)
    for o in range(lib.num_objects):
        held[o] = verify_grasps_physics(sph[o], float(masses[o]), inert[o], grs[o],
                                        params=params)
    new_gv = gv & held
    keep = new_gv.any(axis=1)
    new_gv[~keep] = gv[~keep]
    return dataclasses.replace(lib, grasp_valid=torch.as_tensor(new_gv).to(lib.grasp_valid.device))


def index_format(path: str):
    """The `format` key of an index JSON (a dict), or None for a mesh index
    (a dict of splits or a list of entries without one)."""
    with open(path) as f:
        idx = json.load(f)
    return idx.get("format") if isinstance(idx, dict) else None


def library_from_index(index: str = "ycb", split: str = "train") -> ObjectLibrary:
    """The library named after a reference object index:

    - "ycb" (experiments/object_index/ycb_large.json proxies; the test
      split drops the pitcher) or "extra_shape": the built-in proxies;
    - "proc_shapenet_1216": the checked-in seed index
      experiments/object_index/proc_shapenet_1216.json (1216 train / 304
      test seeds and their grasp manifest), built through the mesh
      pipeline and cached (`data.procgen.library_from_seed_index`);
    - "proc_shapenet" or "proc_shapenet:N": N procedural objects (default
      64) from seed 0 (train) or 100000 (test), built on the spot;
    - a path to a JSON file: a seed index if its `format` key says
      "proc_seed_index", else a mesh index (the filter_shapenet.json
      pattern, reference: experiments/object_index/filter_shapenet.json
      + env/panda_scene.py:523-573): {"train": [...], "test": [...]},
      each entry {"name", "obj" (path), optional "grasps" (h5/json path),
      optional "scale"/"mass"} (`library_from_mesh_index`).
    """
    if index == "ycb":
        specs = ycb_proxy_specs()
        if split == "test":
            specs = [s for s in specs if s.name != "019_pitcher_base"]
    elif index == "extra_shape":
        specs = extra_shape_specs()
    elif index == "proc_shapenet_1216":
        from gaddpg_tpu_torch.data.procgen import library_from_seed_index

        here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        return library_from_seed_index(
            os.path.join(here, "experiments", "object_index", "proc_shapenet_1216.json"), split)
    elif index == "proc_shapenet" or index.startswith("proc_shapenet:"):
        from gaddpg_tpu_torch.data.procgen import build_proc_library

        n = int(index.split(":")[1]) if ":" in index else 64
        return build_proc_library(n, seed0=0 if split == "train" else 100000)
    elif index.endswith(".json") and os.path.exists(index):
        if index_format(index) == "proc_seed_index":
            from gaddpg_tpu_torch.data.procgen import library_from_seed_index

            return library_from_seed_index(index, split)
        return library_from_mesh_index(index, split)
    else:
        raise ValueError(f"unknown object index {index!r}")
    return build_library(specs)


def library_cache_path(path: str, split: str) -> str:
    """Where the built library of index `path` is cached: beside the
    JSON, keyed on the split and the asset pipeline's PACKING_VERSION,
    under a name of the port's own (the JAX package writes
    `<index>.<split>.v<N>.libcache.npz`, with its own grasp labels)."""
    from gaddpg_tpu_torch.data.mesh_import import PACKING_VERSION

    return f"{path}.{split}.v{PACKING_VERSION}.torch.libcache.npz"


def cached_library(path: str, split: str):
    """The cached library of index `path`, or None if there is none newer
    than the index."""
    cache = library_cache_path(path, split)
    if os.path.exists(cache) and os.path.getmtime(cache) >= os.path.getmtime(path):
        return load_library(cache)
    return None


def save_library(lib: ObjectLibrary, path: str) -> None:
    """Serialize a built ObjectLibrary (all padded arrays + names) in the
    JAX package's `.npz` layout."""
    np.savez_compressed(
        path, names=np.asarray(lib.names, dtype=object),
        **{k: getattr(lib, k).cpu().numpy() for k in LIBRARY_FIELDS},
    )


def load_library(path: str) -> ObjectLibrary:
    """An ObjectLibrary (CPU tensors) from a `save_library` file, the
    port's or the JAX package's."""
    data = np.load(path, allow_pickle=True)
    return library_from_arrays([str(n) for n in data["names"]],
                               **{k: data[k] for k in LIBRARY_FIELDS})


def library_from_mesh_index(path: str, split: str = "train") -> ObjectLibrary:
    """Mesh-index JSON -> ObjectLibrary via the mesh asset pipeline.

    The pipeline (voxel fill, sphere pack, antipodal candidates,
    close-and-hold physics verification) costs seconds per object, and
    every train/eval process reloads the same index, so the built library
    is cached beside the JSON (`library_cache_path`) and rebuilt when the
    JSON is newer (reference: misc/grasp_data_reader.py caches + env
    asset reuse). Grasp files carry their own labels and get only the
    geometric pad-squeeze check."""
    from gaddpg_tpu_torch.data.grasp_files import read_grasp_file
    from gaddpg_tpu_torch.data.mesh_import import asset_from_mesh, extend_library, load_obj

    lib = cached_library(path, split)
    if lib is not None:
        return lib
    with open(path) as f:
        idx = json.load(f)
    entries = idx[split] if isinstance(idx, dict) else idx
    root = os.path.dirname(os.path.abspath(path))

    def resolve(p):
        return p if os.path.isabs(p) else os.path.join(root, p)

    built, names = [], []
    for e in entries:
        tris = load_obj(resolve(e["obj"]), scale=float(e.get("scale", 1.0)))
        grasps = None
        if e.get("grasps"):
            g = read_grasp_file(resolve(e["grasps"]))
            grasps = g["transforms"][g["positive"]]
        built.append(asset_from_mesh(tris, mass=e.get("mass"), grasps=grasps))
        names.append(e["name"])
    lib = extend_library(empty_library(), built, names)
    try:
        save_library(lib, library_cache_path(path, split))
    except OSError:
        pass  # read-only index location: rebuild next time
    return lib


def box_asset(w, d, h, mass=0.2, name="box") -> ObjectLibrary:
    return build_library([AssetSpec(name, "box", (w, d, h), mass)])


def cylinder_asset(r, h, mass=0.3, name="cyl") -> ObjectLibrary:
    return build_library([AssetSpec(name, "cylinder", (r, h), mass)])
