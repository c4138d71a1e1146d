"""Mesh -> simulable asset: OBJ loading and library-entry construction
(counterpart of gaddpg_tpu/data/mesh_import.py).

Covers the reference's external asset path (YCB/ShapeNet
`model_normalized.obj` + urdf, reference: env/panda_scene.py:546-552,
misc/convert_graspnet_grasp.py): given a triangle mesh, produce the
sphere set, surface samples, extents, inertia and an antipodal grasp
set compatible with `ObjectLibrary`. Everything but the grasp
verification is numpy, as in the JAX package, so the port builds the
same spheres, surface, extents, mass, inertia and grasp candidates; the
verification runs the port's contact physics on the CPU.
"""

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from gaddpg_tpu_torch.data.mesh_native import (
    sphere_pack,
    surface_distance_grid,
    surface_sample,
    voxel_occupancy,
)
from gaddpg_tpu_torch.ops.contact_scan import NS

# Version of the mesh -> asset pipeline (voxel fill, packing score,
# adaptive min_radius, grasp generation). Bump whenever asset_from_mesh
# output changes for the same mesh: cached mesh-index libraries
# (envs/assets.py library_from_mesh_index) are keyed on this, so a
# stale cache can never mix packings from two pipeline versions.
# v4: CPU-pinned deterministic grasp verification + thin-wall antipodal
# pinches (width floor 12 mm -> 1.2 mm).
PACKING_VERSION = 4


def load_obj(path: str, scale: float = 1.0) -> np.ndarray:
    """Minimal OBJ parser -> (n_tri, 3, 3) float32 triangles.

    Supports v / f lines with polygonal faces (fan-triangulated) and
    v/vt/vn index syntax.
    """
    verts: List[Tuple[float, float, float]] = []
    tris: List[Tuple[int, int, int]] = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    tris.append((idx[0], idx[k], idx[k + 1]))
    v = np.asarray(verts, np.float32) * scale
    t = np.asarray(tris, np.int64)
    return v[t]


def _tri_points_normals(tris: np.ndarray, n: int, seed: int = 0):
    """Area-weighted surface samples with owning-triangle normals."""
    rng = np.random.RandomState(seed)
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    nrm = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(nrm, axis=-1)
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    p = area / max(area.sum(), 1e-12)
    ti = rng.choice(len(tris), size=n, p=p)
    u, w = rng.rand(n, 1), rng.rand(n, 1)
    flip = (u + w) > 1
    u = np.where(flip, 1 - u, u)
    w = np.where(flip, 1 - w, w)
    pts = tris[ti, 0] + u * e1[ti] + w * e2[ti]
    return pts.astype(np.float32), nrm[ti].astype(np.float32)


def antipodal_grasps(tris: np.ndarray, max_g: int = 64, seed: int = 0,
                     width=(0.0012, 0.075), n_samples: int = 800):
    """Antipodal grasp candidates from mesh surface geometry.

    The counterpart of the ACRONYM grasp sets the reference loads per
    object (reference: env/panda_scene.py:1252-1255,
    misc/grasp_data_reader.py): pairs of surface points with opposing
    normals within the gripper width become pinch grasps, each offered
    with several approach rolls about the closing axis (reachability is
    filtered at runtime like every DB grasp).

    `width[0]` admits WALL pinches (e.g. a 1.5 mm cup rim): the earlier
    12 mm floor silently excluded every candidate on thin-shell
    geometry, the adversarial-mesh suite's known zero-grasp class. Pairs
    across an internal GAP (nothing between the pads) are already
    rejected by the along-normal conditions -- gap-facing normals point
    toward each other, the pinch test requires them pointing apart.
    """
    from gaddpg_tpu_torch.envs.assets import _grasp_pose

    pts, nrm = _tri_points_normals(tris, n_samples, seed)
    d = pts[:, None, :] - pts[None, :, :]                    # p_i - p_j
    dist = np.linalg.norm(d, axis=-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        dirs = d / np.maximum(dist[..., None], 1e-9)
    opposing = np.einsum("ik,jk->ij", nrm, nrm) < -0.6
    in_width = (dist > width[0]) & (dist < width[1])
    # antipodal condition: at each point the closing line runs INTO the
    # surface, i.e. along the outward normal when pointing away from the
    # other point. dirs[i,j] = (p_i - p_j)/|.|, so n_i aligns with dirs
    # and n_j with -dirs.
    along_i = np.einsum("ijk,ik->ij", dirs, nrm) > 0.8
    along_j = np.einsum("ijk,jk->ij", -dirs, nrm) > 0.8
    ii, jj = np.nonzero(np.triu(opposing & in_width & along_i & along_j, 1))
    if len(ii) == 0:
        return None

    rng = np.random.RandomState(seed + 1)
    order = rng.permutation(len(ii))
    grasps, used = [], []
    min_sep = 0.015
    for k in order:
        i, j = ii[k], jj[k]
        center = 0.5 * (pts[i] + pts[j])
        if any(np.linalg.norm(center - c) < min_sep for c in used):
            continue
        used.append(center)
        closing = pts[j] - pts[i]
        closing = closing / np.linalg.norm(closing)
        # several approach rolls about the closing axis
        base = np.array([0.0, 0.0, 1.0])
        if abs(np.dot(base, closing)) > 0.95:
            base = np.array([1.0, 0.0, 0.0])
        a0 = base - closing * np.dot(base, closing)
        a0 = a0 / np.linalg.norm(a0)
        a1 = np.cross(closing, a0)
        for ang in (0.0, np.pi / 2, np.pi, 3 * np.pi / 2):
            approach = np.cos(ang) * a0 + np.sin(ang) * a1
            grasps.append(_grasp_pose(center, approach, closing))
            if len(grasps) >= max_g:
                return np.asarray(grasps, np.float32)
    return np.asarray(grasps, np.float32) if grasps else None


def filter_grasps_by_spheres(grasps: np.ndarray, spheres: np.ndarray,
                             pad_half=(0.011, 0.009, 0.027),
                             pad_center_z: float = 0.0854,
                             finger_travel: float = 0.04,
                             margin: float = 0.004) -> np.ndarray:
    """Keep grasps whose closing finger pads actually squeeze a sphere.

    The simulator's contact reality is the sphere set; a grasp that
    closes on a region the packing leaves empty (e.g. past a rim)
    pinches air. Exact test in the grasp/hand frame against the pad box
    geometry (physics.types.PhysicsParams finger boxes): some sphere
    must overlap the pad's x/z footprint by `margin` while its y span is
    within finger reach -- the verify-on-load spirit of the reference's
    grasp reader (reference: misc/grasp_data_reader.py:338-357).
    """
    if grasps is None or len(grasps) == 0:
        return grasps
    live = spheres[spheres[:, 3] > 0]
    keep = []
    for g in grasps:
        inv_r = g[:3, :3].T
        c = (live[:, :3] - g[:3, 3]) @ inv_r.T  # centers, grasp frame
        r = live[:, 3]
        dx = np.maximum(np.abs(c[:, 0]) - pad_half[0], 0.0)
        dz = np.maximum(np.abs(c[:, 2] - pad_center_z) - pad_half[2], 0.0)
        # overlap requirement scales down for sub-margin spheres (thin
        # shells pack ~1-3 mm spheres; `r - margin` would be negative
        # and unsatisfiable, dropping every grasp on such geometry)
        m = np.minimum(margin, 0.5 * r)
        footprint = np.sqrt(dx**2 + dz**2) < r - m
        reachable = np.abs(c[:, 1]) < finger_travel + r - m
        keep.append(bool((footprint & reachable).any()))
    return grasps[np.asarray(keep)]


# the close-and-hold rig's thresholds (gaddpg_tpu/data/mesh_import.py:171-177)
CLOSE_SUBSTEPS = 250
HOLD_SUBSTEPS = 750
DISP_TOL = 0.008
# the rig's batch is padded to a multiple of this
GRASP_BATCH_MULTIPLE = 16


def rig_displacements(objects, close_substeps: int = CLOSE_SUBSTEPS,
                      hold_substeps: int = HOLD_SUBSTEPS, params=None):
    """The close-and-hold rig over several objects in one batch, on the
    CPU: `objects` is a list of (spheres (n, 4), mass, inertia (3,),
    grasps (G, 4, 4)); returns a list of (G,) float32 distances each
    object moves, one per grasp.

    Each grasp places its object so that the grasp meets the canonical
    hand pose (the Panda at DEFAULT_JOINTS, fingers open), the fingers
    close over `close_substeps` with gravity off, then hold over
    `hold_substeps` with gravity on; the table is out of reach. The
    physics is `physics.fast.fast_physics_step` on CPU tensors, so the
    contact scan's plain version: one numeric path on an explicit
    device, as the JAX package pins its rig to the CPU and to its XLA
    scan (gaddpg_tpu/data/mesh_import.py:171-287). Each object's grasps
    are padded with identity grasps to a multiple of 16, as the JAX
    function pads them. Every env of the batch is computed on its own, so
    an object's distances do not depend on the others in the batch. The
    rig's ops are small (B x 128 contact lanes), and torch's intra-op
    threads cost more than they give there, most when the host's cores are
    busy, so it runs on one thread; the labels do not depend on it."""
    from scipy.spatial.transform import Rotation

    from gaddpg_tpu_torch.physics.fast import fast_physics_step
    from gaddpg_tpu_torch.physics.types import (
        ArmState, BodyState, PhysicsParams, PhysicsState,
    )
    from gaddpg_tpu_torch.robot.panda import DEFAULT_JOINTS, fk_hand

    cpu = torch.device("cpu")
    f32 = dict(dtype=torch.float32, device=cpu)
    hand = fk_hand(torch.tensor(DEFAULT_JOINTS, **f32)).numpy()
    rows = {k: [] for k in ("grasps", "spheres", "mass", "inertia")}
    sizes = []
    for spheres, mass, inertia, grasps in objects:
        n_real = len(grasps)
        G = GRASP_BATCH_MULTIPLE * ((n_real + GRASP_BATCH_MULTIPLE - 1) // GRASP_BATCH_MULTIPLE)
        sizes.append((n_real, G))
        rows["grasps"].append(np.concatenate([np.asarray(grasps, np.float64),
                                              np.tile(np.eye(4), (G - n_real, 1, 1))]))
        # spheres padded to the contact scan's NS as physics.fast pads them
        sph = np.zeros((NS, 4), np.float32)
        sph[:, 2] = 1e6
        sph[:len(spheres)] = spheres
        rows["spheres"].append(np.repeat(sph[None], G, axis=0))
        rows["mass"].append(np.full(G, mass, np.float32))
        rows["inertia"].append(np.repeat(np.asarray(inertia, np.float32)[None], G, axis=0))
    grasps = np.concatenate(rows["grasps"])
    B = len(grasps)
    # object pose aligning each grasp with the canonical hand pose
    obj_T = hand @ np.linalg.inv(grasps)
    pos = torch.tensor(obj_T[:, :3, 3].astype(np.float32), **f32)
    quat = np.roll(Rotation.from_matrix(obj_T[:, :3, :3]).as_quat(), 1, axis=-1)

    q_open = np.concatenate([DEFAULT_JOINTS, [0.04, 0.04]])
    q_closed = q_open.copy()
    q_closed[7:9] = 0.0
    state = PhysicsState(
        arm=ArmState(q=torch.tensor(q_open, **f32).expand(B, 9).clone(),
                     qd=torch.zeros(B, 7, **f32),
                     q_target=torch.tensor(q_closed, **f32).expand(B, 9).clone()),
        obj=BodyState(pos=pos, quat=torch.tensor(quat, **f32),
                      linvel=torch.zeros(B, 3, **f32), angvel=torch.zeros(B, 3, **f32)),
        contact_force=torch.zeros(B, **f32),
        gripper_contact=torch.zeros(B, dtype=torch.bool, device=cpu),
    )
    sph, m, it = (torch.tensor(np.concatenate(rows[k]), **f32)
                  for k in ("spheres", "mass", "inertia"))

    # the contact and friction constants the env simulates with: labels
    # from another parameter set would not transfer
    base = params if params is not None else PhysicsParams()
    p_close = dataclasses.replace(base, gravity=0.0, table_z=-10.0)
    p_hold = dataclasses.replace(base, table_z=-10.0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            state = fast_physics_step(p_close, state, sph, m, it, substeps=close_substeps)
            state = fast_physics_step(p_hold, state, sph, m, it, substeps=hold_substeps)
            disp = torch.linalg.vector_norm(state.obj.pos - pos, dim=-1).numpy()
    finally:
        torch.set_num_threads(threads)
    out, start = [], 0
    for n_real, G in sizes:
        out.append(disp[start:start + n_real])
        start += G
    return out


def grasp_displacements(spheres: np.ndarray, mass: float, inertia: np.ndarray,
                        grasps: np.ndarray, close_substeps: int = CLOSE_SUBSTEPS,
                        hold_substeps: int = HOLD_SUBSTEPS, params=None) -> np.ndarray:
    """(G,) float32 distance the object moves in the close-and-hold rig
    for each grasp (`rig_displacements` of one object)."""
    return rig_displacements([(spheres, mass, inertia, grasps)], close_substeps,
                             hold_substeps, params)[0]


def verify_grasps_physics(spheres: np.ndarray, mass: float,
                          inertia: np.ndarray, grasps: np.ndarray,
                          close_substeps: int = CLOSE_SUBSTEPS,
                          hold_substeps: int = HOLD_SUBSTEPS,
                          disp_tol: float = DISP_TOL,
                          params=None) -> np.ndarray:
    """Physics-verified grasp mask: close on the object, then hold it
    against gravity in free space; a grasp passes if the object stays
    within `disp_tol` of where it started (`grasp_displacements`).

    The analogue of the ACRONYM datasets' simulation-verified grasp
    labels (reference: misc/grasp_data_reader.py:338-357). Geometric
    filters cannot see squirt-out failures -- a pad edge-contacting a
    bulging sphere near a rim ejects the object even though the
    footprint test passes; this does. The label is a threshold test on a
    contact simulation, so a grasp near the threshold can flip under a
    one-ulp change of its inputs (`uncertain_labels`)."""
    disp = grasp_displacements(spheres, mass, inertia, grasps, close_substeps,
                               hold_substeps, params)
    return disp < disp_tol


# A label is on the rig's own rounding if its displacement lies within
# this many times its one-ulp spread of DISP_TOL (`uncertain_labels`).
UNCERTAIN_FACTOR = 8.0


def uncertain_labels(spheres: np.ndarray, mass: float, inertia: np.ndarray,
                     grasps: np.ndarray, disp: np.ndarray, params=None) -> np.ndarray:
    """(G,) bool: the grasps whose label sits on the rig's own rounding.

    The rig reruns with every sphere centre moved one ulp up and one ulp
    down; a grasp's spread is the range of its three displacements (`disp`
    and the two reruns). Its label is uncertain if its displacement lies
    within UNCERTAIN_FACTOR times that spread of DISP_TOL; a label that
    flips across the three runs is always so. Contact at the edge of
    slipping is chaotic, and another order of float32 sums is a larger
    perturbation than one ulp on the inputs: on procedural seeds 0-29
    (1,877 grasps) the port's labels differ from the JAX package's on 9
    grasps, 8 of them flipping under the port's own one-ulp reruns and one
    whose displacement sits 6.1 spreads from DISP_TOL."""
    sph = np.asarray(spheres, np.float32)
    nudged = []
    for way in (np.inf, -np.inf):
        s = sph.copy()
        s[:, :3] = np.nextafter(sph[:, :3], np.float32(way))
        nudged.append((s, mass, inertia, grasps))
    runs = np.stack([np.asarray(disp, np.float32)] + rig_displacements(nudged, params=params))
    spread = runs.max(axis=0) - runs.min(axis=0)
    return np.abs(runs[0] - DISP_TOL) <= UNCERTAIN_FACTOR * spread


def asset_from_mesh(tris: np.ndarray, mass: Optional[float] = None,
                    density: float = 300.0, res: int = 24,
                    max_spheres: int = 32, num_surface: int = 1024,
                    grasps: Optional[np.ndarray] = None, seed: int = 0,
                    verify: bool = True):
    """Build library-entry arrays from triangles (n, 3, 3).

    Returns dict(spheres (NS,4), surface (NP,3), extents (3,), mass,
    inertia (3,), grasps (G,4,4) or box-style fallback, rest_height).
    `grasps` can carry an external grasp DB (e.g. converted ACRONYM
    poses); otherwise antipodal candidates are generated from surface
    normals like assets.py does for primitives.
    """
    lo = tris.reshape(-1, 3).min(axis=0)
    hi = tris.reshape(-1, 3).max(axis=0)
    pad = 0.02 * (hi - lo).max() + 1e-4
    lo_p, hi_p = lo - pad, hi + pad

    occ = voxel_occupancy(tris, lo_p, hi_p, res)
    dist = surface_distance_grid(tris, lo_p, hi_p, res)
    # thin-walled geometry: the default 4 mm packing floor would reject
    # every interior sphere of a shell thinner than 8 mm, leaving the
    # asset contactless. Scale the floor down to the actual interior
    # thickness (deepest interior cell) so thin shells still pack; the
    # 0.8 mm absolute floor keeps degenerate sliver cells out.
    inside = occ.reshape(-1) > 0
    interior_max = float(dist.reshape(-1)[inside].max()) if inside.any() else 0.0
    # 0.35: a vessel's wall is thinner than its base plate (thin_cup:
    # 1.4 mm wall depth vs 2.4 mm base) -- the floor must admit wall
    # cells or the walls end up contactless and every pinch grasp fails
    min_radius = float(np.clip(0.35 * interior_max, 0.8e-3, 4e-3))
    spheres = sphere_pack(occ, dist, lo_p, hi_p, max_spheres=max_spheres,
                          min_radius=min_radius)
    surface = surface_sample(tris, num_surface, seed=seed)

    extents = (hi - lo).astype(np.float32)
    volume = float(occ.mean()) * float(np.prod(hi_p - lo_p))
    m = float(mass) if mass is not None else max(volume * density, 0.02)

    # RE-CENTER the asset at its center of mass: BodyState.pos is the
    # COM (gravity acts there, contact torques and the diagonal inertia
    # are taken about it), but mesh files use arbitrary frames -- the
    # YCB mug's origin is its bottom face, and simulating about that
    # point tips the object over during settle. Uniform-density COM and
    # inertia from the occupied-voxel distribution (diagonal part, the
    # physics model's inertia representation).
    cell = (np.asarray(hi_p) - np.asarray(lo_p)) / res
    ijk = np.argwhere(occ > 0)
    if len(ijk) == 0:
        ijk = np.zeros((1, 3))
    vox = np.asarray(lo_p) + (ijk + 0.5) * cell
    com = vox.mean(axis=0).astype(np.float32)
    d = vox - com
    m_cell = m / len(vox)
    inertia = m_cell * np.array(
        [
            (d[:, 1] ** 2 + d[:, 2] ** 2).sum(),
            (d[:, 0] ** 2 + d[:, 2] ** 2).sum(),
            (d[:, 0] ** 2 + d[:, 1] ** 2).sum(),
        ],
        np.float32,
    )
    inertia = np.maximum(inertia, 1e-5)

    spheres = spheres.copy()
    spheres[:, :3] -= com
    surface = surface - com
    rest_height = float(com[2] - lo[2])
    generated = grasps is None
    if grasps is None:
        grasps = antipodal_grasps(tris, seed=seed)
    if grasps is not None and len(grasps):
        grasps = grasps.copy()
        grasps[:, :3, 3] -= com
    grasps = filter_grasps_by_spheres(grasps, spheres)
    # physics-verify GENERATED candidates; externally provided grasp
    # DBs (ACRONYM et al.) carry their own simulation-verified labels
    # and only get the geometric pad-squeeze check, like the reference
    if generated and grasps is not None and len(grasps) and verify:
        held = verify_grasps_physics(spheres, m, inertia, grasps)
        grasps = grasps[held]
    if grasps is not None and len(grasps) == 0:
        grasps = None
    return {
        "spheres": spheres,
        "surface": surface,
        "extents": extents,
        "mass": m,
        "inertia": inertia,
        "grasps": grasps,
        "rest_height": rest_height,
    }


def extend_library(lib, entries, names):
    """Append mesh-derived entries to an ObjectLibrary (padded as the JAX
    package pads them: padding spheres radius 0 parked at z = 1e3,
    surfaces tiled to NP points, grasps to NG with identity padding)."""
    from gaddpg_tpu_torch.envs.assets import (
        LIBRARY_FIELDS, NG, NP, NS, coarse_sphere_subset, library_from_arrays,
    )

    def pad_rows(a, n, fill=0.0):
        out = np.full((n,) + a.shape[1:], fill, np.float32)
        out[: min(len(a), n)] = a[:n]
        return out

    rows = {k: [] for k in LIBRARY_FIELDS}
    for e in entries:
        s = pad_rows(e["spheres"], NS)
        s[len(e["spheres"]):, 2] = 1e3  # park padding spheres
        rows["spheres"].append(s)
        rows["coarse_spheres"].append(coarse_sphere_subset(s))
        sp = e["surface"]
        if len(sp) < NP:
            sp = np.concatenate([sp, sp[np.arange(NP - len(sp)) % len(sp)]])
        rows["surface_points"].append(sp[:NP])
        rows["extents"].append(e["extents"])
        rows["mass"].append(e["mass"])
        rows["inertia"].append(e["inertia"])
        g = np.tile(np.eye(4, dtype=np.float32), (NG, 1, 1))
        v = np.zeros(NG, bool)
        if e["grasps"] is not None:
            k = min(len(e["grasps"]), NG)
            g[:k] = e["grasps"][:k]
            v[:k] = True
        rows["grasps"].append(g)
        rows["grasp_valid"].append(v)
        rows["rest_height"].append(e["rest_height"])

    arrays = {}
    for k in LIBRARY_FIELDS:
        old = getattr(lib, k).cpu().numpy()
        new = np.asarray(rows[k]).reshape((len(entries),) + old.shape[1:])
        # float64 rows round to float32 once, as jnp.asarray rounds them
        arrays[k] = np.concatenate([old, new.astype(old.dtype)])
    return library_from_arrays(lib.names + list(names), **arrays)
