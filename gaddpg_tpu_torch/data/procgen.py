"""Procedural mesh generation: a ShapeNet-scale object sweep without assets
(counterpart of gaddpg_tpu/data/procgen.py).

The reference trains over 1216 ShapeNet/ACRONYM meshes listed in
`experiments/object_index/filter_shapenet.json` (reference:
env/panda_scene.py:523-573). Those assets cannot be downloaded in this
environment, so this module synthesizes a comparable *distribution* of
graspable tabletop shapes as triangle meshes and pushes every one
through the same native mesh pipeline (`data/mesh_import.asset_from_mesh`:
C++ voxel fill -> sphere packing -> surface sampling -> antipodal grasp
generation + pad-squeeze validation) that real OBJ files take, so a real
ShapeNet download drops in with zero code changes.

Shape families (seeded, deterministic):
- superquadrics: boxes -> cylinders -> ellipsoids -> pinched solids via
  the two blockiness exponents;
- solids of revolution: bottle/cup/vase silhouettes from a smooth
  random radius profile;
- box composites: 2-3 unioned cuboids (L-shapes, lugs, stacked parts).

Every shape keeps at least one pinchable span under the gripper width
so the antipodal generator can find grasps.
"""

import os
import sys
from typing import List, Tuple

import numpy as np

GRIPPER_W = 0.075


def _grid_to_tris(P: np.ndarray, wrap_u: bool) -> np.ndarray:
    """Quad grid (nu, nv, 3) -> triangle soup (n, 3, 3)."""
    nu, nv = P.shape[:2]
    tris = []
    us = range(nu) if wrap_u else range(nu - 1)
    for i in us:
        i2 = (i + 1) % nu
        for j in range(nv - 1):
            a, b, c, d = P[i, j], P[i2, j], P[i2, j + 1], P[i, j + 1]
            tris.append((a, b, c))
            tris.append((a, c, d))
    return np.asarray(tris, np.float32)


def _sq(x, e):
    return np.sign(x) * np.abs(x) ** e


def superquadric_mesh(a: Tuple[float, float, float], e1: float, e2: float,
                      n_lat: int = 14, n_lon: int = 20) -> np.ndarray:
    """Superquadric surface |x/a1|^(2/e2)... closed via polar caps."""
    eta = np.linspace(-np.pi / 2, np.pi / 2, n_lat)
    om = np.linspace(-np.pi, np.pi, n_lon, endpoint=False)
    E, O = np.meshgrid(eta, om, indexing="ij")
    x = a[0] * _sq(np.cos(E), e1) * _sq(np.cos(O), e2)
    y = a[1] * _sq(np.cos(E), e1) * _sq(np.sin(O), e2)
    z = a[2] * _sq(np.sin(E), e1)
    P = np.stack([x, y, z], axis=-1)          # (n_lat, n_lon, 3)
    return _grid_to_tris(np.transpose(P, (1, 0, 2)), wrap_u=True)


def revolution_mesh(zs: np.ndarray, rs: np.ndarray, n_seg: int = 20) -> np.ndarray:
    """Solid of revolution around +z from a radius profile (closed caps)."""
    ang = np.linspace(-np.pi, np.pi, n_seg, endpoint=False)
    ring = np.stack([np.cos(ang), np.sin(ang)], axis=-1)       # (n_seg, 2)
    P = np.zeros((n_seg, len(zs) + 2, 3), np.float32)
    P[:, 1:-1, 0] = ring[:, 0:1] * rs[None, :]
    P[:, 1:-1, 1] = ring[:, 1:1 + 1] * rs[None, :]
    P[:, 1:-1, 2] = zs[None, :]
    P[:, 0, 2] = zs[0]            # bottom apex (degenerate ring = cap fan)
    P[:, -1, 2] = zs[-1]          # top apex
    return _grid_to_tris(P, wrap_u=True)


def box_mesh(half: np.ndarray, center: np.ndarray) -> np.ndarray:
    h, c = np.asarray(half), np.asarray(center)
    s = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)])
    v = s * h + c
    faces = [
        (0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
        (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3),
    ]
    tris = []
    for f in faces:
        tris.append((v[f[0]], v[f[1]], v[f[2]]))
        tris.append((v[f[0]], v[f[2]], v[f[3]]))
    return np.asarray(tris, np.float32)


def _smooth_profile(rng, n=14, r_lo=0.012, r_hi=0.045):
    """Random smooth radius profile with a guaranteed pinchable band."""
    z0 = rng.uniform(0.05, 0.20)
    zs = np.linspace(0, z0, n)
    base = rng.uniform(r_lo + 0.004, r_hi)
    bumps = sum(
        rng.uniform(-0.35, 0.35) * np.sin((k + 1) * np.pi * zs / z0 + rng.uniform(0, np.pi))
        for k in range(3)
    )
    rs = np.clip(base * (1.0 + bumps), r_lo, GRIPPER_W / 2 - 0.003)
    # neck somewhere in the upper half so side pinches exist
    rs[int(0.55 * n):] = np.minimum(rs[int(0.55 * n):], GRIPPER_W / 2 - 0.006)
    return zs - z0 / 2, rs.astype(np.float32)


def random_proc_mesh(seed: int) -> Tuple[np.ndarray, str]:
    """Deterministic random shape; returns (tris, family_name)."""
    rng = np.random.RandomState(seed)
    fam = seed % 3
    if fam == 0:
        a = (
            rng.uniform(0.015, GRIPPER_W / 2 - 0.004),
            rng.uniform(0.015, 0.055),
            rng.uniform(0.03, 0.11),
        )
        e1 = rng.uniform(0.3, 1.6)
        e2 = rng.uniform(0.3, 1.6)
        return superquadric_mesh(a, e1, e2), "superquadric"
    if fam == 1:
        zs, rs = _smooth_profile(rng)
        return revolution_mesh(zs, rs), "revolution"
    # composite: a graspable core box with 1-2 attached lugs
    core = np.array([
        rng.uniform(0.014, GRIPPER_W / 2 - 0.004),
        rng.uniform(0.02, 0.05),
        rng.uniform(0.03, 0.09),
    ])
    parts = [box_mesh(core, np.zeros(3))]
    for _ in range(rng.randint(1, 3)):
        h = core * rng.uniform(0.3, 0.8, 3)
        axis = rng.randint(3)
        off = np.zeros(3)
        off[axis] = (core[axis] + h[axis]) * rng.choice([-1.0, 1.0]) * 0.9
        parts.append(box_mesh(h, off))
    return np.concatenate(parts, axis=0), "composite"


def proc_entry(seed: int, verify: bool = True):
    """One library entry dict via the native pipeline (+ name); with
    verify=False its grasps are the physics rig's candidates."""
    from gaddpg_tpu_torch.data.mesh_import import asset_from_mesh

    tris, fam = random_proc_mesh(seed)
    entry = asset_from_mesh(tris, seed=seed, verify=verify)
    return entry, f"proc_{fam}_{seed:04d}"


def build_proc_library(num: int, seed0: int = 0, base_lib=None):
    """`num` procedural mesh objects -> ObjectLibrary (appended to
    base_lib when given). Objects whose grasp generation comes up empty
    are skipped (the reference's index files likewise list only objects
    with ACRONYM grasp data), so slightly more seeds than `num` may be
    consumed."""
    from gaddpg_tpu_torch.data.mesh_import import extend_library
    from gaddpg_tpu_torch.envs.assets import empty_library

    lib = base_lib if base_lib is not None else empty_library()
    entries, names = [], []
    seed = seed0
    attempts = 0
    while len(entries) < num and attempts < 3 * num:
        e, name = proc_entry(seed)
        seed += 1
        attempts += 1
        if e["grasps"] is None or len(e["grasps"]) == 0:
            continue
        entries.append(e)
        names.append(name)
    return extend_library(lib, entries, names)


def write_obj(path: str, tris: np.ndarray):
    """Triangle soup -> OBJ file (vertices deduplicated)."""
    v = tris.reshape(-1, 3)
    uniq, inv = np.unique(np.round(v, 6), axis=0, return_inverse=True)
    with open(path, "w") as f:
        for p in uniq:
            f.write("v %.6f %.6f %.6f\n" % (p[0], p[1], p[2]))
        idx = inv.reshape(-1, 3) + 1
        for t in idx:
            f.write("f %d %d %d\n" % (t[0], t[1], t[2]))


def export_proc_index(out_dir: str, n_train: int, n_test: int,
                      seed0: int = 0) -> str:
    """Write OBJ files + a filter_shapenet-style index JSON.

    The index path feeds `assets.library_from_index` /
    `library_from_mesh_index`, i.e. the exact file-based flow a real
    ShapeNet/ACRONYM download would take. Returns the index path.
    """
    import json

    import time

    os.makedirs(os.path.join(out_dir, "meshes"), exist_ok=True)
    idx = {"train": [], "test": []}
    stats = {"families": {}, "skipped": 0, "seconds": 0.0}
    t0 = time.time()
    seed = seed0
    for split, n in (("train", n_train), ("test", n_test)):
        made = 0
        attempts = 0
        while made < n and attempts < 3 * n:
            # same empty-grasp skip as build_proc_library: only index
            # seeds whose pipeline yields grasps, so the file-based and
            # in-memory flows produce the SAME library for the same
            # seeds
            entry, name = proc_entry(seed)
            tris, fam = random_proc_mesh(seed)
            seed += 1
            attempts += 1
            if entry["grasps"] is None or len(entry["grasps"]) == 0:
                stats["skipped"] += 1
                continue
            rel = os.path.join("meshes", name + ".obj")
            write_obj(os.path.join(out_dir, rel), tris)
            idx[split].append({"name": name, "obj": rel})
            made += 1
            f = stats["families"].setdefault(
                fam, {"count": 0, "grasps": 0, "spheres": 0}
            )
            f["count"] += 1
            f["grasps"] += int(len(entry["grasps"]))
            f["spheres"] += int(len(entry["spheres"]))
    stats["seconds"] = round(time.time() - t0, 1)
    stats["total"] = sum(f["count"] for f in stats["families"].values())
    path = os.path.join(out_dir, "proc_shapenet.json")
    with open(path, "w") as f:
        json.dump(idx, f, indent=1)
    with open(os.path.join(out_dir, "gen_stats.json"), "w") as f:
        json.dump(stats, f, indent=1)
    return path


def export_proc_seed_index(out_path: str, n_train: int, n_test: int,
                           seed0: int = 0, test_seed0: int = 100000,
                           log_every: int = 100) -> str:
    """Versioned, repo-shippable index: seeds + per-object grasp manifest.

    The OBJ-file index (export_proc_index) ships 18 MB of meshes; this
    variant ships ONLY the generator seeds plus a manifest of what the
    pipeline produced for each (verified grasp count, sphere count,
    family), pinned to `mesh_import.PACKING_VERSION`. Because
    random_proc_mesh is deterministic in the seed and the pipeline is
    deterministic in (mesh, PACKING_VERSION), a fresh clone rebuilds the
    identical library from this JSON alone -- the analogue of checking
    in the reference's filter_shapenet.json (reference:
    experiments/object_index/filter_shapenet.json, 1216 train objects)
    without shipping ShapeNet itself.
    """
    import json
    import time

    from gaddpg_tpu_torch.data.mesh_import import PACKING_VERSION

    t0 = time.time()
    idx = {
        "format": "proc_seed_index",
        "packing_version": PACKING_VERSION,
        "generator": "gaddpg_tpu_torch.data.procgen.random_proc_mesh",
        "train": [],
        "test": [],
    }
    skipped = 0
    for split, n, s0 in (("train", n_train, seed0),
                         ("test", n_test, test_seed0)):
        seed, made, attempts = s0, 0, 0
        while made < n and attempts < 3 * n:
            entry, name = proc_entry(seed)
            _, fam = random_proc_mesh(seed)
            cur = seed
            seed += 1
            attempts += 1
            if entry["grasps"] is None or len(entry["grasps"]) == 0:
                skipped += 1
                continue
            idx[split].append({
                "name": name, "seed": cur, "family": fam,
                "grasps": int(len(entry["grasps"])),
                "spheres": int(len(entry["spheres"])),
            })
            made += 1
            if log_every and (made % log_every == 0):
                print(f"[proc_seed_index] {split} {made}/{n} "
                      f"({time.time() - t0:.0f}s)", flush=True)
        # record requested vs produced: the 3n attempt budget can run out
        # on grasp-poor seed ranges, and a silently short index would make
        # library_from_seed_index build a smaller library than advertised
        idx[f"requested_{split}"] = int(n)
        idx[f"produced_{split}"] = int(made)
        if made < n:
            print(f"[proc_seed_index] WARNING: {split} produced only "
                  f"{made}/{n} entries after {attempts} attempts "
                  f"({skipped} grasp-free seeds skipped)",
                  file=sys.stderr, flush=True)
    idx["skipped"] = skipped
    idx["gen_seconds"] = round(time.time() - t0, 1)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(idx, f, indent=0)
    return out_path


SEED_INDEX_FORMAT = "proc_seed_index"


def reproduces_manifest(want: int, built: int, uncertain=None) -> bool:
    """The manifest rule's verdict on one object: its built grasp count
    equals the manifest's `want`, or differs by no more than the number
    of its labels on the rig's own rounding (`uncertain`, (G,) bool, from
    `mesh_import.uncertain_labels`; None when not measured)."""
    if built == want:
        return True
    return uncertain is not None and abs(built - want) <= int(np.sum(uncertain))


def library_from_seed_index(path: str, split: str = "train", report=None):
    """proc_seed_index JSON -> ObjectLibrary (cached beside the JSON as
    `envs.assets.library_cache_path` names it).

    Reads the JAX package's seed indexes as well as the port's: the
    `format` key and `packing_version` decide, not the `generator`
    string. Refuses a PACKING_VERSION mismatch (ValueError): the
    manifest's grasp counts were produced by that pipeline version, so a
    rebuild under another packing would ship unvalidated assets.

    The manifest rule. Each object's name must match the manifest's
    exactly. Its grasp count is a count of threshold tests on a contact
    simulation (`mesh_import.verify_grasps_physics`: a grasp is kept if
    the object moves less than 8 mm), and contact at the edge of slipping
    is chaotic: moving every sphere centre by one ulp flips 3 of 748
    labels on procedural seeds 0-11 in the JAX package's own rig, moving
    an object by up to 4.28 m. The port computes the rig in other float32
    rounding, so its count on such an object can differ from a manifest
    the JAX package wrote. An object whose count differs is verified
    twice more, with its sphere centres moved one ulp up and one ulp down,
    and accepted only if the difference is no larger than the number of
    its labels on the rig's own rounding (`mesh_import.uncertain_labels`:
    a label that flips across the three runs, or whose displacement lies
    within 8 times its spread over them of the threshold). The accepted
    ones are reported on stderr. Anything else raises RuntimeError: the
    build does not reproduce the manifest (non-determinism or a pipeline
    change without a bump).

    `report`, a list, receives one dict per object: name, seed, the
    manifest's and the built grasp count, the rig's displacements
    (`disp`, (G,) over the candidates) and, for an object off the
    manifest, its `uncertain` labels ((G,) bool; None otherwise).
    """
    import json

    from gaddpg_tpu_torch.data.mesh_import import (
        DISP_TOL, PACKING_VERSION, extend_library, grasp_displacements, uncertain_labels,
    )
    from gaddpg_tpu_torch.envs.assets import (
        cached_library, empty_library, library_cache_path, save_library,
    )

    with open(path) as f:
        idx = json.load(f)
    if idx.get("format") != SEED_INDEX_FORMAT:
        raise ValueError(f"{path}: not a proc_seed_index JSON")
    if int(idx["packing_version"]) != PACKING_VERSION:
        raise ValueError(
            f"{path}: built with packing_version={idx['packing_version']}, "
            f"pipeline is v{PACKING_VERSION} -- regenerate the index "
            f"(experiments/scripts/gen_proc_shapenet.py --seed-index)"
        )
    lib = cached_library(path, split)
    if lib is not None:
        return lib

    def refuse(drift):
        raise RuntimeError(
            f"{path}: {len(drift)} objects do not reproduce the manifest "
            f"(first: {drift[0]}); pipeline changed without a "
            f"PACKING_VERSION bump?"
        )

    built = [proc_entry(int(e["seed"]), verify=False) for e in idx[split]]
    drift = [(e["name"], e["grasps"], name, None)
             for e, (_, name) in zip(idx[split], built) if name != e["name"]]
    if drift:
        refuse(drift)
    entries, names, excused = [], [], []
    for e, (entry, name) in zip(idx[split], built):
        cand, want = entry["grasps"], int(e["grasps"])
        disp = held = uncertain = None
        if cand is not None and len(cand):
            disp = grasp_displacements(entry["spheres"], entry["mass"], entry["inertia"], cand)
            held = disp < DISP_TOL
        ng = 0 if held is None else int(held.sum())
        if ng != want:
            if held is not None:
                uncertain = uncertain_labels(entry["spheres"], entry["mass"], entry["inertia"],
                                             cand, disp)
            if reproduces_manifest(want, ng, uncertain):
                excused.append((name, want, ng, int(uncertain.sum())))
            else:
                drift.append((e["name"], want, name, ng))
        if report is not None:
            report.append({"name": name, "seed": int(e["seed"]), "manifest": want, "built": ng,
                           "disp": disp, "uncertain": uncertain})
        if ng == 0:
            continue
        entry["grasps"] = cand[held]
        entries.append(entry)
        names.append(name)
    if drift:
        refuse(drift)
    if excused:
        print(f"[proc_seed_index] {path} {split}: {len(excused)} of {len(idx[split])} objects "
              "off the manifest by no more than their labels on the rig's rounding "
              "(name, manifest, built, uncertain): " + ", ".join(map(str, excused)),
              file=sys.stderr, flush=True)
    lib = extend_library(empty_library(), entries, names)
    try:
        save_library(lib, library_cache_path(path, split))
    except OSError:
        pass
    return lib
