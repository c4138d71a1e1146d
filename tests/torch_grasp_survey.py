"""Survey of the grasp rig's labels, the port against the JAX package, on
procedural seeds (the measurements behind ROADMAP.md Queue 3 (l) and
`data/mesh_import.uncertain_labels`). Runs on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_grasp_survey.py --seeds 0-29
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_grasp_survey.py --timing

For each seed: the object's candidates (equal in both packages), each
package's displacements over three runs (the sphere centres as built,
one ulp up, one ulp down), the labels each keeps, the labels that differ
between the packages, the labels either package's own reruns flip, each
differing label's margin to the threshold in units of the port's
one-ulp spread, the port's uncertain labels (margin within
UNCERTAIN_FACTOR spreads) and the port rig's seconds. A last line sums
them. --timing times the port's `library_from_index("proc_shapenet:4")`
(the build with the grasp rig, per object) and the rig over 100
substeps for 256 grasps on one intra-op thread and on torch's default
count.
"""

import argparse
import time

import numpy as np
import torch

from gaddpg_tpu.data import procgen as jprocgen
from gaddpg_tpu.data.mesh_import import asset_from_mesh as jax_asset_from_mesh
from gaddpg_tpu_torch.data import mesh_import, procgen
from torch_grasp_common import jax_displacements


def nudged(spheres):
    """The sphere set as built, with every centre one ulp up, one ulp down."""
    out = [spheres]
    for way in (np.inf, -np.inf):
        s = spheres.copy()
        s[:, :3] = np.nextafter(spheres[:, :3], np.float32(way))
        out.append(s)
    return out


def survey(seed):
    tol = mesh_import.DISP_TOL
    entry, name = procgen.proc_entry(seed, verify=False)
    ref = jax_asset_from_mesh(jprocgen.random_proc_mesh(seed)[0], seed=seed, verify=False)
    if entry["grasps"] is None:
        return None
    assert np.array_equal(entry["grasps"], ref["grasps"]), seed
    jd = np.stack([jax_displacements(s, ref["mass"], ref["inertia"], ref["grasps"])
                   for s in nudged(ref["spheres"])])
    t0 = time.perf_counter()
    pd = np.stack(mesh_import.rig_displacements(
        [(s, entry["mass"], entry["inertia"], entry["grasps"]) for s in nudged(entry["spheres"])]))
    secs = time.perf_counter() - t0
    jl, pl = jd[0] < tol, pd[0] < tol
    spread = pd.max(0) - pd.min(0)
    margin = np.abs(pd[0] - tol)
    differ = np.nonzero(jl != pl)[0]
    return {
        "seed": seed, "name": name, "grasps": len(pl), "jax": int(jl.sum()),
        "port": int(pl.sum()), "differ": differ.tolist(),
        "jax_flips": np.nonzero(((jd < tol) != jl).any(0))[0].tolist(),
        "port_flips": np.nonzero(((pd < tol) != pl).any(0))[0].tolist(),
        "spreads_off": [round(float(margin[i] / max(spread[i], 1e-12)), 2) for i in differ],
        "uncertain": int((margin <= mesh_import.UNCERTAIN_FACTOR * spread).sum()),
        "seconds_three_runs": round(secs, 1),
    }


def seeds_arg(text):
    lo, _, hi = text.partition("-")
    return range(int(lo), int(hi or lo) + 1)


def timing():
    from gaddpg_tpu_torch.envs.assets import library_from_index

    t0 = time.perf_counter()
    lib = library_from_index("proc_shapenet:4")
    secs = time.perf_counter() - t0
    print(f"library_from_index('proc_shapenet:4'): {secs:.1f} s, "
          f"{secs / lib.num_objects:.1f} s an object, grasps {lib.grasp_valid.sum(1).tolist()}")
    entry, _ = procgen.proc_entry(0, verify=False)
    objects = [(entry["spheres"], entry["mass"], entry["inertia"], entry["grasps"])] * 4
    t0 = time.perf_counter()
    one = np.concatenate(mesh_import.rig_displacements(objects, 50, 50))
    t_one = time.perf_counter() - t0
    set_threads = torch.set_num_threads
    torch.set_num_threads = lambda n: None  # the rig's pin, lifted
    try:
        t0 = time.perf_counter()
        many = np.concatenate(mesh_import.rig_displacements(objects, 50, 50))
        t_many = time.perf_counter() - t0
    finally:
        torch.set_num_threads = set_threads
    print(f"rig, 256 grasps x 100 substeps: one thread {t_one:.1f} s, "
          f"{torch.get_num_threads()} threads {t_many:.1f} s, equal bit for bit "
          f"{np.array_equal(one, many)}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=seeds_arg, default=seeds_arg("0-11"))
    ap.add_argument("--timing", action="store_true")
    args = ap.parse_args()
    if args.timing:
        timing()
        return
    rows = [r for r in map(survey, args.seeds) if r is not None]
    for r in rows:
        print(r, flush=True)
    print({"objects": len(rows), "grasps": sum(r["grasps"] for r in rows),
           "jax_flips": sum(len(r["jax_flips"]) for r in rows),
           "labels_differ": sum(len(r["differ"]) for r in rows),
           "covered_by_port_flips": sum(len(set(r["differ"]) & set(r["port_flips"]))
                                        for r in rows),
           "objects_off_by_count": sum(r["jax"] != r["port"] for r in rows),
           "largest_spreads_off": max((x for r in rows for x in r["spreads_off"]), default=0),
           "uncertain_mean": np.mean([r["uncertain"] for r in rows])})


if __name__ == "__main__":
    main()
