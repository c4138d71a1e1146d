"""The port's mesh-index loader (counterpart of
gaddpg_tpu/envs/assets.py:450-586): `library_from_mesh_index` from an OBJ
file and a JSON grasp file, its cache keyed on PACKING_VERSION under the
port's own name, and the index format read from the JSON's `format` key
wherever it stands (not from a prefix of the file).

The grasp file's grasps carry their own labels and get only the
geometric pad-squeeze check (no contact rig), so these builds are cheap;
the OBJ-only object runs the rig's verification at 10 + 30 substeps
(`short_rig`), since what this file holds is the loader.
"""

import json
import os

import numpy as np
import pytest
import torch

from gaddpg_tpu.data import grasp_files as jgrasp_files
from gaddpg_tpu.data import mesh_import as jmi
from gaddpg_tpu_torch.data import grasp_files, mesh_import, procgen
from gaddpg_tpu_torch.envs import assets
from torch_grasp_common import cut_rig


@pytest.fixture
def short_rig(monkeypatch):
    cut_rig(monkeypatch)


def _grasp_json(path, n=12):
    """A 6dof-graspnet style JSON: the JAX pipeline's candidates of seed
    1 in the graspnet frame (closing point 0.1034 m along +z), with flex
    qualities of which some are below the threshold."""
    tris, _ = procgen.random_proc_mesh(1)
    cand = jmi.asset_from_mesh(tris, seed=1, verify=False)["grasps"][:n].astype(np.float64)
    shift = np.eye(4)
    shift[2, 3] = -(grasp_files.GRASPNET_CLOSING_Z - grasp_files.OUR_CLOSING_Z)
    quality = np.linspace(0.0, 1.0, n)
    with open(path, "w") as f:
        json.dump({"object": "m.obj", "object_scale": 1.0,
                   "transforms": (cand @ shift).tolist(),
                   "quality_flex_object_in_gripper": quality.tolist()}, f)
    return quality


@pytest.fixture
def mesh_index(tmp_path):
    """An index of two objects: an OBJ with a grasp file, and an OBJ
    alone."""
    for seed in (1, 2):
        procgen.write_obj(str(tmp_path / f"m{seed}.obj"), procgen.random_proc_mesh(seed)[0])
    _grasp_json(tmp_path / "g1.json")
    idx = {"train": [{"name": "with_grasps", "obj": "m1.obj", "grasps": "g1.json"},
                     {"name": "mesh_only", "obj": "m2.obj", "mass": 0.3}],
           "test": []}
    path = tmp_path / "index.json"
    path.write_text(json.dumps(idx))
    return str(path)


def test_read_grasp_file_matches_jax(tmp_path):
    quality = _grasp_json(tmp_path / "g.json")
    got = grasp_files.read_grasp_file(str(tmp_path / "g.json"))
    want = jgrasp_files.read_grasp_file(str(tmp_path / "g.json"))
    for k in ("transforms", "positive", "qualities", "mean"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["object_path"] == want["object_path"] and got["scale"] == want["scale"]
    np.testing.assert_array_equal(got["positive"], quality > 0.01)


def test_library_from_mesh_index(mesh_index, short_rig):
    lib = assets.library_from_index(mesh_index, "train")
    assert lib.names == ["with_grasps", "mesh_only"]
    assert bool(lib.grasp_valid.any(dim=1).all())
    assert abs(float(lib.mass[1]) - 0.3) < 1e-7
    # the grasp file's object: its positives through the pad-squeeze
    # filter only, as the JAX loader builds it
    tris = jmi.load_obj(os.path.join(os.path.dirname(mesh_index), "m1.obj"))
    g = jgrasp_files.read_grasp_file(os.path.join(os.path.dirname(mesh_index), "g1.json"))
    want = jmi.asset_from_mesh(tris, grasps=g["transforms"][g["positive"]])
    n = len(want["grasps"])
    assert int(lib.grasp_valid[0].sum()) == n
    np.testing.assert_array_equal(lib.grasps[0, :n].numpy(), want["grasps"])
    np.testing.assert_array_equal(lib.spheres[0, :len(want["spheres"])].numpy(), want["spheres"])


def test_mesh_index_cache_keyed_on_packing_version(mesh_index, short_rig, monkeypatch):
    lib = assets.library_from_index(mesh_index, "train")
    cache = assets.library_cache_path(mesh_index, "train")
    assert cache == f"{mesh_index}.train.v{mesh_import.PACKING_VERSION}.torch.libcache.npz"
    assert os.path.exists(cache)
    # the JAX package's cache name is never the port's
    assert not os.path.exists(f"{mesh_index}.train.v{mesh_import.PACKING_VERSION}.libcache.npz")
    # a second call reads the cache: no object is built
    monkeypatch.setattr(mesh_import, "asset_from_mesh", None)
    again = assets.library_from_index(mesh_index, "train")
    assert again.names == lib.names
    np.testing.assert_array_equal(again.grasp_valid.numpy(), lib.grasp_valid.numpy())
    # another pipeline version is another cache
    monkeypatch.setattr(mesh_import, "PACKING_VERSION", mesh_import.PACKING_VERSION + 1)
    assert assets.library_cache_path(mesh_index, "train") != cache
    with pytest.raises(TypeError):  # not cached: it would build (asset_from_mesh is gone)
        assets.library_from_index(mesh_index, "train")


def test_index_format_from_the_json(tmp_path):
    """A seed index whose `format` key is not first, behind more than 2 KB
    of other keys, is read as a seed index (its packing version refusal
    shows the seed-index loader took it); a mesh index is not."""
    seed_idx = {"train": [{"name": f"proc_x_{i:04d}", "seed": i, "grasps": 1} for i in range(200)],
                "test": [], "generator": "elsewhere", "packing_version": 999,
                "format": "proc_seed_index"}
    p = tmp_path / "seed.json"
    p.write_text(json.dumps(seed_idx))
    assert p.read_text().find('"format"') > 2048
    assert assets.index_format(str(p)) == "proc_seed_index"
    with pytest.raises(ValueError, match="packing_version=999"):
        assets.library_from_index(str(p), "train")
    q = tmp_path / "mesh.json"
    q.write_text(json.dumps({"train": [], "test": []}))
    assert assets.index_format(str(q)) is None
    r = tmp_path / "list.json"
    r.write_text(json.dumps([]))
    assert assets.index_format(str(r)) is None
    with pytest.raises(ValueError, match="unknown object index"):
        assets.library_from_index(str(tmp_path / "missing.json"))


def test_verify_library_grasps_masks_failures(monkeypatch):
    """verify_library_grasps keeps a grasp where the rig holds it and an
    object's whole analytic set where no grasp survives, as the JAX
    package's does (gaddpg_tpu/envs/assets.py:414-447); the rig here is a
    stand-in that moves every other grasp of object 0 and every grasp of
    object 1 past the threshold."""
    lib = assets.build_library([assets.AssetSpec("box", "box", (0.05, 0.05, 0.1), 0.2),
                                assets.AssetSpec("cyl", "cylinder", (0.03, 0.1), 0.3)])
    seen = []

    def rig(objects, close_substeps=None, hold_substeps=None, params=None):
        seen.append(params)
        ((_, mass, _, grasps),) = objects
        moved = np.zeros(len(grasps), np.float32)
        moved[1::2] = 1.0
        return [moved if mass < 0.25 else np.ones(len(grasps), np.float32)]

    monkeypatch.setattr(mesh_import, "rig_displacements", rig)
    out = assets.verify_library_grasps(lib, params="env params")
    gv, new = lib.grasp_valid.numpy(), out.grasp_valid.numpy()
    np.testing.assert_array_equal(new[0], gv[0] & (np.arange(gv.shape[1]) % 2 == 0))
    np.testing.assert_array_equal(new[1], gv[1])
    assert seen == ["env params", "env params"]
    assert out.names == lib.names and torch.equal(out.grasps, lib.grasps)
