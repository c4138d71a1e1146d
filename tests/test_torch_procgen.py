"""The port's procedural objects and mesh pipeline against the JAX
package (gaddpg_tpu/data/procgen.py, mesh_native.py, mesh_import.py,
envs/assets.py's library files).

Everything before the grasp verification is numpy in both packages, so
it must be equal bit for bit: the triangles of `random_proc_mesh`, the
native library's sphere packing against its numpy version, and
`asset_from_mesh(verify=False)` (spheres, surface, extents, mass,
inertia, grasp candidates, rest height). The padded library
(`extend_library`) and its `.npz` files are equal too, and a file the
JAX package saved loads in the port. The grasp verification, which runs
the contact physics, is held in tests/test_torch_grasp_verify.py.

The file round trips of tests/test_procgen.py (OBJ files, the mesh index
and the seed index) run the port's own pipeline end to end; there the
rig is cut to 10 + 30 substeps (`short_rig`), since what they hold is the
plumbing, not the labels.
"""

import json
import os

import numpy as np
import pytest
import torch

from gaddpg_tpu.data import mesh_import as jmi
from gaddpg_tpu.data import procgen as jprocgen
from gaddpg_tpu.envs import assets as jassets
from gaddpg_tpu_torch.data import mesh_import, mesh_native, procgen
from gaddpg_tpu_torch.envs import assets
from torch_grasp_common import cut_rig

ASSET_FIELDS = ("spheres", "surface", "extents", "inertia", "grasps")


@pytest.fixture(scope="module")
def entries():
    """asset_from_mesh(verify=False) of seeds 0-2 in both packages."""
    out = {}
    for seed in range(3):
        tris, _ = procgen.random_proc_mesh(seed)
        out[seed] = (mesh_import.asset_from_mesh(tris, seed=seed, verify=False),
                     jmi.asset_from_mesh(tris, seed=seed, verify=False))
    return out


@pytest.fixture
def short_rig(monkeypatch):
    cut_rig(monkeypatch)


@pytest.mark.parametrize("seed", range(6))
def test_proc_mesh_triangles_equal(seed):
    tris, fam = procgen.random_proc_mesh(seed)
    jtris, jfam = jprocgen.random_proc_mesh(seed)
    assert fam == jfam
    assert tris.dtype == jtris.dtype == np.float32
    np.testing.assert_array_equal(tris, jtris)


@pytest.mark.parametrize("seed", (0, 1, 7))
def test_sphere_pack_native_matches_numpy(seed):
    """The native packing and its numpy version give the same spheres
    (tests/test_procgen.py's parity, on the port's bindings)."""
    if not mesh_native.native_available():
        pytest.skip("native/libmesh_tools.so could not be built on this host")
    tris, _ = procgen.random_proc_mesh(seed)
    lo = tris.reshape(-1, 3).min(0) - 1e-3
    hi = tris.reshape(-1, 3).max(0) + 1e-3
    occ = mesh_native.voxel_occupancy(tris, lo, hi, 20)
    dist = mesh_native.surface_distance_grid(tris, lo, hi, 20)
    a = mesh_native.sphere_pack(occ, dist, lo, hi, 16, 1e-3)
    b = mesh_native._sphere_pack_numpy(occ, dist, lo, hi, 16, 1e-3)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("seed", range(3))
def test_asset_from_mesh_matches_jax(entries, seed):
    port, ref = entries[seed]
    for k in ASSET_FIELDS:
        assert port[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    assert port["mass"] == ref["mass"] and port["rest_height"] == ref["rest_height"]


def _library_arrays(lib):
    return {k: np.asarray(getattr(lib, k)) for k in assets.LIBRARY_FIELDS}


def test_extend_save_load_round_trips(entries, tmp_path):
    """extend_library equal to JAX's; the port's file loads back equal;
    a file the JAX package saved loads in the port equal to it."""
    ports = [entries[s][0] for s in entries]
    refs = [entries[s][1] for s in entries]
    names = [f"proc_{s}" for s in entries]
    lib = mesh_import.extend_library(assets.empty_library(), ports, names)
    jlib = jmi.extend_library(jassets.empty_library(), refs, names)
    assert lib.names == jlib.names == names
    want = _library_arrays(jlib)
    for k, v in _library_arrays(lib).items():
        assert v.dtype == want[k].dtype, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    # appending to a built library keeps its rows
    more = mesh_import.extend_library(lib, ports[:1], ["again"])
    assert more.names == names + ["again"]
    np.testing.assert_array_equal(more.spheres[:3].numpy(), lib.spheres.numpy())

    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    assets.save_library(lib, mine)
    jassets.save_library(jlib, theirs)
    for path in (mine, theirs):
        back = assets.load_library(path)
        assert back.names == names
        for k, v in _library_arrays(back).items():
            assert v.dtype == want[k].dtype, (path, k)
            np.testing.assert_array_equal(v, want[k], err_msg=f"{path} {k}")


def test_obj_round_trip(tmp_path):
    """write_obj writes the JAX package's file; load_obj reads it back as
    the JAX package does."""
    tris, _ = procgen.random_proc_mesh(0)
    mine, theirs = str(tmp_path / "port.obj"), str(tmp_path / "jax.obj")
    procgen.write_obj(mine, tris)
    jprocgen.write_obj(theirs, tris)
    with open(mine) as a, open(theirs) as b:
        assert a.read() == b.read()
    back = mesh_import.load_obj(mine)
    np.testing.assert_array_equal(back, jmi.load_obj(theirs))
    assert back.shape == tris.shape
    v1 = np.unique(np.round(tris.reshape(-1, 3), 5), axis=0)
    v2 = np.unique(np.round(back.reshape(-1, 3), 5), axis=0)
    np.testing.assert_allclose(v1, v2, atol=1e-4)


def test_mesh_index_round_trip(tmp_path, short_rig):
    """export_proc_index -> library_from_index: the file-based flow
    builds the objects build_proc_library builds for the same seeds, and
    caches them."""
    idx = procgen.export_proc_index(str(tmp_path), 2, 1, seed0=0)
    lib = assets.library_from_index(idx, split="train")
    assert lib.names == procgen.build_proc_library(2, seed0=0).names
    assert bool(lib.grasp_valid.any(dim=1).all())
    assert os.path.exists(assets.library_cache_path(idx, "train"))


def test_seed_index_round_trip(tmp_path, short_rig):
    """export_proc_seed_index -> library_from_index: the port's index
    names the port's generator, rebuilds the same objects, and a
    packing_version mismatch refuses to build."""
    p = str(tmp_path / "idx.json")
    procgen.export_proc_seed_index(p, 2, 1, seed0=0, log_every=0)
    with open(p) as f:
        idx = json.load(f)
    assert idx["format"] == "proc_seed_index"
    assert idx["generator"] == "gaddpg_tpu_torch.data.procgen.random_proc_mesh"
    assert idx["packing_version"] == mesh_import.PACKING_VERSION
    assert len(idx["train"]) == 2 and len(idx["test"]) == 1
    assert all(e["grasps"] > 0 for e in idx["train"] + idx["test"])
    lib = assets.library_from_index(p, split="train")
    assert lib.names == [e["name"] for e in idx["train"]]
    assert lib.grasp_valid.sum(dim=1).tolist() == [e["grasps"] for e in idx["train"]]
    assert os.path.exists(assets.library_cache_path(p, "train"))
    idx["packing_version"] = 999
    with open(p, "w") as f:
        json.dump(idx, f)
    with pytest.raises(ValueError, match="packing_version"):
        assets.library_from_index(p, split="train")


def test_library_lives_on_the_cpu_until_moved(entries):
    lib = mesh_import.extend_library(assets.empty_library(), [entries[0][0]], ["a"])
    assert lib.spheres.device == torch.device("cpu") and lib.grasp_valid.dtype == torch.bool
