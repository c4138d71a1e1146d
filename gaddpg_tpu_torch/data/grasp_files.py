"""External grasp-dataset ingestion: 6dof-graspnet JSON + ACRONYM h5
(counterpart of gaddpg_tpu/data/grasp_files.py).

Covers the reference's grasp-data reading path
(reference: misc/grasp_data_reader.py:607-700 read_object_grasp_data):
JSON dicts carrying 'object'/'object_scale'/'transforms' and flex
quality labels, and the ACRONYM h5 layout ('grasps/transforms',
'grasps/qualities/flex/object_in_gripper', 'object/file',
'object/scale'). Grasps are quality-filtered, mean-centered like the
reference, converted to the hand-frame convention of envs/assets
(closing point at GRASP_DEPTH along +z) and validated against the
packed sphere set before entering the object library.
"""

import json
import os
from typing import Optional

import numpy as np

# 6dof-graspnet / ACRONYM panda gripper: closing point sits 0.1034 m
# along +z of the grasp frame; our hand frame puts it at GRASP_DEPTH
# (envs/assets.py). The difference is a fixed z-offset.
GRASPNET_CLOSING_Z = 0.1034
OUR_CLOSING_Z = 0.10


def _convert_frames(transforms: np.ndarray) -> np.ndarray:
    """Graspnet/ACRONYM grasp frames -> our hand-frame convention."""
    offset = GRASPNET_CLOSING_Z - OUR_CLOSING_Z
    shift = np.eye(4, dtype=np.float32)
    shift[2, 3] = offset
    return (transforms @ shift[None]).astype(np.float32)


def read_grasp_file(path: str, quality_threshold: float = 0.01,
                    center: bool = True):
    """Read a grasp dataset file (json or h5).

    Returns dict(transforms (G,4,4) our convention, positive (G,) bool,
    qualities (G,), object_path, scale, mean (3,)).
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".json":
        with open(path) as f:
            d = json.load(f)
        transforms = np.asarray(d["transforms"], np.float64)
        flex = np.asarray(
            d.get("quality_flex_object_in_gripper",
                  d.get("quality", np.ones(len(transforms))))
        )
        contacts = np.asarray(
            d.get("quality_number_of_contacts", np.ones(len(transforms)))
        )
        obj_path = d.get("object", "")
        scale = float(d.get("object_scale", 1.0))
    elif ext in (".h5", ".hdf5"):
        import h5py  # only for ACRONYM files

        with h5py.File(path, "r") as f:
            transforms = np.asarray(f["grasps/transforms"], np.float64)
            try:
                flex = np.asarray(
                    f["grasps/qualities/flex/object_in_gripper"]
                )
            except KeyError:
                flex = np.ones(len(transforms))
            contacts = np.ones(len(transforms))
            obj_path = (
                f["object/file"][()].decode()
                if "object/file" in f else ""
            )
            scale = float(f["object/scale"][()]) if "object/scale" in f else 1.0
    else:
        raise ValueError(f"unsupported grasp file {path}")

    mean = np.zeros(3)
    positive = (flex > quality_threshold) & (contacts > quality_threshold)
    return {
        "transforms": _convert_frames(transforms),
        "positive": positive,
        "qualities": np.asarray(flex, np.float32),
        "object_path": obj_path,
        "scale": scale,
        "mean": mean,
    }


def entry_from_grasp_file(grasp_path: str, mesh_tris: Optional[np.ndarray] = None,
                          mesh_root: Optional[str] = None,
                          mass: Optional[float] = None, res: int = 24,
                          max_grasps: int = 64, seed: int = 0):
    """Grasp file + mesh -> ObjectLibrary entry (see mesh_import).

    `mesh_tris` overrides loading the mesh referenced by the file
    (ACRONYM object paths are dataset-rooted; pass `mesh_root` to
    resolve them). Positive grasps only, mean-centered with the mesh
    like the reference (reference: misc/grasp_data_reader.py:650-657).
    """
    from gaddpg_tpu_torch.data.mesh_import import asset_from_mesh, load_obj

    g = read_grasp_file(grasp_path)
    if mesh_tris is None:
        p = g["object_path"]
        if mesh_root is not None:
            p = os.path.join(mesh_root, p)
        mesh_tris = load_obj(p, scale=g["scale"])
    mean = mesh_tris.reshape(-1, 3).mean(axis=0)
    tris = mesh_tris - mean
    grasps = g["transforms"][g["positive"]][:max_grasps].copy()
    grasps[:, :3, 3] -= mean
    return asset_from_mesh(
        tris, mass=mass, res=res,
        grasps=grasps if len(grasps) else None, seed=seed,
    )
