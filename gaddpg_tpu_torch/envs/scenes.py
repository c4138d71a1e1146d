"""Deterministic evaluation scenes: generate, save, load (counterpart of
gaddpg_tpu/envs/scenes.py).

The reference evaluates on pre-generated `scene_{k}.mat` files holding
the object placement and the initial joints (reference:
core/train_test_offline.py:176-256, env/panda_scene.py:336-343,
experiments/config.py:62 RL_TEST_SCENE). Here a scene set is one .npz of
stacked scene dicts, in the JAX package's layout, so that either
package loads the other's files; `import_mat_scene` reads the
reference's .mat layout.
"""

import os
from typing import Dict, Optional

import numpy as np
import torch

FIELDS = ("obj_idx", "obj_pos", "obj_quat", "joints", "ik_ok",
          "clutter_idx", "clutter_pos", "clutter_quat")


def generate_scenes(env, num_scenes: int, oversample: int = 2, generator=None) -> Dict:
    """Sample `num_scenes` valid scenes with the env's reset logic:
    `oversample * num_scenes` candidates in one batched `sample_scene` and
    `reset_scene`, the valid ones kept first (the reference retries per
    scene, reference: core/train_online.py:180-188). Returns a dict of
    numpy arrays with FIELDS' keys."""
    scenes = env.sample_scene(num_scenes * oversample, generator)
    states, _ = env.reset_scene(scenes, generator)
    valid = states.valid_scene.cpu().numpy()
    idx = np.concatenate([np.nonzero(valid)[0], np.nonzero(~valid)[0]])[:num_scenes]
    return {k: v.cpu().numpy()[idx] for k, v in scenes.items()}


def save_scenes(scenes: Dict, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: np.asarray(v) for k, v in scenes.items()})


def load_scenes(path: str) -> Dict:
    """A scene set saved by either package: a dict of CPU tensors."""
    data = np.load(path)
    return {k: torch.as_tensor(data[k]) for k in FIELDS if k in data}


def scene_slice(scenes: Dict, start: int, count: int) -> Dict:
    """`count` scenes from `start`, wrapping around, so that any
    evaluation wave size works."""
    n = len(scenes["obj_idx"])
    idx = torch.arange(start, start + count) % n
    return {k: torch.as_tensor(np.asarray(v))[idx] for k, v in scenes.items()}


def _mat_paths_to_names(path_arr) -> list:
    """The reference's `path` entries are object directories like
    'data/objects/025_mug/' (env/panda_scene.py:642-659: the target's name
    is the last path component). loadmat yields a padded char matrix or an
    object array of str: both give the names."""
    names = []
    for e in np.atleast_1d(np.asarray(path_arr)).reshape(-1):
        # cell arrays load as object elements wrapping a string array
        sub = np.atleast_1d(np.asarray(e))
        s = (str(sub.reshape(-1)[0]) if sub.size else "").strip().rstrip("/")
        if s:
            names.append(s.split("/")[-1])
    return names


def import_mat_scene(path: str, name_to_idx: Optional[dict] = None) -> Dict:
    """A reference scene_{k}.mat as a one-scene dict.

    The reference layout (env/panda_scene.py:628-668,
    core/train_test_offline.py:181-184): `pose` an (N, 4, 4) stack of
    object poses, `path` the object mesh directories with the target
    first, optional `init_joints`. The quaternion (wxyz) comes from the
    rotation matrix. Flat [t(3), q(4)] poses and joints under other key
    names are accepted too."""
    from scipy.io import loadmat

    from gaddpg_tpu_torch.geometry.rotations import mat_to_quat
    from gaddpg_tpu_torch.robot.panda import DEFAULT_JOINTS

    m = loadmat(path)
    joints = next((np.asarray(m[k], np.float64).reshape(-1)[:7]
                   for k in ("init_joints", "joints", "arm_joints", "robot_joints") if k in m),
                  None)
    if joints is None:
        # the reference falls back to its default start without init_joints
        # (env/panda_scene.py:666-667)
        joints = DEFAULT_JOINTS[:7]
    pose = next((np.asarray(m[k], np.float64)
                 for k in ("pose", "obj_poses", "object_poses", "poses") if k in m), None)
    if pose is None:
        raise ValueError(f"unrecognized scene file {path}: keys {sorted(m.keys())}")

    if pose.ndim >= 2 and pose.shape[-2:] == (4, 4):
        t_pose = pose.reshape(-1, 4, 4)[0]                 # the target's placement
        obj_pos = t_pose[:3, 3]
        obj_quat = mat_to_quat(torch.as_tensor(t_pose[:3, :3], dtype=torch.float32)).numpy()
    else:
        flat = pose.reshape(-1)[:7]                        # [t(3), q(4)]
        obj_pos, obj_quat = flat[:3], flat[3:7]

    target_name = None
    if "path" in m:
        names = _mat_paths_to_names(m["path"])
        target_name = names[0] if names else None
    elif "target_name" in m:
        target_name = str(np.asarray(m["target_name"]).reshape(-1)[0])
    obj_idx = name_to_idx.get(target_name, 0) if name_to_idx and target_name is not None else 0
    return {
        "obj_idx": np.asarray([obj_idx], np.int32),
        "obj_pos": np.asarray(obj_pos)[None].astype(np.float32),
        "obj_quat": np.asarray(obj_quat)[None].astype(np.float32),
        "joints": np.asarray(joints)[None].astype(np.float32),
        "ik_ok": np.asarray([True]),
    }
