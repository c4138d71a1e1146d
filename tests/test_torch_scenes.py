"""Scene sets (envs/scenes.py) and the clutter train config, against the
JAX package's: the .npz layout both ways, the reference .mat import
(tests/test_data_scenes.py's files), the wrap-around slice, generated
scenes, `Trainer.evaluate(scenes=, expert=)` at the dryrun's sizes, and
experiments/cfgs/td3_clutter.yaml read by both packages' `load_config`.

Bounds: arrays loaded from a file equal bit for bit; imported poses and
joints within 1e-6 of the JAX import (the quaternion from the pose
matrix in float32 either way); config fields equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gaddpg_tpu.envs import assets as jassets
from gaddpg_tpu.envs import scenes as jscenes
from gaddpg_tpu.train import config as jax_config
from gaddpg_tpu_torch.envs import scenes
from gaddpg_tpu_torch.envs.assets import box_asset
from gaddpg_tpu_torch.envs.grasp_env import EnvParams, PandaGraspEnv
from gaddpg_tpu_torch.physics.types import PhysicsParams
from gaddpg_tpu_torch.render.camera import CameraParams
from gaddpg_tpu_torch.train import Trainer, load_config
from test_torch_clutter_env import clutter_params
from torch_env_common import make_envs
from torch_env_common import scenes as jax_sample

SEEDS = (0, 1, 2)


@pytest.fixture(scope="module")
def envs():
    return make_envs(jassets.library_from_index("ycb", "train"), clutter_params(True),
                     clutter_params())


def test_jax_scene_file_loads_in_the_port(envs, tmp_path):
    jenv, env = envs
    sc = jax_sample(jenv, SEEDS)
    path = str(tmp_path / "jax_scenes.npz")
    jscenes.save_scenes(sc, path)
    mine = scenes.load_scenes(path)
    assert set(mine) == set(scenes.FIELDS)
    for k in scenes.FIELDS:
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(sc[k]), err_msg=k)
    state, obs = env.reset_scene(mine, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(state.clutter_idx.numpy(), sc["clutter_idx"])
    assert obs.point_state.shape == (len(SEEDS), 4, 64)
    # and the port's file loads in the JAX package
    path2 = str(tmp_path / "port_scenes.npz")
    scenes.save_scenes(env.sample_scene(3, torch.Generator().manual_seed(1)), path2)
    theirs = jscenes.load_scenes(path2)
    assert set(theirs) == set(scenes.FIELDS)
    for k, v in scenes.load_scenes(path2).items():
        np.testing.assert_array_equal(np.asarray(theirs[k]), v.numpy(), err_msg=k)


def test_scene_slice_wraps_as_jax(envs):
    sc = jax_sample(envs[0], SEEDS)
    for start, count in ((0, 2), (2, 4), (5, 7)):
        got, want = scenes.scene_slice(sc, start, count), jscenes.scene_slice(sc, start, count)
        for k in sc:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _mat_files(tmp_path):
    """tests/test_data_scenes.py's .mat files: a flat pose with named
    target, the reference layout (pose matrices, object paths target
    first, init_joints), the same without init_joints, and obj_poses."""
    from scipy.io import savemat

    rot_z90 = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    poses = np.tile(np.eye(4), (3, 1, 1))
    poses[0, :3, :3] = rot_z90
    poses[0, :3, 3] = [0.58, -0.04, 0.06]
    paths = np.array(["data/objects/025_mug/", "data/objects/Table/", "data/objects/floor/"],
                     dtype=object)
    files = {
        "flat": {"pose": np.array([0.55, 0.05, 0.06, 1.0, 0.0, 0.0, 0.0], np.float32),
                 "joints": np.array([0.0, -1.2, 0.0, -2.6, 0.0, 1.7, 0.8], np.float32),
                 "target_name": "proxy_box"},
        "reference": {"pose": poses, "path": paths,
                      "init_joints": np.array([0.1, -1.0, 0.0, -2.4, 0.0, 1.6, 0.7])},
        "no_joints": {"pose": poses, "path": np.array(["data/objects/x/"], dtype=object)},
        "obj_poses": {"obj_poses": np.array([0.55, 0.0, 0.07, 1.0, 0, 0, 0], np.float32),
                      "init_joints": np.array([0.0, -0.8, 0.0, -2.2, 0.0, 1.6, 0.8],
                                              np.float32)},
    }
    out = {}
    for name, content in files.items():
        path = str(tmp_path / f"scene_{name}.mat")
        savemat(path, content)
        out[name] = path
    return out


def test_import_mat_scene_matches_jax(tmp_path):
    names = {"proxy_box": 3, "025_mug": 5}
    for name, path in _mat_files(tmp_path).items():
        got = scenes.import_mat_scene(path, name_to_idx=names)
        want = jscenes.import_mat_scene(path, name_to_idx=names)
        assert set(got) == set(want)
        for k in want:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.shape == w.shape and g.dtype == w.dtype, (name, k)
            np.testing.assert_allclose(g, w, atol=1e-6, err_msg=f"{name} {k}")
    ref = scenes.import_mat_scene(_mat_files(tmp_path)["reference"], name_to_idx=names)
    assert int(ref["obj_idx"][0]) == 5
    half = np.sqrt(0.5)
    np.testing.assert_allclose(np.abs(ref["obj_quat"][0]), [half, 0, 0, half], atol=1e-6)


def test_imported_scene_resets_the_env(tmp_path):
    env = PandaGraspEnv(EnvParams(use_planner=False), box_asset(0.05, 0.05, 0.14), device="cpu")
    for name in ("reference", "obj_poses"):
        scene = scenes.import_mat_scene(_mat_files(tmp_path)[name], name_to_idx={"025_mug": 0})
        scene["obj_pos"][0, 2] = 0.07                    # on the table
        state, obs = env.reset_scene(scene, torch.Generator().manual_seed(0))
        assert obs.point_state.shape == (1, 4, 1030)
        assert abs(float(state.phys.obj.pos[0, 0]) - float(scene["obj_pos"][0, 0])) < 0.02


def dryrun_trainer(tmp_path, num_clutter):
    """A Trainer at the dryrun's sizes (`__graft_entry__.py:146-152`), the
    goal servo, 4 envs."""
    env_p = EnvParams(physics=PhysicsParams(substeps=10), camera=CameraParams(width=32, height=32),
                      uniform_num_pts=58, pc_capacity=128, new_points_per_step=32,
                      clutter_points_per_step=16, settle_substeps=20, max_steps=3,
                      reset_tries=2, retract_lift_steps=2, use_planner=False,
                      num_clutter=num_clutter)
    cfg = dataclasses.replace(load_config(overrides={
        "num_envs": 4, "max_steps": 3, "extend_steps": 1, "batch_size": 4,
        "updates_per_iter": 1, "buffer_size": 32, "output_dir": str(tmp_path)},
        policy="DDPG"), env=env_p)
    return Trainer(cfg, lib=box_asset(0.06, 0.06, 0.14), device="cpu")


@pytest.mark.parametrize("num_clutter", [0, 2])
def test_trainer_evaluate_on_scene_sets(tmp_path, num_clutter):
    """generate_scenes -> Trainer.evaluate(scenes=) by policy and expert:
    the scene set's validity holds on every wave (the waves wrap around
    the set), both give rates over the valid scenes."""
    tr = dryrun_trainer(tmp_path, num_clutter)
    sc = scenes.generate_scenes(tr.env, 6, generator=torch.Generator().manual_seed(3))
    assert set(sc) == set(scenes.FIELDS) and len(sc["obj_idx"]) == 6
    assert sc["clutter_pos"].shape == (6, num_clutter, 3)
    valid = [bool(v) for v in tr.env.reset_scene(sc)[0].valid_scene]
    assert valid[0] and valid == sorted(valid, reverse=True)   # the valid ones first
    for expert in (False, True):
        waves = [tr.worker.evaluate_scenes(tr.agent_state, scenes.scene_slice(sc, w * 4, 4),
                                           tr.generator, expert=expert) for w in range(2)]
        assert [bool(v) for v in waves[0]["valid_scene"]] == valid[:4]
        assert [bool(v) for v in waves[1]["valid_scene"]] == valid[4:] + valid[:2]
        rate, perf = tr.evaluate(episodes=2, scenes=sc, expert=expert)
        assert 0.0 <= rate <= 1.0 and perf.table()


def _fields(cfg):
    return {k: (_fields(v) if dataclasses.is_dataclass(v) else v)
            for k, v in ((f.name, getattr(cfg, f.name)) for f in dataclasses.fields(cfg))}


def test_td3_clutter_config_matches_jax():
    path = "experiments/cfgs/td3_clutter.yaml"
    mine, want = _fields(load_config(path)), _fields(jax_config.load_config(path))
    assert mine == want
    assert mine["env"]["num_clutter"] == 2 and mine["env"]["use_planner"]
    assert (mine["num_envs"], mine["batch_size"], mine["updates_per_iter"]) == (256, 128, 20)
    assert (mine["buffer_size"], mine["online_buffer_size"]) == (500000, 100000)
