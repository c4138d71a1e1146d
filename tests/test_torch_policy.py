"""The serving slice as a whole: a JAX agent state carried over with
`from_flax` gives the same PointNet++ feature, the same `select_action`
output and the same `PolicyRunner` commands in the port (CPU tensors, so
the kernels' plain versions) as in the JAX package.

Bounds: the port folds BatchNorm into the SA Denses, as the JAX fused
(Pallas, interpret-mode) path does, so the two agree to 1e-4; the JAX
XLA path keeps BatchNorm unfolded, which shifts rounding, and
tests/test_pallas_sa.py already accepts 5e-4 between the two.
"""

import functools
import json
import os
import shutil
import subprocess
import sys

import flax
import jax
import numpy as np
import pytest
import torch

from gaddpg_tpu.agents import ddpg as jax_ddpg
from gaddpg_tpu.agents import state as jax_agent_state
from gaddpg_tpu.agents.config import AgentConfig as JaxAgentConfig
from gaddpg_tpu.agents.state import create_agent_state as jax_create_agent_state
from gaddpg_tpu.deploy.runner import Frame as JaxFrame
from gaddpg_tpu.deploy.runner import PolicyRunner as JaxPolicyRunner
from gaddpg_tpu.models.pointnet import PointNetFeature as JaxPointNetFeature
from gaddpg_tpu_torch.agents import (
    AgentConfig, create_agent_state, exploration_noise, from_flax, make_select_action,
)
from gaddpg_tpu_torch.deploy.runner import Frame, PolicyRunner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPOINTS = 96  # 6 hand anchors + 90 cloud points


def _perturb_bn(tree, rng, stats: bool):
    """Copy of a Flax tree with every BatchNorm away from its initial
    values, so that folding is exercised."""
    out = {}
    for k, v in tree.items():
        if k.startswith("BatchNorm_"):
            c = v["mean" if stats else "scale"].shape[0]
            if stats:
                out[k] = {"mean": (rng.randn(c) * 0.02).astype(np.float32),
                          "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
            else:
                out[k] = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                          "bias": (rng.randn(c) * 0.05).astype(np.float32)}
        elif isinstance(v, dict):
            out[k] = _perturb_bn(v, rng, stats)
        else:
            out[k] = v
    return out


def _jax_state(scale):
    """A JAX AgentState from `create_agent_state` at model_scale `scale`,
    with BatchNorm parameters and running statistics perturbed. The JAX
    package's `make_modules` builds PointNetFeature at its default scale
    1; scale 2 puts the module's own `scale=2` in its place."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_agent_state, "PointNetFeature",
                   functools.partial(JaxPointNetFeature, scale=scale))
        state = jax_create_agent_state(jax.random.PRNGKey(2),
                                       JaxAgentConfig(feature_dim=512 * scale), npoints=NPOINTS)
    rng = np.random.RandomState(0)

    def numpy_tree(t):
        return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(t))

    return state.replace(
        feat_params=_perturb_bn(numpy_tree(state.feat_params), rng, stats=False),
        feat_stats=_perturb_bn(numpy_tree(state.feat_stats), rng, stats=True),
        policy_params=numpy_tree(state.policy_params),
    )


@pytest.fixture(scope="module")
def jax_state():
    return _jax_state(1)


@pytest.fixture(scope="module")
def port_state(jax_state):
    return from_flax(jax_state.feat_params, jax_state.feat_stats,
                     jax_state.policy_params, device="cpu")


@pytest.fixture(scope="module")
def scale2_states():
    """(JAX state, port state) of a model_scale 2 agent."""
    js = _jax_state(2)
    return js, from_flax(js.feat_params, js.feat_stats, js.policy_params,
                         AgentConfig(feature_dim=1024), device="cpu")


def point_state(batch, seed):
    rng = np.random.RandomState(seed)
    ps = (rng.randn(batch, 4, NPOINTS) * 0.05).astype(np.float32)
    ps[:, 3, :] = 0.0
    ps[:, 3, :6] = 1.0
    return ps


@pytest.mark.parametrize("mode,tol,scale", [
    pytest.param("interpret", 1e-4, 1, id="interpret-0.0001"),
    pytest.param("0", 5e-4, 1, id="0-0.0005"),
    pytest.param("interpret", 1e-4, 2, id="interpret-0.0001-scale2"),
    pytest.param("0", 5e-4, 2, id="0-0.0005-scale2"),
])
def test_feature_matches_jax(request, monkeypatch, mode, tol, scale):
    """PointNetFeature eval forward, policy and value encoders, at
    model_scale 1 and 2; the JAX side on its fused Pallas path
    (interpret) or its plain XLA path (0)."""
    if scale == 1:
        jax_state, port_state = (request.getfixturevalue("jax_state"),
                                 request.getfixturevalue("port_state"))
    else:
        jax_state, port_state = request.getfixturevalue("scale2_states")
    ps = point_state(2, 1)
    action = np.random.RandomState(2).uniform(-0.05, 0.05, (2, 6)).astype(np.float32)
    monkeypatch.setenv("GADDPG_PALLAS_SA", mode)
    variables = {"params": jax_state.feat_params, "batch_stats": jax_state.feat_stats}
    feat = JaxPointNetFeature(scale=scale)
    want = feat.apply(variables, ps, train=False)
    want_v = feat.apply(variables, ps, action=action, value=True, train=False)
    with torch.no_grad():
        got = port_state.feat(torch.from_numpy(ps))
        got_v = port_state.feat(torch.from_numpy(ps), action=torch.from_numpy(action),
                                value=True)
    assert got.shape == (2, 512 * scale) and float(got.std()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=tol, atol=tol)


def test_select_action_matches_jax(jax_state, port_state, monkeypatch):
    monkeypatch.setenv("GADDPG_PALLAS_SA", "interpret")
    ps = point_state(3, 3)
    remain = np.array([1.0, 7.0, 20.0], np.float32)
    want_a, want_aux = jax_ddpg.make_select_action(JaxAgentConfig())(
        jax_state, ps, remain, jax.random.PRNGKey(0))
    select = make_select_action(AgentConfig(), device="cpu")
    got_a, got_aux = select(port_state, torch.from_numpy(ps), torch.from_numpy(remain))
    assert got_a.shape == (3, 6) and got_aux.shape == (3, 7)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_aux.numpy(), np.asarray(want_aux), rtol=1e-4, atol=1e-4)
    # the aux quaternion is unit length
    np.testing.assert_allclose(np.linalg.norm(got_aux.numpy()[:, :4], axis=-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("sampled", [False, True])
def test_gaussian_policy_sample_matches_jax(jax_state, port_state, sampled):
    """(squashed mean, log_prob, action, extra) of `GaussianPolicy.sample`,
    deterministic (no key / no noise) or with JAX's normal draws injected."""
    from gaddpg_tpu.models.heads import GaussianPolicy as JaxGaussianPolicy

    feature = np.random.RandomState(8).randn(3, 513).astype(np.float32)
    key = jax.random.PRNGKey(5) if sampled else None
    want = JaxGaussianPolicy().apply({"params": jax_state.policy_params}, feature, key,
                                     method=JaxGaussianPolicy.sample)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (3, 6)))) if sampled else None
    with torch.no_grad():
        got = port_state.policy.sample(torch.from_numpy(feature), noise)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("noise_type", ["uniform", "normal"])
def test_exploration_noise_matches_jax(noise_type):
    """The same raw draws give the same noise (symmetric, rotation x5)."""
    key = jax.random.PRNGKey(4)
    action = np.zeros((5, 6), np.float32)
    want = jax_ddpg.exploration_noise(key, action, 0.3, noise_type)
    draw = jax.random.uniform if noise_type == "uniform" else jax.random.normal
    draws = np.array(draw(key, action.shape))
    got = exploration_noise(torch.from_numpy(draws), 0.3, noise_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_select_action_explore_adds_generator_noise(port_state):
    cfg = AgentConfig()
    select = make_select_action(cfg, device="cpu")
    ps, remain = torch.from_numpy(point_state(2, 5)), torch.full((2,), 4.0)
    base, _ = select(port_state, ps, remain)
    gen = torch.Generator().manual_seed(9)
    got, _ = select(port_state, ps, remain, torch.Generator().manual_seed(9),
                    noise_scale=2.0, explore=True)
    noise = exploration_noise(torch.rand(base.shape, generator=gen),
                              cfg.action_noise * 2.0)
    torch.testing.assert_close(got, base + noise)
    assert not torch.equal(got, base)


def _frames(n):
    """Synthetic depth frames of a target blob 35 cm ahead of a camera
    that moves 1 cm along its axis each frame."""
    h, w = 48, 64
    depth = np.zeros((h, w), np.float32)
    depth[14:34, 20:44] = 0.35 + 0.01 * np.random.RandomState(6).rand(20, 24)
    k = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]])
    frames = []
    for i in range(n):
        hand = np.eye(4)
        hand[:3, 3] = (0.0, 0.0, 0.01 * i)
        frames.append((depth, depth > 0, k, hand.copy(), hand))
    return frames


def test_policy_runner_matches_jax(jax_state, port_state):
    """Same frames, same seeds, same numpy state builder: the same phase
    sequence as tests/test_deploy.py (APPROACH x3 -> RETRACT -> DONE)
    and the same APPROACH commands. The JAX runner takes its default
    (XLA, unfolded BatchNorm) path here, hence the 5e-4 bound."""
    kw = dict(max_steps=3, retract_steps=2, num_pts=NPOINTS - 6, termination=False)
    jax_runner = JaxPolicyRunner(jax_state, JaxAgentConfig(), **kw)
    runner = PolicyRunner(port_state, AgentConfig(), device="cpu", **kw)
    phases = []
    for args in _frames(7):
        want, got = jax_runner(JaxFrame(*args)), runner(Frame(*args))
        assert got.phase == want.phase and got.close_gripper == want.close_gripper
        assert got.delta_pose.shape == (6,)
        if got.phase == "APPROACH":
            assert got.delta_pose.dtype == np.float32
        np.testing.assert_allclose(got.delta_pose, want.delta_pose, rtol=5e-4, atol=5e-4)
        phases.append(got.phase)
    assert phases == ["APPROACH"] * 3 + ["RETRACT"] * 3 + ["DONE"]
    # retract commands lift along world +z
    runner.reset()
    for args in _frames(5):
        cmd = runner(Frame(*args))
    assert cmd.phase == "RETRACT"
    assert (args[4][:3, :3] @ cmd.delta_pose[:3])[2] > 0.01


def test_unported_options_raise(port_state):
    # image mode is ported (tests/test_torch_image_agent.py); its ResNet-18
    # encoders output 512 features, so no other feature_dim
    assert create_agent_state(AgentConfig(use_image=True), device="cpu").feat.value_encoder
    with pytest.raises(ValueError, match="ResNet-18"):
        create_agent_state(AgentConfig(use_image=True, feature_dim=1024), device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        make_select_action(AgentConfig(compute_dtype="float16"), device="cpu")
    # bfloat16 is ported: the encoders' FC Dense layers run in it
    state = create_agent_state(AgentConfig(compute_dtype="bfloat16"), npoints=96, device="cpu")
    assert state.feat.encoder.compute_dtype == torch.bfloat16


def test_create_agent_state_matches_jax_shapes_and_init(jax_state):
    """`create_agent_state` builds every tensor `from_flax` fills, with the
    JAX initialisers' spreads: kaiming-normal SA, lecun-normal FC,
    xavier-uniform heads, zero biases, identity BatchNorm."""
    with torch.no_grad():
        state = create_agent_state(AgentConfig(), generator=torch.Generator().manual_seed(1),
                                   device="cpu")
    theirs = from_flax(jax_state.feat_params, jax_state.feat_stats,
                       jax_state.policy_params, device="cpu")
    mine = dict(state.feat.state_dict(), **state.policy.state_dict())
    other = dict(theirs.feat.state_dict(), **theirs.policy.state_dict())
    assert {k: v.shape for k, v in mine.items()} == {k: v.shape for k, v in other.items()}
    enc = state.feat.encoder
    w_sa = enc.sa[1].dense[0].weight.detach()  # (128, 131)
    w_fc = enc.fc[0].weight.detach()           # (1024, 512)
    w_pi = state.policy.fc1.weight.detach()    # (256, 513)
    assert abs(float(w_sa.std()) / np.sqrt(2.0 / 131) - 1) < 0.05
    assert abs(float(w_fc.std()) / np.sqrt(1.0 / 512) - 1) < 0.05
    assert abs(float(w_pi.std()) / np.sqrt(2.0 / (256 + 513)) - 1) < 0.05
    assert float(w_pi.abs().max()) <= np.sqrt(6.0 / (256 + 513))
    assert float(enc.sa[1].dense[0].bias.abs().max()) == 0.0
    bn = enc.sa[1].norms[0]
    assert bool((bn.weight == 1).all() and (bn.bias == 0).all())
    assert bool((bn.running_mean == 0).all() and (bn.running_var == 1).all())


_IMPORT_CHECK = r"""
import importlib, json, pkgutil, sys
import gaddpg_tpu_torch
for m in pkgutil.walk_packages(gaddpg_tpu_torch.__path__, "gaddpg_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "gaddpg_tpu", "msgpack"))
raised = {}
import torch
from gaddpg_tpu_torch.agents import (
    AgentConfig, create_agent_state, make_bc_update, make_ddpg_update, make_select_action)
from gaddpg_tpu_torch.deploy.runner import PolicyRunner
from gaddpg_tpu_torch.envs.assets import box_asset
from gaddpg_tpu_torch.envs.grasp_env import EnvParams, PandaGraspEnv
for name, call in (
        ("make_select_action", lambda: make_select_action(AgentConfig())),
        ("create_agent_state", lambda: create_agent_state(AgentConfig(), npoints=96)),
        ("PolicyRunner", lambda: PolicyRunner(None, AgentConfig())),
        ("make_ddpg_update", lambda: make_ddpg_update()),
        ("make_bc_update", lambda: make_bc_update()),
        ("PandaGraspEnv", lambda: PandaGraspEnv(EnvParams(use_planner=False),
                                                box_asset(0.05, 0.05, 0.14)))):
    try:
        call()
        raised[name] = None
    except RuntimeError as e:
        raised[name] = str(e)
print(json.dumps({"bad": bad, "cuda": torch.cuda.is_available(), "raised": raised,
                  "modules": sorted(n for n in sys.modules if n.startswith("gaddpg_tpu_torch"))}))
"""


def test_port_imports_no_jax_and_cuda_entry_points_raise():
    """In a fresh interpreter: every module of the port and chip_smoke
    import without JAX, Flax, Optax, msgpack or the JAX package (the
    reader of JAX checkpoints and the mesh among them); the entry points,
    the learner's updates and the env included, default to CUDA and raise
    where there is none."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for mod in ("ops.build", "ops.sampling", "ops.sa", "ops.sa_train", "models.pointnet",
                "models.heads", "agents.state", "agents.optim", "agents.losses", "agents.ddpg",
                "agents.bc", "deploy.runner", "deploy.realworld", "geometry.gripper",
                "geometry.rotations", "utils.precision", "geometry.se3", "robot.panda",
                "robot.ik", "physics.types", "physics.contact", "physics.fast",
                "ops.contact_scan", "render.camera", "render.pointcloud", "envs.assets",
                "envs.grasp_env", "expert.goals", "expert.servo", "train.flax_msgpack",
                "train.checkpoints", "parallel.mesh"):
        assert f"gaddpg_tpu_torch.{mod}" in res["modules"]
    if not res["cuda"]:
        for name, msg in res["raised"].items():
            assert msg is not None and "CUDA is not available" in msg, name


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result where CUDA is
    absent, and where it stands alone without the package."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cwd, script in ((REPO, "chip_smoke.py"), (tmp_path, str(alone))):
        out = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                             text=True, timeout=120, env=dict(os.environ, PYTHONPATH=""))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
