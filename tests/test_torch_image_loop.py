"""Image mode in the loop, on the port alone (no JAX): a tiny `Trainer`
with use_image and domain_rand runs a collect and a train_iter, its ring
holding bfloat16 frames; the agent checkpoint carries every BatchNorm
buffer of the ResNet encoders; and `AgentConfig.pretrained_resnet` loads
a torchvision-layout file into both encoders (the JAX side of the same
file is held in tests/test_image_mode.py and tests/test_torch_resnet.py)."""

import dataclasses

import numpy as np
import torch

from gaddpg_tpu_torch.agents import AgentConfig, create_agent_state
from gaddpg_tpu_torch.envs.assets import box_asset
from gaddpg_tpu_torch.envs.grasp_env import EnvParams
from gaddpg_tpu_torch.models import resnet
from gaddpg_tpu_torch.physics.types import PhysicsParams
from gaddpg_tpu_torch.render.camera import CameraParams
from gaddpg_tpu_torch.train import Trainer, load_config
from gaddpg_tpu_torch.train.checkpoints import load_agent, save_agent
from torch_image_common import S, random_resnet


def _trainer(out_dir):
    env = EnvParams(physics=PhysicsParams(substeps=10), camera=CameraParams(width=S, height=S),
                    uniform_num_pts=58, pc_capacity=128, new_points_per_step=32,
                    settle_substeps=20, max_steps=3, reset_tries=2, retract_lift_steps=2,
                    use_planner=False, use_image=True, domain_rand=True)
    cfg = load_config(overrides={"num_envs": 4, "max_steps": 3, "extend_steps": 1,
                                 "batch_size": 4, "updates_per_iter": 1, "buffer_size": 32,
                                 "use_image": True, "IMG_SIZE": S, "output_dir": str(out_dir)},
                      policy="DDPG")
    # use_image renders RGBDM at the agent's input size
    assert cfg.env.use_image and cfg.env.camera.width == S
    return Trainer(dataclasses.replace(cfg, env=env), lib=box_asset(0.06, 0.06, 0.14),
                   device="cpu")


def test_trainer_collect_and_train_iter_in_image_mode(tmp_path):
    """One collect (the policy reads the images, the ring stores them in
    bfloat16) and one train_iter on image batches; then a checkpoint of
    the updated agent loads back with every BatchNorm buffer, the
    running statistics the update moved included."""
    tr = _trainer(tmp_path)
    stats = tr.collect()
    n = tr.buffer.filled
    assert n > 0 and stats["env_steps"] == n
    ring = tr.buffer.image_state
    assert ring.dtype == torch.bfloat16 and ring.shape == (32, 5, S, S)
    frames = ring[:n].float()
    assert torch.isfinite(frames).all() and (frames[:, 4] == 0).any()
    assert (frames[:, :3] >= 0).all() and (frames[:, :3] <= 1).all()
    before = {k: v.clone() for k, v in tr.agent_state.feat.state_dict().items()}
    metrics = tr.train_iter()
    assert tr.update_step == 1 and all(np.isfinite(v) for v in metrics.values())
    assert metrics["critic_loss"] > 0.0
    after = tr.agent_state.feat.state_dict()
    assert not torch.equal(before["value_encoder.layer4.1.bn2.running_mean"],
                           after["value_encoder.layer4.1.bn2.running_mean"])

    save_agent(tr.agent_state, str(tmp_path))
    template = create_agent_state(tr.cfg.agent, device="cpu")
    loaded = load_agent(template, str(tmp_path))
    assert loaded.update_step == 1
    got = loaded.feat.state_dict()
    assert set(got) == set(after) and any(k.endswith("running_var") for k in got)
    for k, v in after.items():
        assert torch.equal(got[k], v), k
    for name, opt in tr.agent_state.opt.items():
        assert all(torch.equal(a, b) for a, b in zip(opt.mu, loaded.opt[name].mu)), name


def test_pretrained_resnet_loads_both_encoders(tmp_path):
    """A torchvision-layout resnet18 dict with a 3-channel conv1 and an fc
    head, as an .npz and as a torch .pth (under "state_dict"): both
    encoders hold the file's tensors, conv1 zero-extended to 5 channels;
    and an encoder through export_torch_state -> .npz -> pretrained_resnet
    gives its features in both encoders, bit for bit."""
    src = random_resnet(7)
    sd = resnet.export_torch_state(src)
    sd["conv1.weight"] = sd["conv1.weight"][:, :3].copy()
    rng = np.random.RandomState(8)
    sd["fc.weight"] = rng.randn(1000, 512).astype(np.float32)
    sd["fc.bias"] = rng.randn(1000).astype(np.float32)
    npz, pth = str(tmp_path / "resnet18.npz"), str(tmp_path / "resnet18.pth")
    np.savez(npz, **sd)
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
    cfg = dict(use_image=True, image_size=S)
    for path in (npz, pth):
        state = create_agent_state(AgentConfig(**cfg, pretrained_resnet=path), device="cpu")
        for enc in (state.feat.encoder, state.feat.value_encoder):
            w = enc.conv1.weight.detach().numpy()
            np.testing.assert_array_equal(w[:, :3], sd["conv1.weight"])
            assert np.all(w[:, 3:] == 0.0)
            np.testing.assert_array_equal(enc.layer4[1].bn2.running_var.numpy(),
                                          sd["layer4.1.bn2.running_var"])

    out = str(tmp_path / "exported.npz")
    np.savez(out, **resnet.export_torch_state(src))
    loaded = create_agent_state(AgentConfig(**cfg, pretrained_resnet=out), device="cpu")
    img = torch.rand((2, 5, S, S), generator=torch.Generator().manual_seed(9))
    want = src(img)
    for enc in (loaded.feat.encoder, loaded.feat.value_encoder):
        assert torch.equal(enc(img), want)
