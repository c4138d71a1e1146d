"""Grasp-pose dataset generation for goal-feature training (counterpart
of gaddpg_tpu/data/grasp_dataset.py).

Stand-in for the reference's ACRONYM pipeline (reference:
misc/grasp_data_reader.py: depth renders -> clouds, positive and
hard-negative grasp sampling, perturbation): object clouds are rendered
with the point-splat camera from random viewpoints, positives are the
library grasps with small perturbations, negatives the same grasps with
large ones (the "hard negative" construction, reference:
misc/grasp_data_reader.py:140-176).

The whole batch is drawn and rendered at once on the library's device.
`GraspDatasetGenerator.draws` makes the random draws from a
torch.Generator; `GraspDatasetGenerator.batch` consumes them, so the JAX
package's draws can be fed in as tensors.
"""

import math
from typing import Dict

import torch

from gaddpg_tpu_torch.agents.losses import goal_pred_loss
from gaddpg_tpu_torch.envs.assets import ObjectLibrary
from gaddpg_tpu_torch.geometry.rotations import euler_to_mat
from gaddpg_tpu_torch.geometry.se3 import pack_pose_rot_first, se3_inverse
from gaddpg_tpu_torch.render.camera import CameraParams, visible_points
from gaddpg_tpu_torch.utils.precision import f32_matmuls, resolve_device

POS_TRANS_STD = 0.008
POS_ROT_STD = 0.08
NEG_TRANS = (0.03, 0.10)
NEG_ROT = (0.4, 1.2)
# the camera's spherical coordinates about the object centre
THETA = (0.2, 1.2)
PHI = (0.0, 2 * math.pi)
RADIUS = (0.3, 0.6)


class GraspDatasetGenerator:
    """Batch generator of (object cloud, grasp [q, t], label)."""

    def __init__(self, lib: ObjectLibrary, cloud_points: int = 512,
                 cam: CameraParams = CameraParams(width=64, height=64), device="cuda"):
        self.device = resolve_device(device)
        self.lib = lib.to(self.device)
        self.cam = cam
        self.cloud_points = cloud_points

    def draws(self, generator: torch.Generator, batch: int) -> Dict[str, torch.Tensor]:
        """The batch's random draws, on the generator's device:

        obj_idx (B,) object; theta, phi, radius (B,) the camera's position
        on a sphere about the object; grasp_idx (B,) a valid grasp of the
        object, uniformly; label_u (B,) a uniform, positive below 0.5;
        pos_dt, pos_de (B, 3) standard normals of the positive's
        translation and euler perturbation; neg_u (B,) a uniform that
        sets both the negative's translation and rotation magnitudes (the
        JAX package draws both from one key); neg_dt, neg_de (B, 3) the
        negative's standard normals."""
        dev = generator.device
        u = lambda lo_hi: lo_hi[0] + (lo_hi[1] - lo_hi[0]) * torch.rand(  # noqa: E731
            batch, generator=generator, device=dev)
        obj_idx = torch.randint(self.lib.num_objects, (batch,), generator=generator,
                                device=dev)
        gv = self.lib.grasp_valid.to(dev)[obj_idx].float()
        # an object without a valid grasp picks grasp 0, as jax.random.choice
        # does with all-zero probabilities
        gv[:, 0] += (gv.sum(dim=1) == 0).float()
        out = {"obj_idx": obj_idx, "theta": u(THETA), "phi": u(PHI), "radius": u(RADIUS),
               "grasp_idx": torch.multinomial(gv, 1, generator=generator)[:, 0],
               "label_u": torch.rand(batch, generator=generator, device=dev)}
        for k in ("pos_dt", "pos_de"):
            out[k] = torch.randn((batch, 3), generator=generator, device=dev)
        out["neg_u"] = torch.rand(batch, generator=generator, device=dev)
        for k in ("neg_dt", "neg_de"):
            out[k] = torch.randn((batch, 3), generator=generator, device=dev)
        return out

    def sample(self, generator: torch.Generator, batch: int = 64) -> Dict[str, torch.Tensor]:
        """One batch from `generator`'s draws (see `batch`)."""
        return self.from_draws(self.draws(generator, batch))

    def from_draws(self, d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The batch of the draws `d` (a `draws` dict)."""
        t_mag = NEG_TRANS[0] + (NEG_TRANS[1] - NEG_TRANS[0]) * d["neg_u"]
        r_mag = NEG_ROT[0] + (NEG_ROT[1] - NEG_ROT[0]) * d["neg_u"]
        return self.batch(d["obj_idx"], d["theta"], d["phi"], d["radius"], d["grasp_idx"],
                          d["label_u"], d["pos_dt"], d["pos_de"], t_mag, r_mag, d["neg_dt"],
                          d["neg_de"])

    @f32_matmuls
    def batch(self, obj_idx, theta, phi, radius, grasp_idx, label_u, pos_dt, pos_de,
              neg_t_mag, neg_r_mag, neg_dt, neg_de) -> Dict[str, torch.Tensor]:
        """The batch from its draws (each (B,) or (B, 3), `draws` says what
        they are; the negative's magnitudes neg_t_mag in NEG_TRANS and
        neg_r_mag in NEG_ROT):

        cloud (B, P, 3) visible object points in the object frame, zero
        rows where fewer than P pixels were hit; grasp (B, 7) the perturbed
        grasp as [q, t]; label (B,) 1.0 for a positive; cloud_valid (B, P);
        obj_idx (B,)."""
        dev = self.device
        obj_idx, grasp_idx = obj_idx.to(dev), grasp_idx.to(dev)
        theta, phi, radius, label_u, neg_t_mag, neg_r_mag = (
            t.to(dev) for t in (theta, phi, radius, label_u, neg_t_mag, neg_r_mag))
        cloud, valid = self._render_cloud(obj_idx, theta, phi, radius)
        grasp = self.lib.grasps[obj_idx, grasp_idx]
        positive = label_u < 0.5
        pos_g = _perturb(grasp, pos_dt.to(dev) * POS_TRANS_STD, pos_de.to(dev) * POS_ROT_STD)
        neg_g = _perturb(grasp, neg_dt.to(dev) * neg_t_mag[:, None],
                         neg_de.to(dev) * neg_r_mag[:, None])
        g = torch.where(positive[:, None, None], pos_g, neg_g)
        return {
            "cloud": cloud,                       # (B, P, 3) object frame
            "grasp": pack_pose_rot_first(g),      # (B, 7) [q, t]
            "label": positive.float(),            # (B,) 1 = near-DB grasp
            "cloud_valid": valid,                 # (B, P)
            "obj_idx": obj_idx,
        }

    def _render_cloud(self, obj_idx, theta, phi, radius):
        """Visible object points from the drawn viewpoints, object frame."""
        eye = radius[:, None] * torch.stack([
            torch.sin(theta) * torch.cos(phi),
            torch.sin(theta) * torch.sin(phi),
            torch.cos(theta),
        ], dim=-1)
        z = -eye / torch.clamp(torch.linalg.vector_norm(eye, dim=-1, keepdim=True), min=1e-6)
        up = torch.tensor([0.0, 0.0, 1.0], device=eye.device).expand_as(z)
        x = torch.linalg.cross(up, z)
        x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-6)
        y = torch.linalg.cross(z, x)
        b = eye.shape[0]
        cam_pose = torch.eye(4, device=eye.device).repeat(b, 1, 1)
        cam_pose[:, :3, 0], cam_pose[:, :3, 1], cam_pose[:, :3, 2] = x, y, z
        cam_pose[:, :3, 3] = eye
        pts_cam, valid = visible_points(self.cam, se3_inverse(cam_pose),
                                        self.lib.surface_points[obj_idx],
                                        max_points=self.cloud_points)
        pts_obj = pts_cam @ cam_pose[:, :3, :3].transpose(-1, -2) + cam_pose[:, None, :3, 3]
        return torch.where(valid[..., None], pts_obj, 0.0), valid


def _perturb(grasp, dt, de):
    """Grasps (B, 4, 4) moved by dt (B, 3) and turned by euler de (B, 3)."""
    out = grasp.clone()
    out[:, :3, 3] = grasp[:, :3, 3] + dt
    out[:, :3, :3] = euler_to_mat(de) @ grasp[:, :3, :3]
    return out


def make_goal_feature_update(goal, opt):
    """GoalFeature's training step: the PM loss on the positives plus the
    binary cross-entropy of the confidence head (the reference trains its
    grasp evaluator this way, misc/grasp_data_reader.py:338-357).

    `goal` is a GoalFeature and `opt` an `agents.optim.AdamW` over its
    parameters in `agents.state.goal_parameters` order. `update(batch)`
    runs the train forward (K1, K2, K5, K6 on the card), steps `opt`,
    folds the batch statistics into the running ones (momentum 0.9, as
    Flax does) and returns {"pm_loss", "bce_loss"}."""
    params = opt.params

    @f32_matmuls
    def update(batch):
        qt, conf, stats = goal(batch["cloud"], train=True)
        label = batch["label"]
        pm = goal_pred_loss(qt, batch["grasp"], label > 0.5)
        eps = 1e-6
        bce = -torch.mean(label * torch.log(conf + eps) + (1 - label) * torch.log(1 - conf + eps))
        grads = torch.autograd.grad(pm + bce, params, allow_unused=True)
        opt.step(grads)
        goal.encoder.update_running_stats(stats)
        return {"pm_loss": pm.detach(), "bce_loss": bce.detach()}

    return update
