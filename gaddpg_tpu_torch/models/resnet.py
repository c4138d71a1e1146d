"""ResNet-18 image encoder for the RGBDM state (counterpart of
gaddpg_tpu/models/resnet.py; reference: core/networks.py:106-147).

A 5-channel RGBDM image (B, 5, H, W), channels-first, goes through the
per-channel normalisation of the reference, the 7x7/2 stem, a 3x3/2 max
pool, four stages of two `BasicBlock`s at widths 64, 128, 256 and 512,
and a global mean -> (B, 512). The submodules carry torchvision's names
(`conv1`, `bn1`, `layerL.B.conv1`, `layerL.B.downsample.0/1`), so a
torchvision resnet18 state dict loads with `load_torch_state` (conv1
zero-extended from 3 to 5 input channels, the `fc` head dropped), and an
`.npz` that the JAX package's `export_torch_state` writes loads as it is.
No pretrained weights are fetched: `AgentConfig.pretrained_resnet` names
a file on disk.

BatchNorm follows Flax's arithmetic, as models/pointnet.py does: the
train forward normalises by each call's batch statistics (fast variance,
clamped at 0, the per-channel sums over (N, H, W) accumulated in float64
from the float32 activations and their float32 squares) and returns them, detached, in the order of `batch_norms`,
without touching the running statistics; the caller folds the ones it
keeps in with `update_running_stats` (momentum 0.9 on the old value, the
biased variance). The modules' own BatchNorm layers stay in eval mode.

Under a data-parallel mesh (`mesh=`, `parallel.mesh`) each rank holds
its rows of the batch and every one of the 20 BatchNorms of an encoder
takes its statistics over the global batch, as the JAX package's sharded
program does: each rank's float64 sums of x and x^2 and its row count
are added across the ranks through the differentiable all-reduce
(`ops.sa_train.batch_moments`), in layer order, so the backward reduces
the gradients of the same sums in the reverse order; the split differs
from the whole batch only in the order of float64 additions. Every rank
reaches every reduction: none depends on its own rows.

The convolutions run with TF32 off (`f32_matmuls`), so a card computes
them in float32 as the CPU does; `AgentConfig.compute_dtype` does not
reach the ResNet, as the JAX package's `ImageFeature` ignores it.
"""

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from gaddpg_tpu_torch.models.pointnet import BN_EPS, update_running_stats
from gaddpg_tpu_torch.ops.sa_train import batch_moments
from gaddpg_tpu_torch.utils.precision import f32_matmuls

# RGB statistics of ImageNet, identity for depth and mask
# (reference: core/networks.py:129-132)
MEAN = (0.485, 0.456, 0.406, 0.0, 0.0)
STD = (0.229, 0.224, 0.225, 1.0, 1.0)
STAGE_WIDTHS = (64, 128, 256, 512)


def _batch_norm(c: int) -> nn.BatchNorm2d:
    # Flax momentum 0.9 on the old value == torch momentum 0.1 on the new
    return nn.BatchNorm2d(c, eps=BN_EPS, momentum=0.1)


def batch_norm_2d(bn: nn.BatchNorm2d, x, stats=None, mesh=None):
    """BatchNorm over (N, H, W) of x (N, C, H, W) with Flax's arithmetic:
    (x - mean) * (rsqrt(var + eps) * scale) + bias. With `stats` a list,
    the batch's statistics (fast variance, clamped at 0, the sums in
    float64; over every rank's rows with a data-parallel `mesh`) normalise
    and are appended to it, detached; with None the running ones do."""
    if stats is None:
        m, v = bn.running_mean, bn.running_var
    else:
        m, v = batch_moments(x, (0, 2, 3), mesh, sum_dtype=torch.float64)
        v = torch.clamp(v, min=0.0)
        stats.append((m.detach(), v.detach()))
    mul = torch.rsqrt(v + bn.eps) * bn.weight
    return (x - m[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]


class BasicBlock(nn.Module):
    """Two 3x3 convolutions with BatchNorm, and a 1x1 projection of the
    residual where the stride or width changes (the Flax module's Conv_0,
    BatchNorm_0, Conv_1, BatchNorm_1, Conv_2, BatchNorm_2)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = _batch_norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _batch_norm(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                                            _batch_norm(planes))

    def convs(self):
        """(conv, BatchNorm) pairs in the Flax module's order."""
        out = [(self.conv1, self.bn1), (self.conv2, self.bn2)]
        if self.downsample is not None:
            out.append((self.downsample[0], self.downsample[1]))
        return out

    def forward(self, x, stats=None, mesh=None):
        y = torch.relu(batch_norm_2d(self.bn1, self.conv1(x), stats, mesh))
        y = batch_norm_2d(self.bn2, self.conv2(y), stats, mesh)
        if self.downsample is not None:
            x = batch_norm_2d(self.downsample[1], self.downsample[0](x), stats, mesh)
        return torch.relu(y + x)


class ResNet18Feature(nn.Module):
    """(B, C, H, W) channels-first RGBDM -> (B, 512)."""

    def __init__(self, stage_sizes=(2, 2, 2, 2), input_channels: int = 5):
        super().__init__()
        self.conv1 = nn.Conv2d(input_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = _batch_norm(64)
        inplanes = 64
        for i, (blocks, width) in enumerate(zip(stage_sizes, STAGE_WIDTHS)):
            stage = []
            for b in range(blocks):
                stage.append(BasicBlock(inplanes, width, 2 if (b == 0 and i > 0) else 1))
                inplanes = width
            setattr(self, f"layer{i + 1}", nn.Sequential(*stage))
        self.num_stages = len(stage_sizes)
        self.register_buffer("mean", torch.tensor(MEAN[:input_channels]), persistent=False)
        self.register_buffer("std", torch.tensor(STD[:input_channels]), persistent=False)

    def blocks(self):
        """Every BasicBlock in order (the Flax module's BasicBlock_i)."""
        return [blk for i in range(self.num_stages) for blk in getattr(self, f"layer{i + 1}")]

    def batch_norms(self):
        """Every BatchNorm in the order the train forward returns its
        statistics: the stem's, then each block's (`BasicBlock.convs`)."""
        return [self.bn1] + [bn for blk in self.blocks() for _, bn in blk.convs()]

    def update_running_stats(self, stats):
        """Fold one train forward's batch statistics into the running ones."""
        update_running_stats(self.batch_norms(), stats)

    @f32_matmuls
    def forward(self, img, train: bool = False, mesh=None):
        """-> (B, 512); with train=True -> ((B, 512), [(mean, var)] of
        every BatchNorm in the order of `batch_norms`, detached; over
        every rank's rows with a data-parallel `mesh`)."""
        stats = [] if train else None
        c = img.shape[1]
        x = (img - self.mean[:c, None, None]) / self.std[:c, None, None]
        x = torch.relu(batch_norm_2d(self.bn1, self.conv1(x), stats, mesh))
        x = F.max_pool2d(x, 3, 2, 1)
        for blk in self.blocks():
            x = blk(x, stats, mesh)
        x = x.mean(dim=(2, 3))
        return (x, stats) if train else x


class ImageFeature(nn.Module):
    """Policy and value ResNet-18 encoders over RGBDM images, with the
    call contract of PointNetFeature (reference: core/networks.py:106-147):
    the value path appends the action to its feature (the reference feeds
    it to the Q head instead; the same computation once the head
    concatenates)."""

    def __init__(self):
        super().__init__()
        self.encoder = ResNet18Feature()
        self.value_encoder = ResNet18Feature()

    def forward(self, image, action=None, value: bool = False, train: bool = False,
                mesh=None):
        """image (B, 5, H, W); action (B, 6) for the value path. Returns
        the encoder's output (with train=True, also its batch statistics,
        over every rank's rows with a data-parallel `mesh`)."""
        if not value:
            return self.encoder(image, train, mesh)
        out = self.value_encoder(image, train, mesh)
        z, stats = out if train else (out, None)
        if action is not None:
            z = torch.cat([z, action], dim=-1)
        return (z, stats) if train else z


def _tensor(v):
    return v.detach().cpu() if torch.is_tensor(v) else torch.tensor(np.asarray(v))


def load_torch_state(model: ResNet18Feature, state_dict):
    """Load a torchvision-layout resnet18 state dict (tensors or numpy
    arrays) into `model` in place, as the reference ingests pretrained
    weights (reference: core/networks.py:38-58): conv1 is zero-extended
    along its input channels where the file's is narrower, the `fc` head
    is ignored, and every other tensor of the model must be in the file
    (`num_batches_tracked`, which the JAX package does not write, may be
    missing). Returns `model`."""
    sd = {k: _tensor(v) for k, v in state_dict.items() if not k.startswith("fc.")}
    w = sd["conv1.weight"]
    want = model.conv1.weight.shape[1]
    if w.shape[1] < want:
        sd["conv1.weight"] = torch.cat(
            [w, w.new_zeros((w.shape[0], want - w.shape[1], *w.shape[2:]))], dim=1)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"not a resnet18 state dict: missing {missing}, "
                         f"unexpected {unexpected}")
    return model


def export_torch_state(model: ResNet18Feature):
    """`model`'s torchvision-layout state dict as numpy arrays, the key
    set of the JAX package's `export_torch_state` (conv1 at its full
    input width, no `num_batches_tracked`): the inverse of
    `load_torch_state`, and what `np.savez` writes for
    `AgentConfig.pretrained_resnet`."""
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def load_pretrained_encoders(feat: ImageFeature, state_dict):
    """A torchvision resnet18 state dict into both encoders of `feat`
    (the reference pretrains the policy and value encoders alike,
    reference: core/networks.py:118,126). Returns `feat`."""
    for enc in (feat.encoder, feat.value_encoder):
        load_torch_state(enc, state_dict)
    return feat
