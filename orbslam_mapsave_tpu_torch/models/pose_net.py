"""Human-pose backbone for the `OpDetector` pipeline.

Port of `orbslam_mapsave_tpu/models/pose_net.py`. The reference's gait
system runs the OpenPose BODY_25 backbone (`src/DetectHumanPose.cpp:100-220`:
netInputSize 320x176, one person, keypoints consumed as (25,3)
[x, y, conf]). This is the same fully-convolutional heatmap network as the
JAX version's flax module, decoded with a soft-argmax on the device; the
contract downstream (`apps/human_pose.OpDetector`) is the reference's:
image -> (25,3) [x_px, y_px, confidence].

The project ships no pretrained weights, so the net trains on the
synthetic skeleton renderer (`pose_synth.render_batch`), as the JAX
version's tests do.

What the flax module computes, and what this one mirrors:
- layout: NCHW tensors and OIHW kernels here, NHWC / HWIO in flax
  (`interop.pose_net_params_from_flax` converts);
- "SAME" padding as `lax.padtype_to_pads` gives it: asymmetric on the
  stride-2 convolutions ((0, 1) per dim at even sizes), so each conv pads
  explicitly and convolves with padding 0;
- dtypes: every `ConvBlock` conv and the dilated conv run in bfloat16
  (input and kernel cast, bf16 result, then the bf16 bias added), their
  parameters stay float32; GroupNorm (8 groups, eps 1e-6, flax's default)
  and the 1x1 head run in float32; the output is float32.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .pose_synth import N_JOINTS, render_batch

STRIDE = 4  # heatmap stride vs input
GN_GROUPS = 8
GN_EPS = 1e-6  # flax nn.GroupNorm's default epsilon


def same_pads(size: int, kernel: int, stride: int = 1, dilation: int = 1) -> tuple[int, int]:
    """(low, high) padding of one dim under "SAME" (`lax.padtype_to_pads`)."""
    k = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.Conv(..., padding="SAME", dtype=dtype)` on an NCHW tensor:
    input and kernel cast to `dtype`, the convolution's result in `dtype`,
    then the bias cast to `dtype` added."""
    kh, kw = conv.kernel_size
    sh, sw = conv.stride
    dh, dw = conv.dilation
    top, bottom = same_pads(x.shape[2], kh, sh, dh)
    left, right = same_pads(x.shape[3], kw, sw, dw)
    x = F.pad(x.to(dtype), (left, right, top, bottom))
    y = F.conv2d(x, conv.weight.to(dtype), None, conv.stride, 0, conv.dilation)
    return y + conv.bias.to(dtype)[None, :, None, None]


class ConvBlock(nn.Module):
    """3x3 conv (bf16) -> GroupNorm(8) (f32) -> ReLU."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, 3, stride=stride)
        self.norm = nn.GroupNorm(GN_GROUPS, features, eps=GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.norm(_conv(x, self.conv, torch.bfloat16).float()))


class PoseNet(nn.Module):
    """Grayscale (B, 1, H, W) in [0, 1] -> (B, 25, ceil(H/4), ceil(W/4))
    joint heatmaps, float32."""

    def __init__(self, width: int = 64):
        super().__init__()
        w = width
        self.width = width
        self.blocks = nn.ModuleList([
            ConvBlock(1, w, stride=2),  # /2
            ConvBlock(w, w),
            ConvBlock(w, 2 * w, stride=2),  # /4
            ConvBlock(2 * w, 2 * w),
            ConvBlock(2 * w, 2 * w),
            ConvBlock(2 * w, 2 * w),  # after the dilated context conv
        ])
        # dilated context instead of deeper strides: keeps the heatmap at /4
        self.context = nn.Conv2d(2 * w, 2 * w, 3, dilation=2)
        self.head = nn.Conv2d(2 * w, N_JOINTS, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks[:5]:
            x = block(x)
        x = F.relu(_conv(x, self.context, torch.bfloat16))
        x = self.blocks[5](x)
        return _conv(x, self.head, torch.float32)


def init_params(net: PoseNet, generator: torch.Generator) -> PoseNet:
    """flax's initializers, drawn from `generator`: conv kernels LeCun
    normal (truncated at 2 sigma, variance 1 / fan_in), biases zero,
    GroupNorm scale one and bias zero."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                # std of the truncated normal with unit variance
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
    return net


def decode_heatmaps(hm: torch.Tensor) -> torch.Tensor:
    """(25, h, w) heatmaps -> (25, 3) [x_px, y_px, conf] via soft-argmax.

    Global spatial softmax per joint; confidence is the peak sigmoid
    response (what `DetectHumanPose.cpp` thresholds at render_threshold)."""
    j, h, w = hm.shape
    flat = hm.reshape(j, h * w)
    p = torch.softmax(flat * 4.0, dim=1).reshape(j, h, w)  # sharpen
    ys = torch.arange(h, dtype=torch.float32, device=hm.device)
    xs = torch.arange(w, dtype=torch.float32, device=hm.device)
    y = (p.sum(dim=2) @ ys) * STRIDE + STRIDE / 2 - 0.5
    x = (p.sum(dim=1) @ xs) * STRIDE + STRIDE / 2 - 0.5
    conf = torch.sigmoid(flat.amax(dim=1))
    return torch.stack([x, y, conf], dim=-1)


def infer(net: PoseNet, gray: torch.Tensor) -> torch.Tensor:
    """(H, W) gray image in [0, 255] on the net's device -> (25, 3)."""
    with torch.no_grad():
        x = (gray.to(torch.float32) / 255.0)[None, None]
        return decode_heatmaps(net(x)[0])


def make_backbone(net: PoseNet):
    """Wrap a trained net as the `OpDetector(backbone=...)` callable:
    gray (H, W) uint8/float -> np (25, 3) [x, y, conf]. The image goes to
    the net's device, and only the (25, 3) result comes back."""
    dev = next(net.parameters()).device

    def backbone(gray):
        return infer(net, torch.as_tensor(gray).to(dev)).cpu().numpy()

    return backbone


def gaussian_targets(joints: torch.Tensor, h: int, w: int,
                     sigma: float = 2.0) -> torch.Tensor:
    """(B, 25, 2) px joints -> (B, 25, h, w) Gaussian heatmaps at STRIDE."""
    dev = joints.device
    ys = torch.arange(h, dtype=torch.float32, device=dev) * STRIDE + STRIDE / 2 - 0.5
    xs = torch.arange(w, dtype=torch.float32, device=dev) * STRIDE + STRIDE / 2 - 0.5
    jy = joints[..., 1][:, :, None, None]
    jx = joints[..., 0][:, :, None, None]
    d2 = (ys[None, None, :, None] - jy) ** 2 + (xs[None, None, None, :] - jx) ** 2
    return torch.exp(-d2 / (2.0 * sigma * sigma * STRIDE * STRIDE))


def loss_fn(net: PoseNet, imgs: torch.Tensor, joints: torch.Tensor) -> torch.Tensor:
    """mean((sigmoid(4 hm) - target)^2) * 100 over a (B, H, W) [0, 255]
    batch and its (B, 25, 2) joints."""
    hm = net(imgs[:, None] / 255.0)
    tgt = gaussian_targets(joints, hm.shape[2], hm.shape[3])
    return torch.mean((torch.sigmoid(hm * 4.0) - tgt) ** 2) * 100.0


def train_step(net: PoseNet, opt: torch.optim.Optimizer, imgs: torch.Tensor,
               joints: torch.Tensor) -> torch.Tensor:
    """One optimizer step on one batch; returns the loss before it."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(net, imgs, joints)
    loss.backward()
    opt.step()
    return loss.detach()


def adam(net: PoseNet, lr: float) -> torch.optim.Adam:
    """optax.adam(lr)'s update: b1 0.9, b2 0.999, eps 1e-8 outside the root."""
    return torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train_on_synthetic(height: int = 96, width: int = 96, steps: int = 300,
                       batch: int = 16, net_width: int = 32, lr: float = 2e-3,
                       seed: int = 0, device="cuda") -> PoseNet:
    """Train PoseNet on the stick-figure renderer on `device`; returns the
    net. The batches are `render_batch(np.random.default_rng(seed), ...)`,
    the JAX version's; the initial weights come from a torch.Generator
    seeded with `seed` (not the JAX version's draws)."""
    dev = torch.device(device)
    gen = torch.Generator().manual_seed(seed)
    net = init_params(PoseNet(width=net_width), gen).to(dev)
    opt = adam(net, lr)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        imgs, joints = render_batch(rng, batch, height, width)
        train_step(net, opt, torch.from_numpy(imgs).to(dev), torch.from_numpy(joints).to(dev))
    return net


# ---------------------------------------------------------------------------
# Weights file: the JAX version's npz format (flax paths joined by "/" plus
# __meta__ = [height, width, net_width]), so either package loads a file the
# other wrote.
# ---------------------------------------------------------------------------

DEFAULT_WEIGHTS = Path(__file__).parent / "weights" / "pose_net_96.npz"


def save_params(path, net: PoseNet, height: int, width: int) -> None:
    from ..interop import pose_net_params_to_flax

    out = pose_net_params_to_flax(net.state_dict())
    out["__meta__"] = np.asarray([height, width, net.width])
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)


def load_params(path, device="cuda") -> tuple[PoseNet, tuple[int, int]]:
    """Returns (net on `device`, (height, width)) from a save_params file
    of either package."""
    from ..interop import pose_net_params_from_flax

    data = dict(np.load(Path(path)))
    height, width, net_width = (int(x) for x in data.pop("__meta__"))
    net = PoseNet(width=net_width)
    net.load_state_dict(pose_net_params_from_flax(data))
    return net.to(device), (height, width)


def make_pretrained_backbone(path=None, device="cuda"):
    """Backbone callable from a saved weights file, or None if absent."""
    p = Path(path) if path is not None else DEFAULT_WEIGHTS
    if not p.exists():
        return None
    net, _ = load_params(p, device)
    return make_backbone(net)
