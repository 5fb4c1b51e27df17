"""BEV-grid CNN detector (the reference's dormant alternative branch).

The JAX package's ``models/cnn.py`` (modules/neural_net/cnn/*, "NOTE: not
used in the current version" but a full capability): a ResNet-ish
bottleneck backbone over the [X, Y, 3] likelihood/range/azimuth image, an
FPN-style top-down neck fused with the raw image, and a per-cell head that
augments features with normalised (vr, rcs) before classifying every grid
cell and regressing offsets.  Norms are the scalar-affine channel norm over
the channel axis, or weight-standardised conv + GroupNorm(16)
(common.py:12-59).  The head computes logits for ALL cells and the loss
masks invalid ones, as in the JAX package.

The interface is the JAX package's: images [B, X, Y, 3], grids [B, X, Y],
outputs [B, X, Y, C].  Inside, the maps are NCHW for cuDNN's convolutions
(the JAX package's ``lax.conv``; no Pallas kernel either side), with:

* flax's ``padding="SAME"``, which for stride 2 pads asymmetrically
  (total = max((ceil(H/s) − 1)·s + k − H, 0), low total//2, the rest high):
  an explicit ``F.pad`` before each convolution (PyTorch refuses
  ``padding="same"`` above stride 1);
* ``jax.image.resize(bilinear)`` as ``F.interpolate(bilinear,
  align_corners=False)``: the two agree while upsampling, and every call
  site upsamples (``_resize`` raises otherwise: JAX antialiases when it
  downsamples);
* flax ``GroupNorm``'s statistics as it computes them (E[x²] − E[x]²,
  clipped at 0).

On the card the path needs TF32 off (``torch.backends.cudnn.allow_tf32 =
False``, cuDNN's default is on) for f32 results.

The train step is the JAX package's jitted one: optax's
chain(add_decayed_weights, sgd) on flat buffers (``train/steps.Optimizer``)
and the branchless NaN skip (``train/steps.update_if_finite``); on a CUDA
device it is captured as one CUDA graph per state and batch shape and
replayed (``train/steps.CapturedStep``), on the CPU it runs eagerly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.graph import device_constant, resolve_device
from ..data.labels import INVALID_NUM
from ..train.steps import CapturedStep, Optimizer, TrainState, update_if_finite
from .blocks import CLS_BIAS, HEAD_STD, Linear, activation_fn

_NUM_GROUPS = 16  # constants.py:11
SEED = 1234  # GNNConfig.seed's default


@dataclasses.dataclass
class CNNConfig:
    """configuration_radarscenes_cnn.yml CNN_ARCHITECTURE defaults."""

    input_image_dimension: int = 3
    base_stem_channels: Sequence[int] = (32, 64)
    base_kernel_sizes: Sequence[int] = (11, 7)
    bottleneck_number_of_blocks: Sequence[int] = (2, 2, 2, 2)
    bottleneck_stem_channels: Sequence[int] = (128, 256, 512, 1024)
    bottleneck_width_channels: int = 64
    bottleneck_kernel_size: int = 3
    neck_out_channels: int = 64
    neck_kernel_size: int = 3
    head_stem_channels: Sequence[int] = (64,)
    head_ffn_channels: Sequence[int] = (64,)
    head_kernel_size: int = 3
    reg_offset_dim: int = 2
    num_classes: int = 8  # full taxonomy incl. STATIC (set_config_cnn)
    activation: str = "leakyrelu"
    conv_type: str = "conv2d"
    reg_mu: Tuple[float, float] = (0.0, 0.0)
    reg_sigma: Tuple[float, float] = (8.0, 4.0)
    cls_loss_weight: float = 1.0
    reg_loss_weight: float = 10.0
    class_weights: Sequence[float] = (1.0,) * 6 + (0.5, 0.5)
    learning_rate: float = 0.001
    weight_decay: float = 1e-4
    momentum: float = 0.9
    max_train_iter: int = 100_000


def same_pad(x, kernel_size: int, stride: int):
    """flax ``padding="SAME"`` for an NCHW map: per spatial dim, total
    max((ceil(H/s) − 1)·s + k − H, 0), low total//2, the rest high."""
    pads = []
    for size in (x.shape[3], x.shape[2]):  # F.pad takes the last dim first
        total = max((-(-size // stride) - 1) * stride + kernel_size - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def channel_norm(x, gamma, beta, eps: float = 1e-5):
    """Scalar-affine channel norm over dim 1 of an NCHW map, Bessel std with
    eps outside the sqrt (common.py:208-220 applied to conv maps)."""
    mean = x.mean(dim=1, keepdim=True)
    n = x.shape[1]
    var = ((x - mean) ** 2).sum(dim=1, keepdim=True) / max(n - 1, 1)
    return gamma * ((x - mean) / (torch.sqrt(var) + eps)) + beta


def group_norm(x, scale, bias, num_groups: int, eps: float = 1e-5):
    """flax ``GroupNorm`` over an NCHW map: each group's mean and variance
    over (C/G, H, W), the variance as E[x²] − E[x]² clipped at 0, then
    (x − mean)·(rsqrt(var + eps)·scale) + bias per channel."""
    b, c, h, w = x.shape
    g = x.reshape(b, num_groups, c // num_groups, h, w)
    mean = g.mean(dim=(2, 3, 4), keepdim=True)
    var = torch.clamp((g * g).mean(dim=(2, 3, 4), keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * scale.reshape(1, num_groups, c // num_groups, 1, 1)
    y = (g - mean) * mul + bias.reshape(1, num_groups, c // num_groups, 1, 1)
    return y.reshape(b, c, h, w)


class Conv(nn.Module):
    """A k×k convolution with flax's SAME padding; weight [O, I, k, k]
    (flax HWIO transposed)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1):
        super().__init__()
        self.stride, self.kernel_size = stride, kernel_size
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch))

    def forward(self, x):
        return F.conv2d(same_pad(x, self.kernel_size, self.stride), self.weight,
                        self.bias, stride=self.stride)


class ConvBlock(nn.Module):
    """conv → channel norm → act (common.py conv_nxn_block)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int, stride: int = 1,
                 activation: str = "leakyrelu"):
        super().__init__()
        self.conv = Conv(in_ch, features, kernel_size, stride)
        self.gamma = nn.Parameter(torch.ones(1))
        self.beta = nn.Parameter(torch.zeros(1))
        self.act = activation_fn(activation)

    def forward(self, x):
        return self.act(channel_norm(self.conv(x), self.gamma, self.beta))


class WSConvBlock(nn.Module):
    """Weight-standardised conv + GroupNorm(16) + act
    (common.py ws_conv_nxn_block); ``features`` a multiple of 16."""

    def __init__(self, in_ch: int, features: int, kernel_size: int, stride: int = 1,
                 activation: str = "leakyrelu"):
        super().__init__()
        self.conv = Conv(in_ch, features, kernel_size, stride)
        self.gn_scale = nn.Parameter(torch.ones(features))
        self.gn_bias = nn.Parameter(torch.zeros(features))
        self.act = activation_fn(activation)

    def forward(self, x):
        w = self.conv.weight
        # standardise over (cin, kh, kw) per output channel, Bessel std with
        # eps outside the sqrt (common.py:52-58 uses torch.std)
        flat = w.reshape(w.shape[0], -1)
        mean = flat.mean(dim=1, keepdim=True)
        var = ((flat - mean) ** 2).sum(dim=1, keepdim=True) / max(flat.shape[1] - 1, 1)
        std_w = ((flat - mean) / (torch.sqrt(var) + 1e-5)).reshape(w.shape)
        c = self.conv
        out = F.conv2d(same_pad(x, c.kernel_size, c.stride), std_w, c.bias, stride=c.stride)
        return self.act(group_norm(out, self.gn_scale, self.gn_bias, _NUM_GROUPS))


class Bottleneck(nn.Module):
    """1x1 → kxk(, stride) → 1x1 with a channel-normed 1x1 projector
    (backbone.py:41-95)."""

    def __init__(self, in_ch: int, out_channels: int, width: int, kernel_size: int,
                 stride: int, activation: str):
        super().__init__()
        if in_ch != out_channels or stride != 1:
            self.proj = Conv(in_ch, out_channels, 1, stride)
            self.proj_gamma = nn.Parameter(torch.ones(1))
            self.proj_beta = nn.Parameter(torch.zeros(1))
        else:
            self.proj = None
        self.blocks = nn.Sequential(
            ConvBlock(in_ch, width, 1, 1, activation),
            ConvBlock(width, width, kernel_size, stride, activation),
            ConvBlock(width, out_channels, 1, 1, activation))

    def forward(self, x):
        identity = x
        if self.proj is not None:
            identity = channel_norm(self.proj(x), self.proj_gamma, self.proj_beta)
        return self.blocks(x) + identity


class Backbone(nn.Module):
    """base (stride-2 stem) + stride-2 bottleneck stages → pyramid list
    [c0, c1, ...] (backbone.py:136-177)."""

    def __init__(self, cfg: CNNConfig):
        super().__init__()
        c, in_ch = cfg, cfg.input_image_dimension
        base = []
        for i, (ch, k) in enumerate(zip(c.base_stem_channels, c.base_kernel_sizes)):
            base.append(ConvBlock(in_ch, ch, k, 2 if i == 0 else 1, c.activation))
            in_ch = ch
        self.base = nn.Sequential(*base)
        stages = []
        for nblk, ch in zip(c.bottleneck_number_of_blocks, c.bottleneck_stem_channels):
            blocks = []
            for b in range(nblk):
                blocks.append(Bottleneck(in_ch, ch, c.bottleneck_width_channels,
                                         c.bottleneck_kernel_size, 2 if b == 0 else 1,
                                         c.activation))
                in_ch = ch
            stages.append(nn.Sequential(*blocks))
        self.stages = nn.ModuleList(stages)

    def forward(self, image):
        x = self.base(image)
        feats = [x]
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return feats


def _resize(x, hw):
    """``jax.image.resize(bilinear)`` of an NCHW map to ``hw``: half-pixel
    centres, equal to F.interpolate's while it upsamples; a smaller size
    raises (JAX antialiases then, F.interpolate does not)."""
    if hw[0] < x.shape[2] or hw[1] < x.shape[3]:
        raise ValueError(f"_resize downsamples {tuple(x.shape[2:])} -> {tuple(hw)}")
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)


class Neck(nn.Module):
    """Top-down FPN-ish aggregation fused with the raw image
    (aggregation.py:14-112): ``reduce[i]`` for level c_i, ``fuse[i]`` after
    the resize onto level c_{i-1} (``fuse[0]`` onto the image), then
    ``fuse_image``."""

    def __init__(self, cfg: CNNConfig, widths: Sequence[int]):
        super().__init__()
        c, out = cfg, cfg.neck_out_channels
        k, act = c.neck_kernel_size, c.activation
        self.reduce = nn.ModuleList([ConvBlock(w, out, k, 1, act) for w in widths])
        top = len(widths) - 1
        self.fuse = nn.ModuleList([ConvBlock(out if i == top else 2 * out, out, k, 1, act)
                                   for i in range(len(widths))])
        self.fuse_image = ConvBlock(out + c.input_image_dimension, out, k, 1, act)

    def forward(self, feats, image):
        reduced = [blk(f) for blk, f in zip(self.reduce, feats)]
        top = len(feats) - 1
        x = self.fuse[top](_resize(reduced[top], reduced[top - 1].shape[2:]))
        for i in range(top - 1, 0, -1):
            x = torch.cat([x, reduced[i]], dim=1)
            x = self.fuse[i](_resize(x, reduced[i - 1].shape[2:]))
        x = torch.cat([x, reduced[0]], dim=1)
        x = self.fuse[0](_resize(x, image.shape[2:]))
        return self.fuse_image(torch.cat([x, image], dim=1))


def normalize_vr_rcs(vr, rcs):
    """head.py:253-259 dataset normalisation constants."""
    return (vr + 107.0) / 220.0, (rcs + 31.0) / 79.0


class HeadV2(nn.Module):
    """Per-cell FFN head over a conv stem + (vr, rcs) augmentation
    (head.py:184-250); computed densely over NHWC cells, masked in the loss."""

    def __init__(self, cfg: CNNConfig, in_ch: int):
        super().__init__()
        c = cfg
        stem = []
        for ch in c.head_stem_channels:
            stem.append(ConvBlock(in_ch, ch, c.head_kernel_size, 1, c.activation))
            in_ch = ch
        self.stem = nn.Sequential(*stem)
        in_ch += 2
        ffn = []
        for ch in c.head_ffn_channels:  # FFNStemBlock: Dense + act, no norm
            ffn.append(Linear(in_ch, ch))
            in_ch = ch
        self.ffn = nn.ModuleList(ffn)
        self.cls_in, self.cls = Linear(in_ch, in_ch), Linear(in_ch, c.num_classes)
        self.reg_in, self.reg = Linear(in_ch, in_ch), Linear(in_ch, c.reg_offset_dim)
        self.act = activation_fn(c.activation)

    def forward(self, x, vr_grid, rcs_grid):
        x = self.stem(x).permute(0, 2, 3, 1)  # NHWC cells
        vr, rcs = normalize_vr_rcs(vr_grid, rcs_grid)
        x = torch.cat([x, vr[..., None], rcs[..., None]], dim=-1)
        for blk in self.ffn:
            x = self.act(blk(x))
        cls = self.cls(self.act(self.cls_in(x)))
        reg = self.reg(self.act(self.reg_in(x)))
        return cls, reg


class GridOutputs(NamedTuple):
    cls: torch.Tensor  # [B, X, Y, num_classes]
    reg: torch.Tensor  # [B, X, Y, 2]


class GridDetector(nn.Module):
    """Backbone → Neck → HeadV2 (set_param_for_training_cnn wiring) over
    NHWC images.  Parameters from ``generator`` (default: seeded with SEED):
    convolution and dense weights LeCun-normal (flax's default), biases 0,
    norms γ=1/β=0, the output layers N(0, HEAD_STD) with the class bias
    −log 99."""

    def __init__(self, cfg: CNNConfig, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.backbone = Backbone(cfg)
        widths = ([cfg.base_stem_channels[-1]]
                  + [ch for _, ch in zip(cfg.bottleneck_number_of_blocks,
                                         cfg.bottleneck_stem_channels)])
        self.neck = Neck(cfg, widths)
        self.head = HeadV2(cfg, cfg.neck_out_channels)
        if generator is None:
            generator = torch.Generator().manual_seed(SEED)
        init_cnn_parameters(self, generator)

    def forward(self, image, vr_grid, rcs_grid) -> GridOutputs:
        x = image.permute(0, 3, 1, 2)
        x = self.neck(self.backbone(x), x)
        return GridOutputs(*self.head(x, vr_grid, rcs_grid))


def init_cnn_parameters(model: GridDetector, generator: torch.Generator) -> None:
    """flax's initialisers, in module order: LeCun normal (a normal of
    variance 1/fan_in truncated at ±2σ, rescaled) for convolution and dense
    weights, zeros for biases; then the head's output layers N(0, HEAD_STD)
    with the class bias −log 99."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Conv, Linear)):
                std = math.sqrt(1.0 / m.weight[0].numel()) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                m.bias.zero_()
        for out, bias in ((model.head.cls, CLS_BIAS), (model.head.reg, 0.0)):
            out.weight.normal_(0.0, HEAD_STD, generator=generator)
            out.bias.fill_(bias)


def grid_loss(out: GridOutputs, gt_label_grid, gt_offset_grid, cfg: CNNConfig,
              static_id: int = 7, false_id: int = 6):
    """Loss_Grid (cnn/loss.py:11-68): weighted CE over valid cells, 0.5·MSE
    over valid dynamic-object cells, weights 1.0/10.0."""
    dev = out.cls.device
    cw = device_constant(tuple(cfg.class_weights), torch.float32, dev)
    valid_cell = gt_label_grid != INVALID_NUM
    labels = torch.where(valid_cell, gt_label_grid, 0.0).to(torch.int32)
    valid_obj = valid_cell & (labels != static_id) & (labels != false_id)

    logp = torch.log_softmax(out.cls, dim=-1)
    onehot = (labels[..., None].long() == torch.arange(cfg.num_classes, device=dev)).float()
    nll = -(onehot * logp).sum(-1) * cw[labels.long()]
    n_cell = valid_cell.sum()
    zero = torch.zeros((), device=dev)
    cls_loss = torch.where(n_cell > 0, torch.where(valid_cell, nll, zero).sum()
                           / torch.clamp(n_cell, min=1), zero)

    mu = device_constant(tuple(cfg.reg_mu), torch.float32, dev)
    sigma = device_constant(tuple(cfg.reg_sigma), torch.float32, dev)
    gt_norm = (gt_offset_grid - mu) / sigma
    se = 0.5 * ((out.reg - gt_norm) ** 2).sum(-1)
    n_obj = valid_obj.sum()
    reg_loss = torch.where(n_obj > 0, torch.where(valid_obj, se, zero).sum()
                           / torch.clamp(n_obj, min=1), zero)
    total = cls_loss * cfg.cls_loss_weight + reg_loss * cfg.reg_loss_weight
    return total, {
        "loss_cls": cls_loss * cfg.cls_loss_weight,
        "loss_reg": reg_loss * cfg.reg_loss_weight,
        "loss_total": total,
    }


def make_grid_train_step(cfg: CNNConfig) -> Tuple[Callable, Callable, Callable]:
    """(init, step, loss_fn), as the JAX package's (its model is the state's
    here).  ``init(generator=None, device="cuda")`` → TrainState with SGD
    (momentum, coupled weight decay: optax's chain(add_decayed_weights,
    sgd)) over one flat buffer of the parameters; ``step(state, image, vr,
    rcs, label_grid, offset_grid)`` → (state, metrics), numpy or tensors
    in, skipped whole (``skipped`` = 1.0, nothing changes, the step is
    counted) where the loss or a gradient is not finite.  On the card
    ``step.captured`` is the step's ``CapturedStep``."""

    def init(generator: Optional[torch.Generator] = None, device="cuda"):
        model = GridDetector(cfg, generator=generator).to(resolve_device(device))
        return TrainState(model, Optimizer(model.parameters(), "sgd", cfg.learning_rate,
                                           cfg.weight_decay, momentum=cfg.momentum))

    def loss_fn(model: GridDetector, image, vr, rcs, label_grid, offset_grid):
        return grid_loss(model(image, vr, rcs), label_grid, offset_grid, cfg)

    def body(state: TrainState, arrays) -> Dict[str, torch.Tensor]:
        loss, metrics = loss_fn(state.model, *arrays)
        ok = update_if_finite(state, loss)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["skipped"] = (~ok).to(torch.float32)
        return metrics

    captured = CapturedStep(body, leaves=list, rebuild=list)

    def step(state: TrainState, *arrays):
        if state.device.type == "cpu":
            return state, body(state, [torch.as_tensor(a).to(state.device) for a in arrays])
        return state, captured(state, arrays)

    step.captured = captured
    return init, step, loss_fn
