"""Sparse UNet, eval and train forwards (counterpart of
eyoc_tpu/models/unet.py).

`ResUNet` is an nn.Module whose submodule names mirror the JAX parameter
tree (conv1, norm1, block1.{conv1,norm1,conv2,norm2}, conv2, ..., conv4_tr,
norm4_tr, block4_tr, ..., conv1_tr, final), so a JAX checkpoint maps 1:1
(models/convert.py). Conv weights keep the JAX layout [K^3, Ci, Co] and tap
order.

`forward` branches on `self.training`:
- eval (`embed`, which the eval entry points call in either mode): every
  BatchNorm folded into the conv that feeds it (`_bn_fold`,
  unet.py:194-198); each conv is one K1 launch whose epilogue adds the
  folded bias, masks invalid voxels, adds the block residual and applies
  ReLU. No autograd.
- train (apply_unet(training=True), unet.py:201-231, 242-380): each conv
  is a `SparseConvFunction` (K1 forward; K1 over the inverse map and K5
  backward) with no mask before the masked BatchNorm that follows it
  (sparse/norm.py, K7 sums), then ReLU, the residual and the masks as plain
  torch ops in the JAX order. The BN running statistics are updated in
  place, once per forward.
Activations are stored in the model's compute dtype between convs (bf16 on
the card, with f32 sums inside the kernels; the CPU tests use f32).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from eyoc_tpu_torch.sparse.brick_conv import (SparseConvFunction, conv_maps,
                                              identity_map, sparse_conv)
from eyoc_tpu_torch.sparse.bricks import BrickPyramid
from eyoc_tpu_torch.sparse.norm import masked_batch_norm
from eyoc_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class UNetSpec:
    name: str
    norm_type: str                      # 'BN' | 'IN' (top-level norms)
    block_norm_type: Optional[str]      # None => no residual blocks (SimpleNet)
    channels: Tuple[int, ...]           # encoder channels per level
    tr_channels: Tuple[int, ...]        # decoder channels per level
    repeats: int = 1
    conv1_tr_kernel: int = 1
    conv1_tr_norm: bool = False

    @property
    def num_levels(self) -> int:
        return len(self.channels)


def can_fold_bn(spec: UNetSpec) -> bool:
    """Folding applies when every norm directly follows a conv and is a BN."""
    return (spec.norm_type == "BN" and spec.repeats == 1
            and spec.block_norm_type in (None, "BN"))


class SparseConv(nn.Module):
    def __init__(self, k3: int, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(k3, cin, cout))


class BatchNorm(nn.Module):
    """Affine + running statistics of a masked BatchNorm."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def fold(self):
        """(g, b) with BN(x) = x * g + b."""
        g = self.weight * torch.rsqrt(self.running_var + self.eps)
        return g, self.bias - self.running_mean * g


class BasicBlock(nn.Module):
    """Residual block conv3-norm-relu-conv3-norm + skip, relu
    (reference model/residual_block.py)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = SparseConv(27, c, c)
        self.norm1 = BatchNorm(c)
        self.conv2 = SparseConv(27, c, c)
        self.norm2 = BatchNorm(c)


class Final(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))


class ResUNet(nn.Module):
    """Sparse UNet of one UNetSpec (BN-foldable specs: the plain-BN ResUNet
    and SimpleNet families)."""

    def __init__(self, spec: UNetSpec, in_channels: int = 1,
                 out_channels: int = 32, conv1_kernel_size: int = 5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if not can_fold_bn(spec):
            raise ValueError(f"{spec.name}: only BN-foldable specs have a "
                             "forward in this port so far")
        self.spec = spec
        self.conv1_kernel_size = conv1_kernel_size
        self.dtype = dtype
        L, ch, tr = spec.num_levels, spec.channels, spec.tr_channels
        blocks = spec.block_norm_type is not None
        self.conv1 = SparseConv(conv1_kernel_size ** 3, in_channels, ch[0])
        self.norm1 = BatchNorm(ch[0])
        if blocks:
            self.block1 = BasicBlock(ch[0])
        for l in range(2, L + 1):
            setattr(self, f"conv{l}", SparseConv(27, ch[l - 2], ch[l - 1]))
            setattr(self, f"norm{l}", BatchNorm(ch[l - 1]))
            if blocks:
                setattr(self, f"block{l}", BasicBlock(ch[l - 1]))
        for l in range(L, 1, -1):
            cin = ch[l - 1] if l == L else ch[l - 1] + tr[l]
            setattr(self, f"conv{l}_tr", SparseConv(27, cin, tr[l - 1]))
            setattr(self, f"norm{l}_tr", BatchNorm(tr[l - 1]))
            if blocks:
                setattr(self, f"block{l}_tr", BasicBlock(tr[l - 1]))
        self.conv1_tr = SparseConv(spec.conv1_tr_kernel ** 3, ch[0] + tr[1],
                                   tr[0])
        if spec.conv1_tr_norm:
            self.norm1_tr = BatchNorm(tr[0])
        self.final = Final(tr[0], out_channels)
        self._folded = None
        # eval unless asked: the default of apply_unet (training=False)
        self.train(False)

    # -- folded weights, cached until the parameters move, reload or train
    def _apply(self, fn, *args, **kwargs):
        self._folded = None
        return super()._apply(fn, *args, **kwargs)

    def train(self, mode: bool = True):
        self._folded = None
        return super().train(mode)

    def load_state_dict(self, *args, **kwargs):
        self._folded = None
        return super().load_state_dict(*args, **kwargs)

    def _fold(self):
        """name -> (weight [T, Ci, Co] in the compute dtype, bias f32|None)."""
        folded = {}

        def put(key, conv, norm=None):
            W = conv.weight.detach().float()
            if norm is None:
                folded[key] = (W.to(self.dtype).contiguous(), None)
                return
            g, b = norm.fold()
            folded[key] = ((W * g.detach()).to(self.dtype).contiguous(),
                           b.detach().float().contiguous())

        for name, mod in self.named_modules():
            if isinstance(mod, BasicBlock):
                put(f"{name}.conv1", mod.conv1, mod.norm1)
                put(f"{name}.conv2", mod.conv2, mod.norm2)
        L = self.spec.num_levels
        put("conv1", self.conv1, self.norm1)
        for l in range(2, L + 1):
            put(f"conv{l}", getattr(self, f"conv{l}"),
                getattr(self, f"norm{l}"))
            put(f"conv{l}_tr", getattr(self, f"conv{l}_tr"),
                getattr(self, f"norm{l}_tr"))
        put("conv1_tr", self.conv1_tr,
            self.norm1_tr if self.spec.conv1_tr_norm else None)
        folded["final"] = (
            self.final.weight.detach().float()[None].to(self.dtype).contiguous(),
            self.final.bias.detach().float().contiguous())
        return folded

    def forward(self, pyr: BrickPyramid, in_feats: torch.Tensor | None = None,
                bn_momentum: float | None = 0.05) -> torch.Tensor:
        """L2-normalized features [M0, out_channels] f32 for the level-0
        voxel rows (zero rows at invalid voxels). The input feature is
        `in_feats` [M0, 1] (e.g. jittered occupancy) masked to the valid
        voxels, or the occupancy when None (the test protocol). The eval
        entry points call `embed`, which ignores the mode. In train mode
        with bn_momentum None, BN takes batch statistics and leaves the
        running ones as they are (the EYOC labeler's forwards)."""
        if self.training:
            return self._forward_train(pyr, in_feats, bn_momentum)
        return self.embed(pyr, in_feats)

    def _input(self, pyr: BrickPyramid, in_feats) -> torch.Tensor:
        """JAX's vox_to_fb drops invalid rows (unet.py:326-329)."""
        m = pyr.vox_masks[0][:, None]
        x = m if in_feats is None else in_feats * m
        return x.to(self.dtype).contiguous()

    @torch.no_grad()
    def embed(self, pyr: BrickPyramid,
              in_feats: torch.Tensor | None = None) -> torch.Tensor:
        """The eval forward (apply_unet(training=False)) whatever the
        module's mode: BN from the running statistics, which it leaves as
        they are."""
        if self._folded is None:
            self._folded = self._fold()
        fw = self._folded
        spec = self.spec
        L = spec.num_levels
        blocks = spec.block_norm_type is not None
        maps = conv_maps(pyr, L, self.conv1_kernel_size)
        masks = maps.vox_masks

        def conv(key, x, nmap, level, *, x2=None, residual=None, relu=False):
            W, b = fw[key]
            return sparse_conv(x, W, nmap, x2=x2, bias=b, mask=masks[level],
                               residual=residual, relu=relu)

        def level_tail(prefix, x, level):
            """(post-relu, skip): the block output for ResUNets, the
            pre-relu tensor for SimpleNets."""
            if blocks:
                nmap = maps.same3[level]
                y = conv(f"block{prefix}.conv1", x, nmap, level, relu=True)
                y = conv(f"block{prefix}.conv2", y, nmap, level, residual=x,
                         relu=True)
                return y, y
            return torch.relu(x), x

        x = self._input(pyr, in_feats)
        skips = []
        out = conv("conv1", x, maps.first, 0)
        out, skip = level_tail("1", out, 0)
        skips.append(skip)
        for l in range(2, L + 1):
            out = conv(f"conv{l}", out, maps.down[l - 2], l - 1)
            out, skip = level_tail(str(l), out, l - 1)
            skips.append(skip)

        x2 = None                     # ME.cat(decoder, encoder) skip join
        for l in range(L, 1, -1):
            out = conv(f"conv{l}_tr", out, maps.up[l - 2], l - 2, x2=x2)
            out, _ = level_tail(f"{l}_tr", out, l - 2)
            x2 = skips[l - 2]

        if spec.conv1_tr_kernel == 1:
            nmap = identity_map(out.shape[0], out.device)
        else:
            nmap = maps.same3[0]
        out = conv("conv1_tr", out, nmap, 0, x2=x2, relu=True)
        out = conv("final", out, identity_map(out.shape[0], out.device), 0)

        feats = out.float()
        return feats / (torch.linalg.norm(feats, dim=-1, keepdim=True) + 1e-12)

    def _forward_train(self, pyr: BrickPyramid, in_feats,
                       bn_momentum: float | None) -> torch.Tensor:
        """apply_unet(training=True): unfolded convs, masked BN with batch
        statistics (running stats updated in place), autograd through the
        kernels."""
        spec = self.spec
        L = spec.num_levels
        blocks = spec.block_norm_type is not None
        # the inverses serve the backward's dX only: a forward under no_grad
        # (the EYOC labeler's) builds none
        grad = torch.is_grad_enabled()
        maps = conv_maps(pyr, L, self.conv1_kernel_size, inverse=grad)
        if not grad:
            none = (None,) * L
            maps = maps._replace(inv_same3=none, inv_down=none, inv_up=none)
        vmask = maps.vox_masks
        fmask = [m[:, None].to(self.dtype) for m in vmask]

        def conv(mod, x, nmap, inv, x2=None):
            return SparseConvFunction.apply(x, x2, mod.weight, nmap, inv)

        def norm(mod, x, level):
            return masked_batch_norm(x, vmask[level], mod.weight, mod.bias,
                                     mod.running_mean, mod.running_var,
                                     momentum=bn_momentum)

        def level_tail(prefix, x, level):
            """norm (-> block); returns (post-relu, skip) as unet.py:300-322."""
            x = norm(getattr(self, f"norm{prefix}"), x, level)
            if not blocks:
                return torch.relu(x), x         # SimpleNet: pre-relu skip
            b = getattr(self, f"block{prefix}")
            nmap, inv = maps.same3[level], maps.inv_same3[level]
            y = torch.relu(norm(b.norm1, conv(b.conv1, x, nmap, inv), level))
            y = norm(b.norm2, conv(b.conv2, y, nmap, inv), level)
            y = torch.relu(y + x) * fmask[level]
            return y, y

        x = self._input(pyr, in_feats)
        skips = []
        out = conv(self.conv1, x, maps.first, None)
        out, skip = level_tail("1", out, 0)
        skips.append(skip)
        for l in range(2, L + 1):
            out = conv(getattr(self, f"conv{l}"), out, maps.down[l - 2],
                       maps.inv_down[l - 2])
            out, skip = level_tail(str(l), out, l - 1)
            skips.append(skip)

        x2 = None                     # ME.cat(decoder, encoder) skip join
        for l in range(L, 1, -1):
            out = conv(getattr(self, f"conv{l}_tr"), out, maps.up[l - 2],
                       maps.inv_up[l - 2], x2)
            out, _ = level_tail(f"{l}_tr", out, l - 2)
            x2 = skips[l - 2]

        if spec.conv1_tr_kernel == 1:
            nmap = inv = identity_map(out.shape[0], out.device)
        else:
            nmap, inv = maps.same3[0], maps.inv_same3[0]
        out = conv(self.conv1_tr, out, nmap, inv, x2) * fmask[0]
        if spec.conv1_tr_norm:
            out = norm(self.norm1_tr, out, 0)
        out = torch.relu(out)
        ident = identity_map(out.shape[0], out.device)
        out = SparseConvFunction.apply(out, None, self.final.weight[None],
                                       ident, ident)
        feats = (out.float() + self.final.bias) * fmask[0].float()
        return feats / (torch.linalg.norm(feats, dim=-1, keepdim=True) + 1e-12)


def init_unet(spec: UNetSpec, generator: torch.Generator | None = None,
              in_channels: int = 1, out_channels: int = 32,
              conv1_kernel_size: int = 5, dtype: torch.dtype = torch.bfloat16,
              device=None) -> ResUNet:
    """A ResUNet with He-normal conv weights (std sqrt(2 / (K^3 Ci)), as
    unet.py:66-68) drawn from `generator` on the CPU, then moved to
    `device` (default: the GPU, or an error when there is none)."""
    device = resolve_device(device)
    model = ResUNet(spec, in_channels, out_channels, conv1_kernel_size, dtype)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, SparseConv):
                k3, cin, cout = mod.weight.shape
                std = (2.0 / (k3 * cin)) ** 0.5
                mod.weight.copy_(std * torch.randn(
                    (k3, cin, cout), generator=generator))
        cin, cout = model.final.weight.shape
        model.final.weight.copy_((2.0 / cin) ** 0.5 * torch.randn(
            (cin, cout), generator=generator))
    return model.to(device).eval()
