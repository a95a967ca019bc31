"""Sparse UNet, eval and train forwards (counterpart of
eyoc_tpu/models/unet.py).

`ResUNet` is an nn.Module whose submodule names mirror the JAX parameter
tree (conv1, norm1, block1.{conv1,norm1,conv2,norm2}, conv2, ..., conv4_tr,
norm4_tr, block4_tr, ..., conv1_tr, final), so a JAX checkpoint maps 1:1
(models/convert.py). Conv weights keep the JAX layout [K^3, Ci, Co] and tap
order.

`forward` branches on `self.training`:
- eval (`embed`, which the eval entry points call in either mode): every
  BatchNorm that follows a conv folded into it (`_bn_fold`,
  unet.py:194-198); each conv is one K1 launch whose epilogue adds the
  folded bias, masks invalid voxels, adds the block residual and applies
  ReLU. An instance norm (the IN families: ResUNetIN*'s block norms,
  SimpleNetIN*'s norms) follows its bare conv as kernel K20, per cloud
  (apply_unet(training=False, n_clouds=B)), with the ReLU, or the block's
  residual add, ReLU and mask, in its apply. The Expanded spec's repeat
  norm `norm{l}_{r}` (unet.py:313-315) follows a block's ReLU, not a conv,
  so it folds into nothing: it is K22 `masked_norm_apply` with g and off
  from its running statistics. No autograd.
- train (apply_unet(training=True, n_clouds=B), unet.py:201-231,
  242-380): each conv is a `SparseConvFunction` (K1 forward; K1 over the
  inverse map and K5 backward; through `sparse_conv_diff`, which pads an
  output width that is not a multiple of 8, the last conv's n_out, with
  zero columns inside autograd) with no mask before the norm that follows
  it: a masked BatchNorm (K7 sums, K22 apply) or a per-cloud instance norm
  (K20), each with the ReLU, or the block's residual add, ReLU and mask,
  fused into its apply and its backward (K21). The norm's output is
  rounded to the activation dtype before the tail, as JAX's. The BN
  running statistics are updated in place, once per forward. With a
  process group (data parallelism, parallel/ddp.py) every BatchNorm takes
  the statistics of the whole global batch (sparse/norm.py's sync-BN, as
  JAX's psum over `axis_name`).
The features are L2-normalized unless the model (or the call) says
`normalize_feature=False` (unet.py:378).
Activations are stored in the model's compute dtype between convs (bf16 on
the card, with f32 sums inside the kernels; the CPU tests use f32).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from eyoc_tpu_torch.sparse.brick_conv import (conv_maps, identity_map,
                                              sparse_conv, sparse_conv_diff)
from eyoc_tpu_torch.sparse.bricks import BrickPyramid
from eyoc_tpu_torch.sparse.norm import (instance_norm_train,
                                        masked_batch_norm,
                                        masked_instance_norm,
                                        masked_norm_apply)
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


class InstanceNorm(nn.Module):
    """Affine of a per-cloud masked instance norm (no running statistics:
    its JAX state is None)."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))


def make_norm(kind: str, c: int) -> nn.Module:
    """A norm of the spec's kind, 'BN' or 'IN'."""
    if kind == "BN":
        return BatchNorm(c)
    if kind == "IN":
        return InstanceNorm(c)
    raise ValueError(f"unknown norm type {kind!r}")


class BasicBlock(nn.Module):
    """Residual block conv3-norm-relu-conv3-norm + skip, relu
    (reference model/residual_block.py)."""

    def __init__(self, c: int, kind: str = "BN"):
        super().__init__()
        self.conv1 = SparseConv(27, c, c)
        self.norm1 = make_norm(kind, c)
        self.conv2 = SparseConv(27, c, c)
        self.norm2 = make_norm(kind, c)


class Final(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))


class ResUNet(nn.Module):
    """Sparse UNet of one UNetSpec: the ResUNet family (one (norm, block)
    a level, or `repeats` of them, the Expanded spec), the SimpleNet
    family, BN or IN. `in_channels` is the input features' width (1: the
    occupancy; 3 or 6: rgb and / or normals, api.extract_features);
    `normalize_feature` whether the features come out L2-normalized."""

    def __init__(self, spec: UNetSpec, in_channels: int = 1,
                 out_channels: int = 32, conv1_kernel_size: int = 5,
                 dtype: torch.dtype = torch.bfloat16,
                 normalize_feature: bool = True):
        super().__init__()
        if spec.repeats > 1 and (spec.block_norm_type is None
                                 or spec.norm_type != "BN"):
            raise ValueError(f"{spec.name}: (norm, block) repeats take "
                             "residual blocks and a BatchNorm, as every "
                             "registered spec with repeats has")
        self.spec = spec
        self.conv1_kernel_size = conv1_kernel_size
        self.dtype = dtype
        self.normalize_feature = normalize_feature
        L, ch, tr = spec.num_levels, spec.channels, spec.tr_channels
        blocks = spec.block_norm_type is not None
        top, inner = spec.norm_type, spec.block_norm_type

        def add_tail(prefix, c):
            """norm{prefix}, then block{prefix} and the repeats' (norm,
            block) pairs norm{prefix}_{r}, block{prefix}_{r} (the JAX
            names, unet.py:118-141)."""
            setattr(self, f"norm{prefix}", make_norm(top, c))
            if not blocks:
                return
            setattr(self, f"block{prefix}", BasicBlock(c, inner))
            for r in range(2, spec.repeats + 1):
                setattr(self, f"norm{prefix}_{r}", make_norm(top, c))
                setattr(self, f"block{prefix}_{r}", BasicBlock(c, inner))

        self.conv1 = SparseConv(conv1_kernel_size ** 3, in_channels, ch[0])
        add_tail("1", ch[0])
        for l in range(2, L + 1):
            setattr(self, f"conv{l}", SparseConv(27, ch[l - 2], ch[l - 1]))
            add_tail(str(l), ch[l - 1])
        for l in range(L, 1, -1):
            cin = ch[l - 1] if l == L else ch[l - 1] + tr[l]
            setattr(self, f"conv{l}_tr", SparseConv(27, cin, tr[l - 1]))
            add_tail(f"{l}_tr", tr[l - 1])
        self.conv1_tr = SparseConv(spec.conv1_tr_kernel ** 3, ch[0] + tr[1],
                                   tr[0])
        if spec.conv1_tr_norm:
            self.norm1_tr = make_norm(top, tr[0])
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
        """name -> (weight [T, Ci, Co] in the compute dtype, bias f32|None):
        a BatchNorm folded into the conv before it; a conv before an
        instance norm (or none) as it is."""
        folded = {}

        def put(key, conv, norm=None):
            W = conv.weight.detach().float()
            if not isinstance(norm, BatchNorm):
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
                bn_momentum: float | None = 0.05,
                normalize_feature: bool | None = None,
                group=None) -> torch.Tensor:
        """Features [M0, out_channels] f32 for the level-0 voxel rows (zero
        rows at invalid voxels), L2-normalized unless `normalize_feature`
        (default: the model's) is False. The input feature is `in_feats`
        [M0, in_channels] (e.g. jittered occupancy) masked to the valid
        voxels, or the occupancy when None (the test protocol). The eval
        entry points call `embed`, which ignores the mode. In train mode
        with bn_momentum None, BN takes batch statistics and leaves the
        running ones as they are (the EYOC labeler's forwards); with a
        process group `group`, the statistics of every rank's rows
        (sync-BN)."""
        if self.training:
            return self._forward_train(pyr, in_feats, bn_momentum,
                                       normalize_feature, group)
        return self.embed(pyr, in_feats, normalize_feature)

    def _output(self, feats: torch.Tensor,
                normalize_feature: bool | None) -> torch.Tensor:
        """The features, L2-normalized unless asked not to (unet.py:378)."""
        if normalize_feature is None:
            normalize_feature = self.normalize_feature
        if not normalize_feature:
            return feats
        return feats / (torch.linalg.norm(feats, dim=-1, keepdim=True) + 1e-12)

    def _input(self, pyr: BrickPyramid, in_feats) -> torch.Tensor:
        """JAX's vox_to_fb drops invalid rows (unet.py:326-329)."""
        m = pyr.vox_masks[0][:, None]
        x = m if in_feats is None else in_feats * m
        return x.to(self.dtype).contiguous()

    @torch.no_grad()
    def embed(self, pyr: BrickPyramid, in_feats: torch.Tensor | None = None,
              normalize_feature: bool | None = None) -> torch.Tensor:
        """The eval forward (apply_unet(training=False, n_clouds=B))
        whatever the module's mode: BN from the running statistics, which
        it leaves as they are; an instance norm from each cloud's own."""
        if self._folded is None:
            self._folded = self._fold()
        fw = self._folded
        spec = self.spec
        L = spec.num_levels
        blocks = spec.block_norm_type is not None
        maps = conv_maps(pyr, L, self.conv1_kernel_size)
        masks = maps.vox_masks
        clouds = pyr.counts.shape[0]

        def conv(key, x, nmap, level, *, x2=None, residual=None, relu=False):
            W, b = fw[key]
            return sparse_conv(x, W, nmap, x2=x2, bias=b, mask=masks[level],
                               residual=residual, relu=relu)

        def conv_norm(key, norm, x, nmap, level, *, x2=None, residual=None,
                      relu=False, skip=False):
            """conv `key` and the norm after it: a BN (or none) folded into
            the conv's epilogue, an instance norm (K20) after the bare
            conv. (post-relu, pre-relu) when `skip`."""
            if isinstance(norm, InstanceNorm):
                return masked_instance_norm(
                    conv(key, x, nmap, level, x2=x2), masks[level], clouds,
                    norm.weight.detach(), norm.bias.detach(), eps=norm.eps,
                    relu=relu, residual=residual, skip=skip)
            y = conv(key, x, nmap, level, x2=x2, residual=residual,
                     relu=relu and not skip)
            return (torch.relu(y), y) if skip else y

        def block(name, x, level):
            b = getattr(self, name)
            same = maps.same3[level]
            y = conv_norm(f"{name}.conv1", b.norm1, x, same, level,
                          relu=True)
            return conv_norm(f"{name}.conv2", b.norm2, y, same, level,
                             residual=x, relu=True)

        def stage(prefix, x, nmap, level, *, x2=None, skip=False):
            """conv{prefix}, norm{prefix} and the level's tail, as
            unet.py:300-322: (post-relu, skip), the skip the block output
            for ResUNets, the pre-relu norm output for SimpleNets (None
            where no later level reads it)."""
            norm = getattr(self, f"norm{prefix}")
            if not blocks:
                out = conv_norm(f"conv{prefix}", norm, x, nmap, level, x2=x2,
                                relu=True, skip=skip)
                return out if skip else (out, None)
            x = conv_norm(f"conv{prefix}", norm, x, nmap, level, x2=x2)
            y = block(f"block{prefix}", x, level)
            for r in range(2, spec.repeats + 1):
                # norm{prefix}_{r}(relu(y)): y is a block's output, which
                # ends in a ReLU, so the relu is the identity; the norm
                # follows no conv and is K22 from the running statistics
                g, off = getattr(self, f"norm{prefix}_{r}").fold()
                gof = torch.cat([g, off]).float()[None].contiguous()
                x = masked_norm_apply(y, masks[level], gof)
                y = block(f"block{prefix}_{r}", x, level)
            return y, y

        x = self._input(pyr, in_feats)
        skips = []
        out, skip = stage("1", x, maps.first, 0, skip=L > 1)
        skips.append(skip)
        for l in range(2, L + 1):
            out, skip = stage(str(l), out, maps.down[l - 2], l - 1,
                              skip=l < L)
            skips.append(skip)

        x2 = None                     # ME.cat(decoder, encoder) skip join
        for l in range(L, 1, -1):
            out, _ = stage(f"{l}_tr", out, maps.up[l - 2], l - 2, x2=x2)
            x2 = skips[l - 2]

        if spec.conv1_tr_kernel == 1:
            nmap = identity_map(out.shape[0], out.device)
        else:
            nmap = maps.same3[0]
        out = conv_norm("conv1_tr", getattr(self, "norm1_tr", None), out,
                        nmap, 0, x2=x2, relu=True)
        out = conv("final", out, identity_map(out.shape[0], out.device), 0)
        return self._output(out.float(), normalize_feature)

    def _forward_train(self, pyr: BrickPyramid, in_feats,
                       bn_momentum: float | None,
                       normalize_feature: bool | None = None,
                       group=None) -> torch.Tensor:
        """apply_unet(training=True, n_clouds=B): unfolded convs, masked
        BN with batch statistics (running stats updated in place; over
        every rank of `group` when given) or the per-cloud instance norm,
        autograd through the kernels."""
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
        fmask0 = vmask[0][:, None].to(self.dtype)
        clouds = pyr.counts.shape[0]

        def conv(mod, x, nmap, inv, x2=None):
            return sparse_conv_diff(x, x2, mod.weight, nmap, inv)

        def norm(mod, x, level, **tail):
            """The norm `mod` and its fused tail (relu, residual, skip)."""
            if isinstance(mod, InstanceNorm):
                return instance_norm_train(x, vmask[level], clouds,
                                           mod.weight, mod.bias, eps=mod.eps,
                                           **tail)
            return masked_batch_norm(x, vmask[level], mod.weight, mod.bias,
                                     mod.running_mean, mod.running_var,
                                     momentum=bn_momentum, eps=mod.eps,
                                     group=group, **tail)

        def block(name, x, level):
            b = getattr(self, name)
            nmap, inv = maps.same3[level], maps.inv_same3[level]
            y = norm(b.norm1, conv(b.conv1, x, nmap, inv), level, relu=True)
            return norm(b.norm2, conv(b.conv2, y, nmap, inv), level,
                        residual=x)

        def level_tail(prefix, x, level, skip=False):
            """norm (-> block); returns (post-relu, skip) as unet.py:300-322
            (the skip None where no later level reads it)."""
            if not blocks:                      # SimpleNet: pre-relu skip
                out = norm(getattr(self, f"norm{prefix}"), x, level,
                           relu=True, skip=skip)
                return out if skip else (out, None)
            x = norm(getattr(self, f"norm{prefix}"), x, level)
            y = block(f"block{prefix}", x, level)
            for r in range(2, spec.repeats + 1):
                # relu(y) is y (a block's output ends in a ReLU), and so is
                # its gradient: the block's own ReLU passes none at y = 0,
                # as JAX's relu
                x = norm(getattr(self, f"norm{prefix}_{r}"), y, level)
                y = block(f"block{prefix}_{r}", x, level)
            return y, y

        x = self._input(pyr, in_feats)
        skips = []
        out = conv(self.conv1, x, maps.first, None)
        out, skip = level_tail("1", out, 0, skip=L > 1)
        skips.append(skip)
        for l in range(2, L + 1):
            out = conv(getattr(self, f"conv{l}"), out, maps.down[l - 2],
                       maps.inv_down[l - 2])
            out, skip = level_tail(str(l), out, l - 1, skip=l < L)
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
        out = conv(self.conv1_tr, out, nmap, inv, x2) * fmask0
        if spec.conv1_tr_norm:
            out = norm(self.norm1_tr, out, 0, relu=True)
        else:
            out = torch.relu(out)
        ident = identity_map(out.shape[0], out.device)
        out = sparse_conv_diff(out, None, self.final.weight[None], ident,
                               ident)
        feats = (out.float() + self.final.bias) * fmask0.float()
        return self._output(feats, normalize_feature)


def init_unet(spec: UNetSpec, generator: torch.Generator | None = None,
              in_channels: int = 1, out_channels: int = 32,
              conv1_kernel_size: int = 5, dtype: torch.dtype = torch.bfloat16,
              device=None, normalize_feature: bool = True) -> ResUNet:
    """A ResUNet with He-normal conv weights (std sqrt(2 / (K^3 Ci)), as
    unet.py:66-68) drawn from `generator` on the CPU, then moved to
    `device` (default: the GPU, or an error when there is none)."""
    device = resolve_device(device)
    model = ResUNet(spec, in_channels, out_channels, conv1_kernel_size, dtype,
                    normalize_feature)
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
