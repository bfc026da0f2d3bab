"""InceptionV3 feature extractor for the standard FID.

Counterpart of ``mvd_tpu/metrics/inception.py``: the pytorch-fid
InceptionV3 (the TF-ported "pt_inception-2015-12-05" network that
torchmetrics' FrechetInceptionDistance wraps) in NCHW, through pool3:

  * ``BasicConv2d`` = conv without bias, inference batch norm with eps 1e-3,
    relu,
  * Inception blocks A to E; every branch pool is a 3x3 average pool with
    ``count_include_pad=False`` (``avg_pool_nopad``) except ``Mixed_7c``'s,
    which is a max pool; the stem's and blocks B and D's max pools are
    VALID (torch's floor mode),
  * input (B, 3, 299, 299) in [-1, 1] (``preprocess`` resizes [0, 1] NHWC
    images with the antialiased bilinear resize and rescales),
  * output: the 2048-wide pool3 features.

The parameters are named as the pytorch-fid state dict names them
(``Mixed_5b.branch1x1.conv.weight``, ``....bn.running_var``), so
``inception_from_torch`` only drops prefixes, ``fc.`` and ``AuxLogits``.
The extractor runs on the device of the images it is given, in f32 with
TF32 off, and returns the features on the host.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .image import no_tf32
from .towers import _nchw, _on, resize_bilinear


def avg_pool_nopad(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME average pool with count_include_pad=False."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class BatchNorm(nn.Module):
    """Inference batch norm with eps 1e-3 (the pytorch-fid network's)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = lambda t: t.view(1, -1, 1, 1)
        return (x - c(self.running_mean)) * torch.rsqrt(c(self.running_var) + 1e-3) * c(self.weight) + c(self.bias)


class BasicConv2d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=False)
        self.bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool_nopad(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int):
        super().__init__()
        row, col = dict(kernel=(1, 7), padding=(0, 3)), dict(kernel=(7, 1), padding=(3, 0))
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, **row)
        self.branch7x7_3 = BasicConv2d(c7, 192, **col)
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, **col)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, **row)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, **col)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, **row)
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(avg_pool_nopad(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int, pool_mode: str = "avg"):
        super().__init__()
        self.pool_mode = pool_mode  # "max" in Mixed_7c of the FID network
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        if self.pool_mode == "max":  # SAME: padded with -inf
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = avg_pool_nopad(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], dim=1)


class InceptionV3Features(nn.Module):
    """Trunk through pool3: (B, 3, 299, 299) in [-1, 1] -> (B, 2048)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, pool_mode="max")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        return x.mean(dim=(2, 3))  # adaptive average pool -> (B, 2048)


def preprocess(images01) -> torch.Tensor:
    """[0, 1] NHWC images -> (B, 3, 299, 299) in [-1, 1] (pytorch-fid's input)."""
    return resize_bilinear(_nchw(images01), 299) * 2.0 - 1.0


_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def inception_from_torch(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """pytorch-fid / torchmetrics InceptionV3 state dict -> ``InceptionV3Features``:
    an ``inception.``/``net.``/``model.`` prefix dropped; ``fc.``,
    ``AuxLogits`` and ``num_batches_tracked`` ignored."""
    out = {}
    for key, val in sd.items():
        k = re.sub(r"^(inception|net|model)\.", "", key)
        if k.startswith(("fc.", "AuxLogits")):
            continue
        parts = k.split(".")
        if len(parts) < 2:
            continue
        if (parts[-2] == "conv" and parts[-1] == "weight") or (parts[-2] == "bn" and parts[-1] in _BN_LEAVES):
            out[k] = val
    return out


class InceptionFIDExtractor:
    """FID feature extractor for ``metrics.fid.FID``: [0, 1] NHWC images ->
    (N, 2048) pool3 features on the host."""

    def __init__(self, model: Optional[InceptionV3Features] = None):
        self.model = model

    @property
    def available(self) -> bool:
        return self.model is not None

    def __call__(self, images01) -> np.ndarray:
        with torch.no_grad(), no_tf32():
            x = preprocess(images01)
            return _on(self.model, x)(x).cpu().numpy()
