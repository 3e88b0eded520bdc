"""SimpleFPN (ViTDet-style) pyramid from one ViT feature map (counterpart of
`vlm_fo1_tpu/models/simple_fpn.py`), used by the HFRE when
`use_simple_fpn_for_vt` is set: scale factors [4, 2, 1, 0.5] from 2x
transposed convolutions and a 2x2 max-pool, each followed by a 1x1 and a
3x3 convolution with channel LayerNorms.

Activations are channel-last. Parameters keep the JAX tree's names
(`scale4.deconv1`, `scale4.norm`, `scale4.lateral`, `scale4.lateral_norm`,
`scale4.output`, `scale4.output_norm`, ...), in checkpoint layouts: the
transposed-conv weights IOHW with a bias, the convolutions OIHW without.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vlm_fo1_tpu_torch import nn as tnn


class Deconv2x(nn.Module):
    """2x2 stride-2 transposed convolution, IOHW weight, with bias."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, 2, 2))
        self.bias = nn.Parameter(torch.empty(out_ch))

    def forward(self, x):
        """x [B, H, W, in] -> [B, 2H, 2W, out]. Each input pixel writes its
        own 2x2 block: out[2i+a, 2j+b] = x[i, j] @ w[:, :, 1-a, 1-b], as
        `jax.lax.conv_transpose` reads the kernel (not flipped back, unlike
        torch's ConvTranspose2d, which would take w[:, :, a, b])."""
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                               self.weight.flip(-2, -1), self.bias, stride=2)
        return y.permute(0, 2, 3, 1)


class FPNLevel(nn.Module):
    """One output level: its upsampling stem (if any), then the 1x1 lateral
    and 3x3 output convolutions, each with a channel LayerNorm."""

    def __init__(self, dim, out_channels, scale):
        super().__init__()
        in_ch = dim
        if scale == 4:
            self.deconv1 = Deconv2x(dim, dim // 2)
            self.norm = tnn.LayerNorm(dim // 2)
            self.deconv2 = Deconv2x(dim // 2, dim // 4)
            in_ch = dim // 4
        elif scale == 2:
            self.deconv1 = Deconv2x(dim, dim // 2)
            in_ch = dim // 2
        self.scale = scale
        self.lateral = tnn.Conv2d(in_ch, out_channels, 1, bias=False)
        self.lateral_norm = tnn.LayerNorm(out_channels)
        self.output = tnn.Conv2d(out_channels, out_channels, 3, bias=False)
        self.output_norm = tnn.LayerNorm(out_channels)

    def forward(self, x):
        if self.scale == 4:
            x = self.deconv1(x)
            x = F.gelu(self.norm(x), approximate="none")
            x = self.deconv2(x)
        elif self.scale == 2:
            x = self.deconv1(x)
        elif self.scale == 0.5:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        y = self.lateral_norm(tnn.conv2d_nhwc(self.lateral, x))
        return self.output_norm(tnn.conv2d_nhwc(self.output, y, padding=1))


class SimpleFPN(nn.Module):
    def __init__(self, dim: int = 1280, out_channels: int = 512):
        super().__init__()
        self.scale4 = FPNLevel(dim, out_channels, 4)
        self.scale2 = FPNLevel(dim, out_channels, 2)
        self.scale1 = FPNLevel(dim, out_channels, 1)
        self.scale05 = FPNLevel(dim, out_channels, 0.5)

    def forward(self, x):
        """x [B, H, W, dim] -> 4 maps at scales [4, 2, 1, 0.5] of the input
        (strides [3.5, 7, 14, 28] for a 14 px-patch ViT)."""
        return [self.scale4(x), self.scale2(x), self.scale1(x),
                self.scale05(x)]
