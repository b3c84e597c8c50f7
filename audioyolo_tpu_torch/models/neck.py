"""Multi-scale fusion neck, YOLOv6 style (port of
``audioyolo_tpu/models/neck.py``).

Top-down: ``p4 = CSPSPPF(f4)``, ``p3 = RepBlock(BiC(f3, f2, p4))``,
``p2 = RepBlock(BiC(f2, f1, p3))``; bottom-up: ``n3 = RepBlock(cat(p3,
down(n2)))``, ``n4 = RepBlock(cat(p4, down(n3)))``. Pyramid heights are
mean-pooled to 1 up front when they differ, and the three outputs are
squeezed to per-cell sequences (B, grid, out_ch).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .layers import BiCModule, CSPSPPFModule, ConvNorm, RepBlock


def _pool_h(x: torch.Tensor) -> torch.Tensor:
    """adaptive_avg_pool2d(output=(1, W)) == mean over the H axis (NCHW)."""
    return torch.mean(x, dim=2, keepdim=True)


class MultiScaleFmapModule(nn.Module):
    def __init__(self, fmap_channels: Sequence[int], out_channels: int, c_h: int = 128,
                 deploy: bool = False, branch_act: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        f1, f2, f3, f4 = fmap_channels
        kw = dict(deploy=deploy, branch_act=branch_act, dtype=dtype)
        self.cspsppf = CSPSPPFModule(f4, c_h, dtype=dtype)
        self.bic3 = BiCModule(f3, f2, c_h, c_h, dtype=dtype)
        self.rep_block3_1 = RepBlock(c_h, c_h, **kw)
        self.bic2 = BiCModule(f2, f1, c_h, c_h, dtype=dtype)
        self.rep_block2_1 = RepBlock(c_h, out_channels, **kw)
        self.conv2_downsample = ConvNorm(out_channels, c_h, 3, stride=(1, 2), dtype=dtype)
        self.rep_block3_2 = RepBlock(2 * c_h, out_channels, **kw)
        self.conv3_downsample = ConvNorm(out_channels, c_h, 3, stride=(1, 2), dtype=dtype)
        self.rep_block4_1 = RepBlock(2 * c_h, out_channels, **kw)

    def forward(self, fmap1, fmap2, fmap3, fmap4) -> Tuple[torch.Tensor, ...]:
        if not (fmap1.shape[2] == fmap2.shape[2] == fmap3.shape[2] == fmap4.shape[2]):
            fmap1, fmap2, fmap3, fmap4 = map(_pool_h, (fmap1, fmap2, fmap3, fmap4))
        p4 = self.cspsppf(fmap4)
        p3 = self.rep_block3_1(self.bic3(fmap3, fmap2, p4))
        p2 = self.rep_block2_1(self.bic2(fmap2, fmap1, p3))
        n2 = p2
        n3 = self.rep_block3_2(torch.cat([p3, self.conv2_downsample(n2)], dim=1))
        n4 = self.rep_block4_1(torch.cat([p4, self.conv3_downsample(n3)], dim=1))
        # (B, C, 1, W) -> (B, W, C) per-cell prediction sequences
        return tuple(_pool_h(n)[:, :, 0, :].transpose(1, 2) for n in (n2, n3, n4))
