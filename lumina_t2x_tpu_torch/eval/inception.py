"""InceptionV3 pool3 feature extractor for FID and IS (counterpart of
`lumina_t2x_tpu/eval/inception.py`), an inference-only `nn.Module`.

The standard FID network: torchvision's `inception_v3` layout with the
pytorch-fid patches (the A, C and first E blocks average-pool with
`count_include_pad=False`; Mixed_7c's branch_pool is a MAX pool), cut at the
2048-d global-average pool3 features. Its parameter and buffer names are
torchvision's (`Conv2d_1a_3x3.conv.weight`, `Mixed_5b.branch1x1.bn.running_mean`,
...), so a torchvision or pytorch-fid state dict (`pt_inception-2015-12-05`,
`inception_v3_google`) loads directly; the fc and AuxLogits heads are
ignored. The BatchNorms run in inference mode from the loaded running
statistics. The input is NCHW in [0, 1]; the model applies its own 2x - 1
scaling (pytorch-fid `normalize_input=True`).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn


class BasicConv2d(nn.Module):
    """Conv (no bias) + inference BatchNorm (eps 1e-3) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x):
    """3x3 stride-1 pad-1 average pool without the padding in the count (the
    pytorch-fid patch)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """Mixed_7b pools by average (count_include_pad=False), Mixed_7c by MAX:
    pytorch-fid's FIDInceptionE_1 / E_2."""

    def __init__(self, cin: int, pool_mode: str = "avg"):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        pooled = (F.max_pool2d(x, 3, stride=1, padding=1) if self.pool_mode == "max"
                  else _avg_pool(x))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pooled)], 1)


class InceptionV3(nn.Module):
    """FID InceptionV3 cut at pool3 (the 2048-d global average)."""

    def __init__(self, normalize_input: bool = True):
        super().__init__()
        self.normalize_input = normalize_input
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
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.eval()

    def forward(self, images):
        """images: (B, 3, H, W) float in [0, 1] (299^2 for the standard
        metric; any H, W >= 75 runs). Returns (B, 2048) pool3 features."""
        x = images.float()
        if self.normalize_input:
            x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                      self.Mixed_6c, self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b,
                      self.Mixed_7c):
            x = block(x)
        return x.mean(dim=(2, 3))

    def load_fid_state_dict(self, sd: Dict[str, torch.Tensor]) -> List[str]:
        """Load a torchvision / pytorch-fid state dict; every tensor of this
        module must be present. Returns the keys it ignores (the fc and
        AuxLogits heads)."""
        own = self.state_dict()
        missing = sorted(k for k in own if k not in sd and not k.endswith("num_batches_tracked"))
        if missing:
            raise KeyError(f"InceptionV3 state dict lacks {len(missing)} tensors: {missing[:4]}")
        self.load_state_dict({k: v for k, v in sd.items() if k in own}, strict=False)
        return [k for k in sd if k not in own]


def load_fid_inception(path: str, device="cpu") -> InceptionV3:
    """The extractor with a downloaded pt_inception / torchvision checkpoint."""
    from ..core.checkpoint import load_torch_state_dict

    model = InceptionV3()
    model.load_fid_state_dict(load_torch_state_dict(path))
    return model.to(device)


def random_fid_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """A random InceptionV3 state dict in the torchvision layout, drawn from
    `seed`: He-normal convolutions (so that the features keep their scale
    through 47 ReLU layers) and BatchNorm statistics near identity.
    Random-init FID is a relative metric, reported beside its own
    real-vs-real floor."""
    gen = torch.Generator().manual_seed(seed)
    sd = InceptionV3().state_dict()
    for k, v in sd.items():
        if k.endswith("conv.weight"):
            fan_in = v[0].numel()
            v.copy_(torch.randn(v.shape, generator=gen) * (2.0 / fan_in) ** 0.5)
        elif k.endswith("bn.weight"):
            v.copy_(1.0 + 0.1 * torch.randn(v.shape, generator=gen))
        elif k.endswith("bn.bias") or k.endswith("running_mean"):
            v.copy_(0.1 * torch.randn(v.shape, generator=gen))
        elif k.endswith("running_var"):
            v.copy_(1.0 + 0.5 * torch.rand(v.shape, generator=gen))
    return sd
