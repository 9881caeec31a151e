"""A plain torchvision-layout ResNet-50 (BatchNorm in eval mode, float32): the
reference for the anyGAN attribute classifier that classifier guidance
differentiates through. Keys are torchvision's (`layer3.5.conv3.weight`,
`fc.bias`)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .configs import ResNet50Config


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, downsample: bool, eps: float):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=eps)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=eps)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4, eps=eps)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
                                            nn.BatchNorm2d(planes * 4, eps=eps))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.relu(shortcut + out)


class ResNet50(nn.Module):
    def __init__(self, cfg: ResNet50Config):
        super().__init__()
        w, eps = cfg.width, cfg.bn_eps
        self.conv1 = nn.Conv2d(3, w, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(w, eps=eps)
        cin = w
        for i, (planes, blocks, stride) in enumerate(
                [(w, 3, 1), (w * 2, 4, 2), (w * 4, 6, 2), (w * 8, 3, 2)], start=1):
            layer = []
            for j in range(blocks):
                layer.append(Bottleneck(cin, planes, stride if j == 0 else 1, j == 0, eps))
                cin = planes * 4
            setattr(self, f"layer{i}", nn.Sequential(*layer))
        self.fc = nn.Linear(cin, cfg.num_outputs)

    def forward(self, x):
        h = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        h = self.layer4(self.layer3(self.layer2(self.layer1(h))))
        return self.fc(h.mean(dim=(2, 3)))


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def classifier_input(img: torch.Tensor) -> torch.Tensor:
    """A decoded image in [-1, 1] -> the classifier's ImageNet-normalised
    input: clipped to [0, 1] first."""
    x01 = torch.clamp(img.float() / 2 + 0.5, 0.0, 1.0)
    mean = torch.tensor(IMAGENET_MEAN, device=img.device).view(-1, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=img.device).view(-1, 1, 1)
    return (x01 - mean) / std
