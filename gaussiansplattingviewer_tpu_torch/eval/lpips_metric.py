"""LPIPS perceptual distance from a local AlexNet-LPIPS state dict.

The JAX package's ``eval/lpips_metric.py`` for the port, with its
local-weights tier only: a self-contained torch AlexNet-LPIPS that loads a
state-dict file (``weights_path``), the path the JAX package's tests drive
with random weights.  No pretrained weights ship with the repo and the
``lpips`` pip package is not used, so ``lpips_available()`` is False and
``lpips_distance`` without ``weights_path`` raises ImportError.

The state dict uses the official lpips layout: AlexNet features as
``net.slice{1..5}.*`` (torchvision indexing) or plain torchvision
``features.*`` keys, plus linear calibration weights
``lin{0..4}.model.1.weight``.
"""

from __future__ import annotations

import functools

import numpy as np

# AlexNet feature channel widths at the 5 LPIPS taps
_ALEX_CHANNELS = (64, 192, 384, 256, 256)
# input normalization (official lpips ScalingLayer constants)
_SHIFT = np.array([-0.030, -0.088, -0.188], dtype=np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], dtype=np.float32)


def lpips_available() -> bool:
    """Whether the pretrained tier (the ``lpips`` package) is available:
    never in the port, which takes local weights only."""
    return False


def _to_torch_input(img, torch):
    """HWC float [0,1] (or uint8) -> NCHW torch tensor in [-1, 1]."""
    a = np.asarray(img)
    if a.dtype == np.uint8:
        a = a.astype(np.float32) / 255.0
    a = a.astype(np.float32)
    if a.ndim == 2:
        a = np.stack([a] * 3, axis=-1)
    t = torch.from_numpy(np.ascontiguousarray(a)).permute(2, 0, 1)[None]
    return t * 2.0 - 1.0


class _AlexLPIPS:
    """Minimal AlexNet-LPIPS (torch) loading a local state dict."""

    def __init__(self, weights_path: str):
        import torch
        import torch.nn as nn

        self.torch = torch
        # torchvision AlexNet.features topology (the 5 LPIPS slices end
        # after each ReLU at indices 1, 4, 7, 9, 11)
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2d(3, stride=2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2d(3, stride=2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(),
        )
        self.taps = (1, 4, 7, 9, 11)
        self.lins = [
            nn.Conv2d(c, 1, 1, bias=False) for c in _ALEX_CHANNELS
        ]
        sd = torch.load(weights_path, map_location="cpu",
                        weights_only=True)
        self._load(sd)
        self.features.eval()
        for p in self.features.parameters():
            p.requires_grad_(False)

    def _load(self, sd):
        tc = self.torch
        feat_sd = {}
        lin_sd = [dict() for _ in range(5)]
        for k, v in sd.items():
            if k.startswith("net.slice"):
                # lpips package layout: net.sliceN.<idx>.<param> with
                # torchvision indices preserved inside each slice
                rest = k.split(".", 2)[2]
                feat_sd[rest] = v
            elif k.startswith("features."):
                feat_sd[k.split(".", 1)[1]] = v
            elif k.startswith("lin"):
                i = int(k[3])
                lin_sd[i]["weight"] = v.reshape(1, -1, 1, 1)
        if feat_sd:
            self.features.load_state_dict(
                {k: tc.as_tensor(v) for k, v in feat_sd.items()}
            )
        for lin, d in zip(self.lins, lin_sd):
            if "weight" in d:
                lin.load_state_dict({"weight": tc.as_tensor(d["weight"])})

    def __call__(self, a, b) -> float:
        tc = self.torch
        shift = tc.from_numpy(_SHIFT).view(1, 3, 1, 1)
        scale = tc.from_numpy(_SCALE).view(1, 3, 1, 1)
        with tc.no_grad():
            xa = (_to_torch_input(a, tc) - shift) / scale
            xb = (_to_torch_input(b, tc) - shift) / scale
            total = 0.0
            tap_i = 0
            for i, layer in enumerate(self.features):
                xa, xb = layer(xa), layer(xb)
                if i == self.taps[tap_i]:
                    fa = xa / xa.square().sum(1, keepdim=True).sqrt().clamp_min(1e-10)
                    fb = xb / xb.square().sum(1, keepdim=True).sqrt().clamp_min(1e-10)
                    d = self.lins[tap_i]((fa - fb) ** 2).mean(dim=(2, 3))
                    total = total + float(d.sum())
                    tap_i += 1
                    if tap_i == len(self.taps):
                        break
        return total


@functools.lru_cache(maxsize=2)
def _local_model(weights_path: str):
    return _AlexLPIPS(weights_path)


def lpips_distance(a, b, net: str = "alex",
                   weights_path: str | None = None) -> float:
    """LPIPS(a, b) for HWC images in [0,1] / uint8.  Lower = more similar.

    Needs a local AlexNet-LPIPS state dict (``weights_path``); raises
    ImportError without one (this metric is optional — PSNR/SSIM in
    eval/metrics.py have no extra dependencies).
    """
    if weights_path is None:
        raise ImportError(
            "LPIPS needs a local AlexNet-LPIPS state dict passed as "
            "weights_path=... (pretrained weights are not fetched)"
        )
    if net != "alex":
        raise ValueError("local-weights LPIPS supports net='alex' only")
    return _local_model(weights_path)(a, b)
