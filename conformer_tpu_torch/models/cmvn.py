"""Global CMVN: (x - mean) * istd, stats from the Kaldi-style JSON file."""

from __future__ import annotations

import json

import numpy as np
import torch


def load_cmvn_stats(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Load {mean_stat, var_stat, frame_num} JSON -> (mean, istd) float32,
    with the variance floored at 1e-20."""
    with open(path) as f:
        stats = json.load(f)
    mean_stat = np.asarray(stats["mean_stat"], np.float64)
    var_stat = np.asarray(stats["var_stat"], np.float64)
    count = float(stats["frame_num"])
    mean = mean_stat / count
    var = np.maximum(var_stat / count - mean * mean, 1.0e-20)
    istd = 1.0 / np.sqrt(var)
    return mean.astype(np.float32), istd.astype(np.float32)


def init_cmvn_from_file(path: str, device=None) -> dict:
    mean, istd = load_cmvn_stats(path)
    return {
        "mean": torch.as_tensor(mean, device=device),
        "istd": torch.as_tensor(istd, device=device),
    }


def init_cmvn_identity(dim: int, device=None) -> dict:
    """Mean 0, istd 1: CMVN that leaves the features as they are."""
    return {
        "mean": torch.zeros(dim, dtype=torch.float32, device=device),
        "istd": torch.ones(dim, dtype=torch.float32, device=device),
    }


def global_cmvn(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (x - p["mean"].to(x.dtype)) * p["istd"].to(x.dtype)
