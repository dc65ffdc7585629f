"""`RunProvenance`: where and how a run ran (mirrors
``repro/obs/provenance.py``), stamped into every trace header and metrics
snapshot, so a number carries its environment.

`collect()` gathers what changes what a number means on this port: the git
sha (and whether the tree was dirty), the torch and CUDA versions, and
where a card is present its driver version, name and power limit (as
``nvidia-smi --query-gpu=name,power.limit,driver_version`` gives them),
the device count, the TF32 switches, and the kernel route: ``cuda`` (the
hand-written kernels) on the card, ``plain`` (their PyTorch versions) on
the CPU.

Collection is defensive: a missing git or ``nvidia-smi``, a checkout that
is not a repository, or a card that does not answer leaves the field None
instead of failing the run the stamp describes.
"""
from __future__ import annotations

import dataclasses
import os
import platform as _platform
import subprocess
import sys
from dataclasses import dataclass
from typing import Optional

import torch


def _run(cmd: list, cwd: Optional[str] = None) -> Optional[str]:
    try:
        out = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                             timeout=10)
        return out.stdout.strip() if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        return None


def _smi() -> tuple:
    """(name, power limit, driver version) of the first card, or Nones."""
    out = _run(["nvidia-smi", "--query-gpu=name,power.limit,driver_version",
                "--format=csv,noheader"])
    if not out:
        return None, None, None
    fields = [f.strip() for f in out.splitlines()[0].split(",")]
    return tuple(fields) if len(fields) == 3 else (None, None, None)


@dataclass(frozen=True)
class RunProvenance:
    git_sha: Optional[str] = None
    git_dirty: Optional[bool] = None
    torch_version: Optional[str] = None
    cuda_version: Optional[str] = None
    driver_version: Optional[str] = None
    gpu_name: Optional[str] = None
    gpu_power_limit: Optional[str] = None
    n_devices: Optional[int] = None
    tf32_matmul: Optional[bool] = None
    tf32_cudnn: Optional[bool] = None
    kernel_route: Optional[str] = None
    platform: Optional[str] = None
    python: Optional[str] = None
    argv: Optional[str] = None

    @classmethod
    def collect(cls, device=None) -> "RunProvenance":
        """The stamp of a run on ``device`` (default: the card where torch
        sees one, else the CPU)."""
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))   # src/repro_torch/obs/..
        sha = _run(["git", "rev-parse", "HEAD"], repo)
        dirty = None
        if sha is not None:
            status = _run(["git", "status", "--porcelain"], repo)
            dirty = bool(status) if status is not None else None
        has_card = torch.cuda.is_available()
        if device is None:
            device = "cuda" if has_card else "cpu"
        name = limit = driver = None
        if has_card:
            name, limit, driver = _smi()
        return cls(git_sha=sha, git_dirty=dirty,
                   torch_version=torch.__version__,
                   cuda_version=torch.version.cuda,
                   driver_version=driver, gpu_name=name,
                   gpu_power_limit=limit,
                   n_devices=torch.cuda.device_count() if has_card else 0,
                   tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
                   tf32_cudnn=torch.backends.cudnn.allow_tf32,
                   kernel_route=("cuda" if torch.device(device).type == "cuda"
                                 else "plain"),
                   platform=_platform.platform(),
                   python=_platform.python_version(),
                   argv=" ".join(sys.argv))

    def asdict(self) -> dict:
        return dataclasses.asdict(self)
