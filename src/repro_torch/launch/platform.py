"""Named platform presets: torch's numeric switches under one stampable
name (mirrors ``repro/launch/platform.py``).

Every switch that changes what a measurement means on the card lives in a
named `PlatformPreset`, instead of being set by hand where a script needs
it:

    from repro_torch.launch import platform as pf
    pf.apply("fp32-deterministic")

The reference's presets are XLA flag sets, a fake-device CPU tier and
``jax_enable_x64``.  The port's counterparts are torch's own switches:

* ``tf32``: TF32 on the tensor cores for float32 matmuls and cuDNN
  convolutions (``torch.backends.cuda.matmul.allow_tf32``,
  ``torch.backends.cudnn.allow_tf32``).  ``False`` makes float32 mean
  float32.
* ``deterministic``: cuDNN's deterministic algorithms with its autotuner
  off, and torch's deterministic algorithms (the index ops' sorted scatter
  in place of atomics), warning only where an op has none.  With the
  default algorithms a card's round differs from itself from run to run.
* ``x64``: ``torch.set_default_dtype(torch.float64)``, the counterpart of
  ``jax_enable_x64`` for new floating tensors.

torch reads these switches at each call, not once at backend init, so a
preset takes effect whenever it is applied.  The reference's ``cpu8``,
``overlap`` and ``overlap-cpu8`` (fake devices, the latency-hiding
scheduler and async collectives) belong to multi-chip work and are not
offered.

The applied preset is `active()` and is stamped into
`repro_torch.obs.RunProvenance` (``platform_preset``).  `snapshot` and
`restore` save and put back every switch and the active preset, for a
preset applied to one scope only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch


@dataclass(frozen=True)
class PlatformPreset:
    """One named configuration of torch's switches; a field left None
    leaves its switch as it is."""
    name: str
    description: str
    tf32: Optional[bool] = None
    deterministic: Optional[bool] = None
    x64: Optional[bool] = None


PRESETS = {
    "default": PlatformPreset(
        "default", "no switch changed: torch's defaults or what the caller "
        "set"),
    "fp32": PlatformPreset(
        "fp32", "TF32 off for matmuls and cuDNN: float32 runs in float32",
        tf32=False),
    "deterministic": PlatformPreset(
        "deterministic", "cuDNN's deterministic algorithms, its autotuner "
        "off, and torch's deterministic algorithms (warn only)",
        deterministic=True),
    "fp32-deterministic": PlatformPreset(
        "fp32-deterministic", "fp32 and deterministic together",
        tf32=False, deterministic=True),
    "x64": PlatformPreset(
        "x64", "float64 as the default floating dtype", x64=True),
}

_active: Optional[PlatformPreset] = None


def names() -> list:
    return sorted(PRESETS)


def active() -> Optional[PlatformPreset]:
    """The preset applied in this process, if any (provenance reads it)."""
    return _active


def snapshot() -> dict:
    """Every switch a preset sets, and the active preset."""
    cudnn = torch.backends.cudnn
    return dict(matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
                cudnn_tf32=cudnn.allow_tf32,
                cudnn_deterministic=cudnn.deterministic,
                cudnn_benchmark=cudnn.benchmark,
                deterministic=torch.are_deterministic_algorithms_enabled(),
                warn_only=(
                    torch.is_deterministic_algorithms_warn_only_enabled()),
                default_dtype=torch.get_default_dtype(), active=_active)


def restore(saved: dict) -> None:
    """Put back what `snapshot` saved."""
    global _active
    cudnn = torch.backends.cudnn
    torch.backends.cuda.matmul.allow_tf32 = saved["matmul_tf32"]
    cudnn.allow_tf32 = saved["cudnn_tf32"]
    cudnn.deterministic = saved["cudnn_deterministic"]
    cudnn.benchmark = saved["cudnn_benchmark"]
    torch.use_deterministic_algorithms(saved["deterministic"],
                                       warn_only=saved["warn_only"])
    torch.set_default_dtype(saved["default_dtype"])
    _active = saved["active"]


def apply(preset: Union[str, PlatformPreset]) -> PlatformPreset:
    """Set ``preset``'s switches and record it as the active preset.  An
    unknown name raises, listing the names."""
    global _active
    if isinstance(preset, str):
        try:
            preset = PRESETS[preset]
        except KeyError:
            raise ValueError(
                f"unknown platform preset {preset!r}; "
                f"available: {', '.join(names())}") from None
    if preset.tf32 is not None:
        torch.backends.cuda.matmul.allow_tf32 = preset.tf32
        torch.backends.cudnn.allow_tf32 = preset.tf32
    if preset.deterministic is not None:
        torch.backends.cudnn.deterministic = preset.deterministic
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(preset.deterministic,
                                           warn_only=True)
    if preset.x64 is not None:
        torch.set_default_dtype(torch.float64 if preset.x64
                                else torch.float32)
    _active = preset
    return preset


def add_args(ap) -> None:
    """Install ``--platform-preset`` on an argparse parser (the launchers
    and examples share this flag)."""
    ap.add_argument(
        "--platform-preset", default=None, choices=names(), metavar="NAME",
        help="named set of torch's numeric switches, applied before the "
             "run and stamped into provenance: " + ", ".join(names()))


def from_args(args) -> Optional[PlatformPreset]:
    """Apply the preset named by ``--platform-preset``, if any.  Call at
    the top of ``main``, before the run."""
    name = getattr(args, "platform_preset", None)
    return apply(name) if name else None
