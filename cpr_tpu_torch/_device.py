"""Device resolution for the port's entry points.

Entry points run on the card. A caller that wants the CPU says so with
`device="cpu"` (the tests do); without a `device` and without a GPU an
entry point raises instead of quietly running the plain versions on the
host.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`device` as a `torch.device`; None means the current CUDA device
    and raises where there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "cpr_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the host")
    return torch.device("cuda", torch.cuda.current_device())


def check_supported(t: torch.Tensor, what: str) -> None:
    """Tensors live on the CPU (plain versions) or on CUDA (kernels)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
