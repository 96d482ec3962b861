"""The explicit device of a run.

The port keeps no global default device: every op runs on the device of its
input tensors, and the engine takes its device as an argument. The CLI
resolves that argument here from BISCUIT_TPU_TORCH_DEVICE (default `cuda`).
The CPU is used only when the caller names it; a missing card raises.
"""
import os
from typing import Optional, Union

import torch

ENV = "BISCUIT_TPU_TORCH_DEVICE"


def resolve(name: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device(name if name is not None
                       else os.environ.get(ENV, "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is false "
            f"(set {ENV}=cpu to run the plain torch versions on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
