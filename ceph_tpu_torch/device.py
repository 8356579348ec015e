"""Device resolution for every entry point of the port.

Entry points take `device`, default "cuda". Without a card that default
raises: the port never carries on quietly on the CPU. The CPU runs only
when the caller asks for it (`device="cpu"`), and then every kernel's
wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


class DeviceUnavailable(RuntimeError):
    """The requested device does not exist on this machine."""


def resolve(device: str | torch.device | None = DEFAULT_DEVICE) -> torch.device:
    """`device` as a torch.device, checked to exist. Accepts "cuda",
    "cuda:N" and "cpu"; None means the default, "cuda"."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise DeviceUnavailable(f"unsupported device {dev}; use cuda or cpu")
    if not torch.cuda.is_available():
        raise DeviceUnavailable(
            f"device {dev} requested but CUDA is not available; pass "
            f"device='cpu' to run the plain PyTorch versions")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.index >= torch.cuda.device_count():
        raise DeviceUnavailable(
            f"{dev} requested but only {torch.cuda.device_count()} "
            f"CUDA device(s) exist")
    return dev


def resolve_all(devices=None) -> list[torch.device]:
    """A device list for the multi-device entry points (the mesh, the
    offload service): each entry resolved as `resolve` does, repeats
    allowed; None means every visible card, and raises without one."""
    if devices is not None:
        return [resolve(d) for d in devices]
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise DeviceUnavailable(
            "no CUDA device; pass devices=['cpu', ...] to run the plain "
            "PyTorch versions")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def host_tensor(data) -> torch.Tensor:
    """A CPU uint8 tensor over host bytes, sharing numpy's memory where
    it can; read-only buffers (np.frombuffer of message bytes) are
    copied by `staged`, since torch.from_numpy must not wrap them."""
    arr = np.ascontiguousarray(data, dtype=np.uint8)
    return torch.from_numpy(arr) if arr.flags.writeable else staged(arr)


def staged(data: np.ndarray) -> torch.Tensor:
    """A CPU uint8 tensor holding a copy of host bytes. Callers hand
    read-only np.frombuffer views of message buffers, which
    torch.from_numpy must not wrap; the copy is what goes to the card."""
    t = torch.empty(data.shape, dtype=torch.uint8)
    np.copyto(t.numpy(), data, casting="unsafe")
    return t
