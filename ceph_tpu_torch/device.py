"""Device resolution for every entry point of the port.

Entry points take `device`, default "cuda". Without a card that default
raises: the port never carries on quietly on the CPU. The CPU runs only
when the caller asks for it (`device="cpu"`), and then every kernel's
wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from ceph_tpu_torch.utils import copytrack

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
    allowed; None means every visible card, sliced to this process's
    partition (`partition`), and raises without one."""
    if devices is not None:
        return [resolve(d) for d in devices]
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise DeviceUnavailable(
            "no CUDA device; pass devices=['cpu', ...] to run the plain "
            "PyTorch versions")
    return partition([torch.device("cuda", i)
                      for i in range(torch.cuda.device_count())])


#: "j/W", set by the process-backed reactor when it spawns worker j of W
PARTITION_ENV = "CEPH_TPU_OFFLOAD_DEVICE_PARTITION"


def _device_partition() -> tuple[int, int] | None:
    """(worker_ordinal, num_workers) from CEPH_TPU_OFFLOAD_DEVICE_PARTITION
    ("j/W", set by the process-backed reactor at worker spawn): each
    worker process serves a disjoint round-robin slice of the visible
    cards, so per-card warmth (kernels loaded, pinned pages) stays
    process-local instead of every worker contending for the full set.
    None when unset or malformed."""
    raw = os.environ.get(PARTITION_ENV)
    if not raw:
        return None
    try:
        j, w = raw.split("/", 1)
        j, w = int(j), int(w)
    except ValueError:
        return None
    if w < 1 or j < 0:
        return None
    return j % w, w


def partition(devs: list) -> list:
    """`devs` sliced to this process's partition: worker j of W takes
    devs[j::W], or devs[:1] when the slice is empty (W workers over
    fewer cards than W share the first: on one card every worker gets
    it). Unpartitioned processes keep the whole list."""
    part = _device_partition()
    if part is None or not devs:
        return list(devs)
    j, w = part
    return devs[j::w] or devs[:1]


def service_devices(device: str = DEFAULT_DEVICE) -> list[torch.device]:
    """The offload service's device list for an OSD on `device`,
    resolved: `cuda` is every visible card and `cpu` eight CPU slots
    (the reference's eight virtual CPU devices), each sliced to this
    process's partition; `cuda:N` is that card alone."""
    if device == "cpu":
        return resolve_all(partition(["cpu"] * 8))
    return resolve_all(None if device == "cuda" else [device])


def open_devices(devices: list[torch.device]) -> None:
    """Create this process's CUDA context on every card in `devices`
    and load the kernels' libraries, so the first dispatch neither
    stalls its event loop on context creation nor on a library load.
    Raises DeviceUnavailable when a card cannot be opened; does nothing
    for CPU entries."""
    cards = sorted({d.index for d in devices if d.type == "cuda"})
    if not cards:
        return
    try:
        for i in cards:
            torch.zeros(1, device=torch.device("cuda", i))
            torch.cuda.synchronize(i)
    except RuntimeError as e:
        raise DeviceUnavailable(f"cannot open cuda:{cards}: {e}") from e
    from ceph_tpu_torch.ops import _build, crc32c, rs_codec
    for name, signatures in (
            (rs_codec._KERNEL, rs_codec._SIGNATURES),
            (rs_codec._CSUM_KERNEL, rs_codec._CSUM_SIGNATURES),
            (crc32c._KERNEL, crc32c._SIGNATURES)):
        _build.load(name, signatures)


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


# -- the legs of a staged device call ------------------------------------------

H2D, KERNEL, D2H = range(3)


class Legs:
    """The upload, kernel and download legs of staged device calls under
    dispatch profiling (tracer.profile_dispatch). On a card each leg is
    bracketed by a pair of CUDA events recorded on the stream it runs on
    and read after the call's synchronize (a leg then also holds any
    time its stream waited for the host to issue the work); on the CPU
    the host clock times it."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.seconds = [0.0, 0.0, 0.0]
        self._events: list[tuple] = []

    @contextlib.contextmanager
    def leg(self, which: int, stream=None):
        if not self.cuda:
            t0 = time.perf_counter()
            yield
            self.seconds[which] += time.perf_counter() - t0
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        yield
        end.record(stream)
        self._events.append((which, start, end))

    def read(self) -> list[float]:
        """Seconds per leg; on a card, after the synchronize."""
        for which, start, end in self._events:
            self.seconds[which] += start.elapsed_time(end) / 1e3
        self._events.clear()
        return self.seconds


_NO_LEG = contextlib.nullcontext()


def leg(legs: Legs | None, which: int, stream=None):
    """`legs.leg(which, stream)`, or a no-op when the call is not
    profiled."""
    return _NO_LEG if legs is None else legs.leg(which, stream)


def note_roundtrip(legs: Legs | None, up: int, down: int, sp=None) -> None:
    """A staged call's copy-ledger entries (the bytes up and down, with
    the legs' seconds when they were timed) and, for a profiled call, the
    legs as its span's `h2d_us` / `kernel_us` / `d2h_us` tags (the
    attribution waterfall's device buckets)."""
    h2d_s, kernel_s, d2h_s = legs.read() if legs is not None \
        else (0.0, 0.0, 0.0)
    copytrack.copied("h2d", up, h2d_s)
    copytrack.copied("d2h", down, d2h_s)
    if legs is not None and sp is not None:
        sp.set_tag("h2d_us", round(h2d_s * 1e6, 1))
        sp.set_tag("kernel_us", round(kernel_s * 1e6, 1))
        sp.set_tag("d2h_us", round(d2h_s * 1e6, 1))
