"""Every kernel launch of the port goes to the card its tensor lies on,
whatever the calling thread's current device is (K1, K2, K3).

No card is touched: stand-in tensors report `cuda:1`, and the CUDA device
guard (`torch.cuda.device`), the stream lookup (`_build.stream`), the
kernel libraries (`_build.load`) and the error check (`_build.check`) are
recorders. Each wrapper must launch once, inside `torch.cuda.device(cuda:1)`
and on cuda:1's stream."""
import contextlib
import ctypes

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ec import gf256
from ceph_tpu_torch.ops import _build, crc32c, rs_codec

CARD = torch.device("cuda", 1)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as lying on cuda:1."""

    @property
    def device(self):
        return CARD

    @property
    def is_cuda(self):
        return True


def _on_card(t: torch.Tensor) -> torch.Tensor:
    return t.as_subclass(_OnCard)


class _Recorder:
    """Stands in for the CUDA device guard, the stream lookup, the kernel
    libraries and the error check, and records what each launch saw."""

    def __init__(self, current: torch.device):
        self.current = current          # the thread's current device
        self.streams = []               # (device asked for, current device)
        self.launches = []              # (C entry, current device, stream)
        self.checked = []

    def device(self, dev):
        @contextlib.contextmanager
        def guard():
            prev, self.current = self.current, torch.device(dev)
            try:
                yield
            finally:
                self.current = prev
        return guard()

    def stream(self, dev) -> ctypes.c_void_p:
        dev = torch.device(dev)
        self.streams.append((dev, self.current))
        return ctypes.c_void_p(0x1000 + dev.index)

    def load(self, name, signatures):
        lib = type("Lib", (), {})()
        for fn in signatures:
            def launch(*args, _fn=fn):
                self.launches.append((_fn, self.current, args[-1].value))
                return 0
            setattr(lib, fn, launch)
        return lib

    def check(self, lib, name, rc):
        self.checked.append((name, rc))


def _alloc(real):
    """torch.empty / torch.zeros that give a stand-in for a CUDA device."""
    def alloc(*shape, dtype=None, device=None, **kwargs):
        t = real(*shape, dtype=dtype)
        if device is not None and torch.device(device).type == "cuda":
            return _on_card(t)
        return t
    return alloc


def _k1():
    M = gf256.reed_sol_van_matrix(4, 2)
    codec = rs_codec.MatrixCodec(M)
    data = np.random.default_rng(1).integers(0, 256, (2, 4, 64),
                                             dtype=np.uint8)
    rs_codec.apply_bitmatrix(_on_card(torch.from_numpy(codec.packed)),
                             _on_card(torch.from_numpy(codec.bitmatrix)),
                             _on_card(torch.from_numpy(data)))
    return "gf_bitmatrix_apply", "gf_bitmatrix", (rs_codec, "launches")


def _k2():
    crc = crc32c.Crc32cDevice(512, device="cpu")
    crc.device = CARD
    crc._tables = _on_card(torch.zeros(4 * 256, dtype=torch.int32))
    crc._advance = _on_card(torch.zeros(32, dtype=torch.int32))
    blocks = np.random.default_rng(2).integers(0, 256, (3, 512),
                                               dtype=np.uint8)
    crc.blocks(_on_card(torch.from_numpy(blocks)))
    return "crc32c_blocks_run", "crc32c_blocks", (crc32c, "launches")


def _k3():
    M = gf256.reed_sol_van_matrix(4, 2)
    data = np.random.default_rng(3).integers(0, 256, (2, 4, 64),
                                             dtype=np.uint8)
    rs_codec.encode_local(
        _on_card(torch.from_numpy(rs_codec.packed_bitmatrix(M))),
        _on_card(torch.from_numpy(gf256.matrix_to_bitmatrix(M))),
        _on_card(torch.from_numpy(data)))
    return ("gf_bitmatrix_csum_run", "gf_bitmatrix_csum",
            (rs_codec, "encode_local_launches"))


@pytest.mark.parametrize("current", [0, 2], ids=["current-cuda:0",
                                              "current-cuda:2"])
@pytest.mark.parametrize("wrapper", [_k1, _k2, _k3], ids=["K1", "K2", "K3"])
def test_launch_goes_to_the_tensor_card(monkeypatch, wrapper, current):
    rec = _Recorder(torch.device("cuda", current))
    monkeypatch.setattr(torch.cuda, "device", rec.device)
    monkeypatch.setattr(_build, "stream", rec.stream)
    monkeypatch.setattr(_build, "load", rec.load)
    monkeypatch.setattr(_build, "check", rec.check)
    monkeypatch.setattr(torch, "empty", _alloc(torch.empty))
    monkeypatch.setattr(torch, "zeros", _alloc(torch.zeros))
    monkeypatch.setattr(rs_codec, "_csum_scratch", {})
    for module, counter in ((rs_codec, "launches"), (crc32c, "launches"),
                            (rs_codec, "encode_local_launches")):
        monkeypatch.setattr(module, counter, 0)
    entry, lib, (module, counter) = wrapper()
    assert rec.launches == [(entry, CARD, 0x1001)]
    assert rec.streams == [(CARD, CARD)]
    assert rec.checked == [(lib, 0)]
    assert getattr(module, counter) == 1
    assert rec.current == torch.device("cuda", current)   # guard restored
    if entry == "gf_bitmatrix_csum_run":
        # K3's ticket and partials are kept per (card, stream)
        assert list(rs_codec._csum_scratch) == [(CARD, 0x1001)]
