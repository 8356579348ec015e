"""chip_smoke.py phase 13's composition on the CPU, through both packages:
an EC object placed by CRUSH, its shards carried as MOSDECSubOpWrite over
two loopback Messengers into one BlueStore an OSD, read back after a
remount, decoded around a bitrot'd shard and around a host taken out.

At a small size (k=4 m=2, 4 KiB chunks, 6 stores on 5 hosts, 2 on
host0; 20 stripes, so that each shard outgrows BlueStore's 64 KiB inline
limit and lands in block-file extents with per-AU csums) the port with plugin `cuda` on the CPU and the JAX package
with plugin `tpu` on JAX's CPU must agree on the shard bytes, the
BlueStores' per-AU csum lists, each shard's `hinfo_key`, the acting sets
before and after the host goes out (CRUSH's up set and the pg_temp'd
acting set), the decoded bytes, and every file the
stores leave on disk. Then the phase itself (`phase_store_path`) runs on
the CPU at the north star's k=8 m=3 over 11 stores, with small chunks.
"""
from __future__ import annotations

import asyncio
import json
import os
import signal
import types

import numpy as np
import pytest
import torch

import chip_smoke
from ceph_tpu_torch import convert

K, M, CHUNK, STRIPES = 4, 2, 4096, 20
LAYOUT = (2, 1, 1, 1, 1)
PROFILE = {"k": str(K), "m": str(M), "technique": "reed_sol_van",
           "crush-failure-domain": "osd"}
HARD_TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _guards():
    """A hard timeout that fires even in a loop that never yields, and
    the port's own leak gates (tests/conftest.py gates the
    reference's modules)."""
    def expire(signum, frame):
        raise TimeoutError(f"test ran past {HARD_TIMEOUT_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, HARD_TIMEOUT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
    from ceph_tpu_torch.utils import loopprof, sanitizer
    assert not loopprof.installed_loops(), "port loopprof left armed"
    strays = sanitizer.take_foreign_call_soon()
    assert not strays, f"port sanitizer saw foreign call_soon: {strays}"


def _reference_modules():
    from ceph_tpu import crush, objectstore
    from ceph_tpu.ec.registry import factory
    from ceph_tpu.msg import frames, messages, messenger
    from ceph_tpu.osd import ec_util
    return types.SimpleNamespace(
        crush=crush, objectstore=objectstore, factory=factory,
        frames=frames, messages=messages, messenger=messenger,
        ec_util=ec_util)


def _tree(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _compose(mods, root, plugin, extra):
    path = chip_smoke.StorePath(mods, str(root), K, M, CHUNK, STRIPES,
                                LAYOUT, {"plugin": plugin, **PROFILE},
                                extra, seed=42)
    out = asyncio.run(asyncio.wait_for(
        chip_smoke.drive_store_path(path), 45))
    path.close()
    return path, out


@pytest.fixture(scope="module")
def composed(tmp_path_factory):
    root = tmp_path_factory.mktemp("store_path")
    ref, ref_out = _compose(_reference_modules(), root / "ref", "tpu", {})
    port, port_out = _compose(chip_smoke.port_modules(), root / "port",
                              "cuda", {"device": "cpu"})
    return ref, ref_out, port, port_out, root


def test_shards_and_stores_equal_the_reference(composed):
    ref, _, port, _, root = composed
    assert {s: bytes(b) for s, b in port.shards.items()} == \
        {s: bytes(b) for s, b in ref.shards.items()}
    assert port.csums == ref.csums
    assert sum(len(v) for v in port.csums.values()) == \
        (K + M) * STRIPES * CHUNK // 4096
    assert port.hinfo_keys == ref.hinfo_keys
    hinfo = json.loads(port.hinfo_keys[0])
    assert hinfo["total_chunk_size"] == STRIPES * CHUNK
    assert _tree(str(root / "port")) == _tree(str(root / "ref"))


def test_placement_equals_the_reference(composed):
    ref, ref_out, port, port_out, _ = composed
    assert port.acting == ref.acting
    assert port.acting_after == ref.acting_after
    assert port.up_after == ref.up_after
    assert port_out["d"]["acting_after"].count(
        chip_smoke.port_modules().crush.CRUSH_NONE) == M
    assert json.loads(port.osdmap.dumps()) == \
        convert.port_osdmap(json.loads(ref.osdmap.dumps()))


def test_decoded_bytes_equal_the_reference(composed):
    ref, ref_out, port, port_out, _ = composed
    assert port.decoded_rot == ref.decoded_rot == port.data
    assert port.decoded_out == ref.decoded_out == port.data
    assert port_out["c"]["rot_shard"] == ref_out["c"]["rot_shard"] < K
    assert port_out["c"]["error"].startswith("EIO")
    assert port_out["c"]["shards_read"] == K + M - 1
    assert port_out["a"]["messages"] == (K + M) * STRIPES


class _NoWindow:
    """Stands in for chip_smoke.DeviceWindow where there is no card."""
    idle_share = None

    def __init__(self, torch_mod):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_phase_13_rehearsed_on_the_cpu(monkeypatch):
    """phase_store_path at k=8 m=3 over 11 stores on 5 hosts, 64 KiB
    chunks, 2 stripes (128 KiB shards: block-file extents), plugin `cuda` on the CPU: every stage runs, the
    temporary stores are removed, and the comparison line holds the
    host crc equal to the stores' csums."""
    monkeypatch.setattr(chip_smoke, "CHUNK", 64 << 10)
    made = []
    import tempfile
    orig = tempfile.mkdtemp

    def mkdtemp(*a, **kw):
        made.append(orig(*a, **kw))
        return made[-1]
    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    out = chip_smoke.phase_store_path(torch, np, torch.device("cpu"), "cpu",
                                      None, window_cls=_NoWindow, stripes=2)
    assert made and not os.path.exists(made[0])
    assert out["a"]["messages"] == 11 * 2
    assert out["b"]["aus"] == 11 * 2 * (64 << 10) // 4096
    assert out["k2_compare"]["blocks"] == out["b"]["aus"]
    assert out["k2_compare"]["k2_ms"] is None
    assert out["launches"]["crc32c_blocks"] == 0
    assert sorted(out["acting"]["before"]) == list(range(11))
    assert out["acting"]["after"].count(
        chip_smoke.port_modules().crush.CRUSH_NONE) == 3
    chip_smoke.log_store_path(out, "cpu")
