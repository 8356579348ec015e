"""The port's process-backed reactor (ceph_tpu_torch/utils/reactor.py
ProcShardPool and utils/reactor_worker.py) against the JAX package's, on
the CPU.

The four cases of tests/test_reactor_procs.py run on the port: the
reference test source is exec'd with its imports renamed to the port
(`load_reference_tests`), its EC profile and its clusters on
`device="cpu"` (the workers boot `OSD(device="cpu")`). Then a seeded EC
round trip through the port's process-backed cluster (plugin `cuda` on
the CPU, two workers) is held equal, object by object, to the
reference's single-loop cluster (plugin `tpu` on JAX's CPU); the port's
device partition is held equal to the reference's over well-formed and
malformed values, with the CPU device list it slices; the spawn command
names the port's worker module; and without a card a process-backed
cluster on `cuda` raises DeviceUnavailable from the worker's boot.
"""
from __future__ import annotations

import asyncio
import inspect
import os
import signal

import numpy as np
import pytest
import torch

from ceph_tpu.offload import service as ref_service
from ceph_tpu.tools.cluster_boot import ephemeral_cluster as ref_cluster
from ceph_tpu_torch import device as _device
from ceph_tpu_torch.device import DeviceUnavailable
from ceph_tpu_torch.tools.cluster_boot import ephemeral_cluster
from ceph_tpu_torch.utils import reactor
from ceph_tpu_torch.utils.reactor import ProcShardPool

from tests.test_torch_kv_objectstore import TESTS, load_reference_tests

HARD_TIMEOUT_S = 90
_JER = '"technique": "reed_sol_van"}})'
_JER_CPU = '"technique": "reed_sol_van", "device": "cpu"}})'
_RUN_180 = "def run(coro, timeout=180):"
_RUN_60 = "def run(coro, timeout=60):"


@pytest.fixture(autouse=True)
def _guards():
    """A hard timeout that fires even in a loop that never yields, and
    the port's own leak gates (tests/conftest.py gates the reference's
    modules)."""
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


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _reference_cases() -> list[str]:
    import re
    src = open(os.path.join(TESTS, "test_reactor_procs.py")).read()
    return re.findall(r"^def (test_\w+)\(", src, re.M)


PROC_CASES = _reference_cases()


def test_every_reference_proc_case_is_mirrored():
    assert len(PROC_CASES) == 4, PROC_CASES


@pytest.mark.parametrize("case", PROC_CASES)
def test_reference_proc_case_on_the_port(case):
    mod = load_reference_tests(
        "test_reactor_procs", True, [], {},
        edits=((_RUN_180, _RUN_60), (_JER, _JER_CPU),
               ("reactor_procs=procs)",
                'reactor_procs=procs, device="cpu")'),
               ("reactor_procs=2)", 'reactor_procs=2, device="cpu")')))
    assert mod.ProcShardPool is ProcShardPool
    fn = getattr(mod, case)
    assert not inspect.signature(fn).parameters
    fn()


# -- a seeded EC round trip: the port's workers against the reference -------

SIZES = (1, 4095, 4096, 8192, 9000, 20000, 65543, 100000)


def _payloads() -> dict[str, bytes]:
    rng = np.random.default_rng(42)
    return {f"o{i}": rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for i, n in enumerate(SIZES)}


async def _roundtrip(cluster, plugin: dict, payloads: dict, **kw) -> dict:
    got = {}
    async with cluster(3, prefix="procpar-", **kw) as (client, osds, _mon):
        await client.command({
            "prefix": "osd erasure-code-profile set", "name": "pp",
            "profile": {"k": "2", "m": "1", **plugin}})
        await client.pool_create("pp", pg_num=4, pool_type="erasure",
                                 erasure_code_profile="pp")
        io = client.ioctx("pp")
        await asyncio.gather(*[io.write_full(oid, data)
                               for oid, data in payloads.items()])
        for oid in payloads:
            got[oid] = bytes(await io.read(oid))
        if kw.get("reactor_procs"):
            pool = osds[0].pool
            # the workers run the port's module, and their OSDs took the
            # partitioned CPU slots (8 slots over 2 workers)
            for i in (1, 2):
                pid = pool.worker_pid(i)
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    argv = f.read().split(b"\0")
                assert b"ceph_tpu_torch.utils.reactor_worker" in argv
                st = await pool.call(i, {"prefix": "device status"})
                assert st["devices"] == ["cpu"] * 4
                off = await pool.call(i, "ec offload status")
                assert off["fallback_ops"] == 0
    return got


def test_proc_cluster_equals_reference_single_loop():
    payloads = _payloads()
    ref = run(_roundtrip(ref_cluster, {"plugin": "tpu"}, payloads))
    port = run(_roundtrip(ephemeral_cluster,
                          {"plugin": "cuda", "device": "cpu"}, payloads,
                          reactor_procs=2, device="cpu"))
    for oid, data in payloads.items():
        assert ref[oid] == data, oid
        assert port[oid] == ref[oid], oid


# -- the device partition -----------------------------------------------------

@pytest.mark.parametrize("raw", ["", "0/2", "1/2", "3/2", "1/0", "-1/2",
                                 "a/b"])
def test_device_partition_equals_the_reference(raw, monkeypatch):
    monkeypatch.setenv(_device.PARTITION_ENV, raw)
    assert _device._device_partition() == ref_service._device_partition()
    # the reference slices JAX's 8 virtual CPU devices; the port slices
    # its 8 CPU slots the same way
    ref_ids = [st.jdev.id
               for st in ref_service._Topology().device_states(0)]
    assert _device.partition(list(range(8))) == ref_ids
    assert _device.service_devices("cpu") == \
        [torch.device("cpu")] * len(ref_ids)


def test_one_card_is_shared_by_every_worker(monkeypatch):
    """W workers over fewer cards than W: each takes the first card."""
    cards = [torch.device("cuda", 0)]
    for j in range(4):
        monkeypatch.setenv(_device.PARTITION_ENV, f"{j}/4")
        assert _device.partition(cards) == cards


# -- the spawn line and the card ----------------------------------------------

def test_spawn_command_names_the_ports_worker(monkeypatch):
    """The worker module is a string in the spawn command, out of reach
    of an import rename: it must be the port's."""
    spawned = []

    class FakeProc:
        pid, returncode = 1, 0

        def __init__(self, cmd, env=None, stdout=None):
            spawned.append((cmd, env))

        def poll(self):
            return 0

        def wait(self, timeout=None):
            return 0

        def kill(self):
            pass

    monkeypatch.setattr(reactor.subprocess, "Popen", FakeProc)

    async def body():
        pool = ProcShardPool(2, name="t-spawn")
        await pool.shutdown()
    run(body())
    assert [cmd[1:3] for cmd, _ in spawned] == \
        [["-m", "ceph_tpu_torch.utils.reactor_worker"]] * 2
    assert [env[_device.PARTITION_ENV] for _, env in spawned] == \
        ["0/2", "1/2"]


def test_proc_cluster_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")

    async def body():
        async with ephemeral_cluster(1, prefix="procnocard-",
                                     reactor_procs=1, device="cuda"):
            pass
    with pytest.raises(DeviceUnavailable, match="CUDA"):
        run(body())
