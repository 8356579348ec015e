"""The port's access layers (ceph_tpu_torch/rbd, rgw, mds), vstart and
the operator tools against the JAX package's, on the CPU.

The reference's cases run on the port: each reference test source is
exec'd with its imports renamed to the port (`load_reference_tests`),
its cluster harness replaced by tests/test_cluster.py's exec'd on the
port with `OSD(device="cpu")`, every EC profile a client sets carried
through `convert.port_profile` with `device=cpu` (jerasure and the rest
of the port's plugins resolve their device from the profile), vstart's
and cephadm's OSDs given `device="cpu"`. The cases:

  tests/test_rbd_snaps_clones.py, test_rgw.py, test_rbd_cli_health.py,
      test_rbd_fs_cli.py, test_operator_tools.py and test_cephadm.py,
      all of them;
  tests/test_cephfs.py, all but :198 (it thrashes OSDs with
      qa/rados_model's Thrasher, which the port does not have yet);
  tests/test_mgr_report.py :55 (a vstart cluster with a mgr, an MDS and
      a gateway; its other cases run in tests/test_torch_mgr.py).

Then chip_smoke.py phase 16's composition (`AccessPass` +
`drive_access`) runs through each package at k=2 m=1 on 3 OSDs with
small objects: plugin `tpu` on JAX's CPU for the reference, `cuda` with
device=cpu for the port. Every read, every ETag and every shard left in
the stores must be equal between the two, and the phase's own invariants
must hold on the port's run.

Every cluster case runs under `asyncio.wait_for(..., 30)` and a hard
SIGALRM timeout, with the port's own leak gates.
"""
from __future__ import annotations

import asyncio
import inspect
import os
import re
import signal
import types

import numpy as np
import pytest

import chip_smoke
from ceph_tpu_torch import convert
from ceph_tpu_torch.mgr import DaemonStateIndex, MgrClient, MgrDaemon
from ceph_tpu_torch.mon.monitor import MgrMonitor
from ceph_tpu_torch.mon.paxos import Paxos
from ceph_tpu_torch.msg.messenger import Connection
from ceph_tpu_torch.osd.daemon import OSD
from ceph_tpu_torch.rados.client import RadosClient

from tests.test_torch_kv_objectstore import TESTS, load_reference_tests
from tests.test_torch_store_path import _NoWindow

CASE_TIMEOUT_S = 30
HARD_TIMEOUT_S = 60

#: tests/test_cluster.py's harness on the port's daemons
_PORT_CLUSTER = load_reference_tests(
    "test_cluster", True, [], {},
    edits=(("osd = OSD(i, self.mon_addrs, store=store)",
            'osd = OSD(i, self.mon_addrs, store=store, device="cpu")'),
           ("def run(coro, timeout=120)",
            f"def run(coro, timeout={CASE_TIMEOUT_S})")))
ClusterHarness = _PORT_CLUSTER.ClusterHarness
run = _PORT_CLUSTER.run

_HARNESS = ("from tests.test_cluster import ClusterHarness, fast_timers, "
            "run  # noqa: F401")
_PORT_HARNESS = "from tests.test_torch_access import ClusterHarness, run"
_VSTART = "with_mgr=True, with_mds=True, with_rgw=True)"
_OSD_SPECS = (('"backend": "bluestore"}', '"backend": "bluestore", '
               '"device": "cpu"}'),
              ('"backend": "memstore"}', '"backend": "memstore", '
               '"device": "cpu"}'))

#: reference file -> the edits its source takes on the port
SOURCES = {
    "test_rbd_snaps_clones": ((_HARNESS, _PORT_HARNESS),),
    "test_rgw": ((_HARNESS, _PORT_HARNESS),),
    "test_cephfs": ((_HARNESS, _PORT_HARNESS),),
    "test_rbd_cli_health": ((_HARNESS, _PORT_HARNESS),),
    "test_rbd_fs_cli": ((_HARNESS, _PORT_HARNESS),),
    "test_operator_tools": ((_HARNESS, _PORT_HARNESS),),
    "test_cephadm": (("from tests.test_cluster import fast_timers, run  "
                      "# noqa: F401",
                      "from tests.test_torch_access import run"),
                     *_OSD_SPECS),
    "test_mgr_report": ((_HARNESS, _PORT_HARNESS),
                        (_VSTART, _VSTART[:-1] + ', device="cpu")')),
}

#: cases left out, with the reason
SKIPPED = {("test_cephfs", "test_cephfs_survives_osd_thrashing"):
           "qa/rados_model's Thrasher is not ported yet"}
#: test_mgr_report's cases that tests/test_torch_mgr.py runs
MGR_REPORT_ELSEWHERE = {"test_slow_ops_health_mute_ttl",
                        "test_daemon_churn_eviction_and_rejoin",
                        "test_metrics_name_lint",
                        "test_digest_checks_and_progress", "test_perf_reset"}


def _cases(name: str) -> list[tuple]:
    """(file, case, parameter) for every case of tests/<name>.py as
    pytest collects it, less those run elsewhere or left out."""
    src = open(os.path.join(TESTS, name + ".py")).read()
    out = []
    for m in re.finditer(r"^((?:@pytest\.mark\.parametrize\([^\n]*\)\n)?)"
                         r"def (test_\w+)\(", src, re.M):
        deco, case = m.groups()
        if (name, case) in SKIPPED or (name == "test_mgr_report"
                                        and case in MGR_REPORT_ELSEWHERE):
            continue
        params = re.findall(r'"(\w+)"', deco.split(",", 1)[1]) if deco \
            else [None]
        out += [(name, case, p) for p in params]
    return out


CASES = [c for name in SOURCES for c in _cases(name)]


def _fast_timers(mp) -> None:
    """tests/test_cluster.py's fast timers on both packages' classes."""
    from ceph_tpu.mon.paxos import Paxos as RefPaxos
    from ceph_tpu.msg.messenger import Connection as RefConnection
    from ceph_tpu.osd.daemon import OSD as RefOSD
    for paxos, conn, osd in ((Paxos, Connection, OSD),
                             (RefPaxos, RefConnection, RefOSD)):
        mp.setattr(paxos, "ELECTION_TIMEOUT", 0.15)
        mp.setattr(paxos, "LEASE_INTERVAL", 0.2)
        mp.setattr(paxos, "LEASE_TIMEOUT", 1.0)
        mp.setattr(paxos, "ACCEPT_TIMEOUT", 0.8)
        mp.setattr(conn, "KEEPALIVE_INTERVAL", 0.3)
        mp.setattr(conn, "KEEPALIVE_TIMEOUT", 1.5)
        mp.setattr(conn, "PARK_TIMEOUT", 2.0)
        mp.setattr(osd, "HB_INTERVAL", 0.25)
        mp.setattr(osd, "HB_GRACE", 1.2)


def _keep_offload_defaults(mp) -> None:
    """A daemon's `config set ec_offload_*` rewrites its package's
    module-wide service defaults (`register_config`): give each package
    a copy for the test, so that what a cluster here sets (phase 16 turns
    the device crc on) reaches no later test in this process."""
    from ceph_tpu.offload import service as ref_service
    from ceph_tpu_torch.offload import service
    for mod in (service, ref_service):
        mp.setattr(mod, "_DEFAULTS", dict(mod._DEFAULTS))


@pytest.fixture(autouse=True)
def _guards(monkeypatch):
    """Fast timers, the offload services' defaults kept, EC profiles in
    the port's names with device=cpu, a hard timeout that fires even in
    a loop that never yields, and the port's own leak gates
    (tests/conftest.py gates the reference's modules)."""
    _fast_timers(monkeypatch)
    _keep_offload_defaults(monkeypatch)
    command = RadosClient.command

    async def port_profiles(self, cmd, timeout=30.0):
        if cmd.get("prefix") == "osd erasure-code-profile set":
            cmd = dict(cmd, profile={**convert.port_profile(cmd["profile"]),
                                     "device": "cpu"})
        return await command(self, cmd, timeout=timeout)
    monkeypatch.setattr(RadosClient, "command", port_profiles)

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


def test_every_reference_case_is_mirrored():
    """The eight files' cases (test_rbd_cli_health's end-to-end case for
    both pool types), less the Thrasher case, with test_mgr_report's
    others in tests/test_torch_mgr.py."""
    from tests.test_torch_mgr import CASES as MGR_CASES
    counts = {}
    for name, _, _ in CASES:
        counts[name] = counts.get(name, 0) + 1
    assert counts == {"test_rbd_snaps_clones": 6, "test_rgw": 6,
                      "test_cephfs": 6, "test_rbd_cli_health": 4,
                      "test_rbd_fs_cli": 2, "test_operator_tools": 4,
                      "test_cephadm": 2, "test_mgr_report": 1}
    src = open(os.path.join(TESTS, "test_mgr_report.py")).read()
    every = set(re.findall(r"^def (test_\w+)\(", src, re.M))
    here = {c for n, c, _ in CASES if n == "test_mgr_report"}
    there = {c for n, c, _ in MGR_CASES if n == "test_mgr_report"}
    assert here | there == every and not here & there
    assert there == MGR_REPORT_ELSEWHERE


def _file_fixtures(source: str, monkeypatch, tmp_path, capsys) -> dict:
    """The reference file's own autouse fixtures, on the port's modules,
    and the fixture arguments its cases take."""
    if source == "test_mgr_report":
        # fast_reporting: report/beacon periods that converge in test time
        monkeypatch.setattr(MgrClient, "REPORT_PERIOD", 0.2)
        monkeypatch.setattr(MgrDaemon, "TICK_INTERVAL", 0.2)
        monkeypatch.setattr(MgrDaemon, "REPORT_PERIOD", 0.2)
        monkeypatch.setattr(DaemonStateIndex, "STALE_AFTER", 2.0)
        monkeypatch.setattr(MgrMonitor, "BEACON_GRACE", 2.0)
    return {"tmp_path": tmp_path, "monkeypatch": monkeypatch,
            "capsys": capsys}


@pytest.mark.parametrize("source,case,param", CASES,
                         ids=[f"{s}::{c}" + (f"[{p}]" if p else "")
                              for s, c, p in CASES])
def test_reference_access_case_on_the_port(source, case, param, tmp_path,
                                           monkeypatch, capsys):
    mod = load_reference_tests(source, True, [], {}, edits=SOURCES[source])
    args = _file_fixtures(source, monkeypatch, tmp_path, capsys)
    fn = getattr(mod, case)
    names = list(inspect.signature(fn).parameters)
    if param is not None:
        args[names[-1]] = param
    fn(*[args[p] for p in names])


# -- phase 16's composition through both packages ------------------------------

#: k=2 m=1 on 3 OSDs: 64 KiB objects (RBD order 16 and the MDS stripe)
SIZES = {"obj": 64 << 10, "image": 4 << 20, "rbd_objects": 8,
         "rbd_overwrites": 32, "s3_objects": 4, "s3_part": 40 << 10,
         "s3_parts": 3, "fs_objects": 4, "fs_overwrites": 16,
         "fs_purge_objects": 2, "small": 4096, "inflight": 4, "victim": 2}
KA, MA, PGS = 2, 1, 4


def _reference_modules():
    from ceph_tpu import offload
    from ceph_tpu.mds import CephFS, MDSDaemon
    from ceph_tpu.mds.daemon import data_oid
    from ceph_tpu.native import ec_native
    from ceph_tpu.rbd import RBD, Image
    from ceph_tpu.rgw import RGWGateway
    from ceph_tpu.rgw.gateway import _data_oid
    from ceph_tpu.tools.vstart import VCluster
    zero = {"gf_bitmatrix": 0, "crc32c_blocks": 0, "gf_bitmatrix_csum": 0}
    return types.SimpleNamespace(
        VCluster=VCluster, RBD=RBD, Image=Image, RGWGateway=RGWGateway,
        MDSDaemon=MDSDaemon, CephFS=CephFS, fs_data_oid=data_oid,
        rgw_data_oid=_data_oid, ec_native=ec_native, offload=offload,
        plugin="tpu", counts=lambda: dict(zero), reset=lambda: None,
        profile_extra=lambda device: {},
        cluster_kwargs=lambda device: {})


def _drive(mods, root: str) -> dict:
    ap = chip_smoke.AccessPass(mods, root, "cpu", KA, MA, PGS, SIZES)
    out = asyncio.run(asyncio.wait_for(
        chip_smoke.drive_access(ap, np, _NoWindow(None)), CASE_TIMEOUT_S))
    out["models"] = {"rbd": bytes(ap.rbd_model), "fs": bytes(ap.fs_model),
                     "s3": dict(ap.s3)}
    return out


@pytest.fixture(scope="module")
def composed(tmp_path_factory):
    """drive_access through the reference and through the port, each
    bounded by a hard timeout of its own."""
    mp = pytest.MonkeyPatch()
    _fast_timers(mp)
    _keep_offload_defaults(mp)
    # the fast timers' grace, in place of upstream's 20 s the phase sets
    mp.setattr(chip_smoke, "ACCESS_HB_GRACE_S", 1.2)

    def expire(signum, frame):
        raise TimeoutError(f"a pass ran past {HARD_TIMEOUT_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    out = {}
    try:
        for name, mods in (("ref", _reference_modules()),
                           ("port", chip_smoke.access_modules())):
            signal.setitimer(signal.ITIMER_REAL, HARD_TIMEOUT_S)
            out[name] = _drive(mods, str(tmp_path_factory.mktemp(name)))
            signal.setitimer(signal.ITIMER_REAL, 0)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
        mp.undo()
    return out


def test_access_reads_and_etags_equal_the_reference(composed):
    ref, port = composed["ref"], composed["port"]
    assert port["models"] == ref["models"]
    assert port["etags"] == ref["etags"]
    assert set(port["etags"]) == {*(f"o{i:03d}" for i in range(4)), "mp"}
    assert port["etags"]["mp"].endswith("-3")


def test_access_store_objects_equal_the_reference(composed):
    """Every shard of every EC data object, on every OSD, equal in both
    packages (and to the host codec: drive_access checks that)."""
    ref, port = composed["ref"], composed["port"]
    assert port["store"] == ref["store"]
    objects = SIZES["rbd_objects"] + SIZES["fs_objects"] + \
        SIZES["s3_objects"] + 1
    assert port["d"] == {"shards": (KA + MA) * objects, "objects": objects}


def test_phase_16_invariants_on_the_port(composed):
    port = composed["port"]
    for step in chip_smoke.ACCESS_STEPS:
        assert port[step]["fallback_ops"] == 0, step
        assert port[step]["seconds"] > 0 and port[step]["gb_s"] > 0, step
        assert 0 < port[step]["io_s"] <= port[step]["seconds"], step
    assert "window_enter_s" in port["a_write"]
    for step in ("boot", *chip_smoke.ACCESS_STEPS):
        assert 0 <= port[step]["loop_stall_max_s"] < 30, step
    # every write goes through the service's batches, and so do the
    # degraded reads' decodes
    for step in ("a_write", "a_overwrite", "b_put", "b_multipart",
                 "c_write", "c_overwrite", "c_purge", "e"):
        assert port[step]["batches"] > 0, step
    assert port["fallback_ops"] == 0
    assert port["e"]["victim"] == SIZES["victim"]
    assert port["c_purge"]["purged"] == SIZES["fs_purge_objects"]
    assert {"osd", "mon", "mds", "rgw"} <= set(port["f"]["services"])
    assert {"mds.a", "rgw.0", "rgw.ec"} <= set(port["f"]["daemons"])
    assert sorted(port["f"]["device_rows"]) == [
        f"osd.{i}" for i in range(KA + MA)]
    assert port["f"]["health"].startswith("HEALTH_")


def test_phase_16_log_lines(composed, capsys):
    """log_access renders the port's record as the card's run does."""
    r = dict(composed["port"], launches={}, idle_share=None, busy_s=None,
             sizes=SIZES, drive_s=1.0)
    chip_smoke.log_access(r, "cpu")
    text = capsys.readouterr().out
    for step in ("16a", "16b", "16c", "16d", "16e", "16f"):
        assert f"phase {step} [cpu]" in text, step


def test_loop_watch_reports_a_stall(capsys):
    """phase 16's LoopWatch: a loop blocked past `loud_s` is logged as the
    stall ends and read back by since()."""
    import time

    async def body():
        async with chip_smoke.LoopWatch(loud_s=0.1) as watch:
            await asyncio.sleep(0.1)
            t0 = time.perf_counter()
            time.sleep(0.4)
            await asyncio.sleep(0.1)
        return watch.since(t0)
    got = asyncio.run(asyncio.wait_for(body(), CASE_TIMEOUT_S))
    assert got["loop_stall_max_s"] >= 0.3
    assert "loop watch: the loop stalled" in capsys.readouterr().out

