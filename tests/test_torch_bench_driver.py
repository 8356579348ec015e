"""The port's bench driver (ceph_tpu_torch/tools/bench_driver.py) on the
CPU: each stage returns the keys of the JAX package's stage of the same
name (listed here), each measured (> 0), at the CPU's small shapes; the
stages are wired to their keys through `main`, and a measurement that
fails is not hidden: it raises, or `main` exits non-zero naming the keys
that read zero."""
import json

import pytest

from ceph_tpu_torch.tools import bench_driver, ec_benchmark

#: ceph_tpu/tools/bench_driver.py stage_device's keys on one device
DEVICE_KEYS = ("platform", "backend_init_s", "tpu_encode", "tpu_decode",
               "device_peak_gbps", "tpu_encode_roofline_pct", "tpu_crc32c",
               "link_h2d_cold_gbps", "link_h2d_gbps", "tpu_encode_host",
               "host_encode_link_efficiency", "scalar_encode", "elapsed_s")
#: stage_cpu's, with the messenger microbenches' msgr_* keys
CPU_KEYS = ("cpu_native_encode", "cpu_native_decode", "cpu_numpy_encode",
            "cpu_crc32c", "msgr_frames_per_s_native",
            "msgr_frames_per_s_python", "msgr_frame_native_speedup",
            "msgr_saturated_frames_per_write", "msgr_saturated_msgs_per_s")
PROBE_KEYS = ("platform", "device_count", "init_s")
#: _mesh_scaling_body's
SCALING_KEYS = ("device_scaling_gb_s", "scaling_devices",
                "scaling_platform", "scaling_virtual_devices",
                "scaling_ideal_parallelism", "scaling_bit_identical",
                "scaling_efficiency_raw", "scaling_efficiency")


def _measured(out: dict, keys) -> None:
    assert tuple(out) == keys
    for key in keys:
        if key.endswith("platform"):
            assert out[key] == "cpu"
        elif isinstance(out[key], bool):
            assert out[key] is True, key
        elif isinstance(out[key], dict):
            assert out[key] and all(v > 0 for v in out[key].values()), key
        else:
            assert out[key] > 0, key


@pytest.fixture(scope="module")
def device_stage():
    return bench_driver.stage_device("cpu")


def test_stage_device_returns_the_reference_keys(device_stage):
    _measured(device_stage, DEVICE_KEYS)
    assert device_stage["tpu_encode_roofline_pct"] == pytest.approx(
        100 * device_stage["tpu_encode"] / device_stage["device_peak_gbps"],
        rel=1e-2)
    assert device_stage["host_encode_link_efficiency"] == pytest.approx(
        device_stage["tpu_encode_host"] / device_stage["link_h2d_gbps"],
        rel=5e-2)


def test_stage_cpu_returns_the_reference_keys():
    _measured(bench_driver.stage_cpu(), CPU_KEYS)


def test_mesh_scaling_over_slots_of_one_device():
    out = bench_driver._mesh_scaling_body("cpu", chunk=4096)
    _measured(out, SCALING_KEYS)
    assert list(out["device_scaling_gb_s"]) == ["1", "2", "4"]
    assert out["scaling_devices"] == 4


@pytest.mark.parametrize("stage,keys", [("probe", PROBE_KEYS),
                                        ("device", DEVICE_KEYS)])
def test_main_prints_one_json_line_of_the_stage(stage, keys, capsys):
    assert bench_driver.main(["--stage", stage, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    _measured(json.loads(lines[0]), keys)


def test_main_names_keys_that_read_zero(monkeypatch, capsys):
    monkeypatch.setattr(bench_driver, "stage_probe", lambda device: {
        "platform": "cpu", "device_count": 1, "init_s": 0.0})
    assert bench_driver.main(["--stage", "probe", "--device", "cpu"]) == 1
    assert "['init_s']" in capsys.readouterr().err


def test_a_failed_measurement_raises(monkeypatch):
    def broken(cfg):
        raise RuntimeError("kernel failed")
    monkeypatch.setattr(ec_benchmark, "run_bench", broken)
    with pytest.raises(RuntimeError, match="kernel failed"):
        bench_driver.stage_device("cpu")


#: ceph_tpu/tools/bench_driver.py stage_cluster's keys, in its order
CLUSTER_KEYS = tuple(f"cluster_{pool}_{key}" for pool in ("rep", "ec")
                     for key in ("write_mb_s", "read_mb_s", "write_p99_ms",
                                 "read_p99_ms")) + ("health",)
HEALTH_KEYS = ("scope", "status", "checks", "daemon_report_ages",
               "metric_daemons", "metric_lines")


def _short_rados_bench(monkeypatch, seconds: float = 0.5) -> list:
    """rados_bench._main with its phases cut from the stage's 4 s to
    `seconds`; the namespaces it was handed."""
    from ceph_tpu_torch.tools import rados_bench
    seen, orig = [], rados_bench._main

    async def short(args):
        seen.append(vars(args).copy())
        args.seconds = seconds
        return await orig(args)
    monkeypatch.setattr(rados_bench, "_main", short)
    return seen


def test_stage_cluster_keeps_the_reference_keys(monkeypatch, capsys):
    """--stage cluster on the CPU: both rados bench pools measured on
    the given device, and the probe's fresh vstart cluster (mgr, MDS,
    gateway) reporting through the mgr."""
    import signal

    def expire(signum, frame):
        raise TimeoutError("stage_cluster ran past 120 s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, 120)
    try:
        seen = _short_rados_bench(monkeypatch)
        assert bench_driver.main(["--stage", "cluster", "--device",
                                  "cpu"]) == 0
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert tuple(out) == CLUSTER_KEYS
    for key in CLUSTER_KEYS[:-1]:
        assert out[key] > 0, key
    assert [(a["pool_type"], a["plugin"], a["k"], a["m"], a["device"],
             a["seconds"]) for a in seen] == [
        ("replicated", "jerasure", 0, 0, "cpu", 4.0),
        ("erasure", "jerasure", 2, 2, "cpu", 4.0)]
    health = out["health"]
    assert tuple(health) == HEALTH_KEYS
    assert health["status"].startswith("HEALTH_")
    assert {"mds.a", "rgw.0", "mon.m0", "osd.0"} <= set(
        health["metric_daemons"])


def test_stage_cluster_probe_failure_raises(monkeypatch):
    """The reference records a failed probe as "probe failed: ..."; the
    port's raises, so `main` exits non-zero."""
    from ceph_tpu_torch.tools import rados_bench, vstart

    async def bench(args):
        return {"write": {"mb_per_s": 1.0, "lat_p99_ms": 1.0},
                "read": {"mb_per_s": 1.0, "lat_p99_ms": 1.0}}

    async def broken(self):
        raise RuntimeError("probe cluster failed to boot")
    monkeypatch.setattr(rados_bench, "_main", bench)
    monkeypatch.setattr(vstart.VCluster, "start", broken)
    with pytest.raises(RuntimeError, match="probe cluster failed"):
        bench_driver.stage_cluster("cpu")
