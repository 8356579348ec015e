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
