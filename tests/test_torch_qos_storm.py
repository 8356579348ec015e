"""The bench driver's QoS storm on the port, and the reference's op-queue
cases on the port's ShardedOpQueue, on the CPU.

`stage_qos_storm` is the reference's function but for the seams
tests/test_torch_isolation.py lists (its device, and its pool on plugin
cuda k=2 m=2 where the reference's is jerasure). Here: it records the
reference's keys, read from both sources; it raises without a card unless
it is given the CPU; `main`'s verdict on its flags, error counts and the
keys whose zero is a reading, with the stage stubbed (the victims' SLO
grade is recorded, not gated). The whole stage
(1000 clients over 3 worker processes, about 4 minutes here) is the
slow case: chip_smoke's phase 19 with `--device cpu`.

tests/test_op_queue.py is exec'd with its imports renamed to the port
(`load_reference_tests`), its cluster harness replaced by
tests/test_cluster.py's exec'd on the port with `OSD(device="cpu")`:
the sharded queue the storm toggles between its weighted round robin
and dmclock. tests/test_qos.py already runs on the port in
tests/test_torch_pg.py.

Every cluster case runs under `asyncio.wait_for(..., 30)` and a hard
SIGALRM timeout, with the port's own leak gates.
"""
from __future__ import annotations

import inspect
import json
import os
import re
import signal

import pytest
import torch

import chip_smoke
from ceph_tpu_torch.device import DeviceUnavailable
from ceph_tpu_torch.tools import bench_driver

# _guards is autouse: the fast timers, the services' defaults kept, EC
# profiles in the port's names with device=cpu, the hard timeout
from tests.test_torch_access import _guards  # noqa: F401
from tests.test_torch_access import (_HARNESS, _PORT_HARNESS, TESTS,
                                     load_reference_tests)
from tests.test_torch_stages import SOURCES, _stage_keys

QOS_KEYS = _stage_keys(SOURCES["ref"], "stage_qos_storm")
FLAGS = ("qos_fairness_ok",)
#: grades recorded and not gated (bench_driver's FLAG_KEYS says why)
RECORDED = ("qos_victim_slo_ok",)
ERROR_KEYS = ("qos_baseline_errors", "qos_errors_off", "qos_errors_on",
              "qos_shed_errors")
#: counts that may honestly read 0 on another host (bench_driver's
#: ZERO_IS_A_READING says why)
MAY_READ_ZERO = ("qos_deferred_waits", "qos_backpressure_crumbs")
#: counts whose 0 means a leg of the stage did not happen
MUST_BE_ABOVE_ZERO = ("qos_recovery_pushes", "qos_shed_total",
                      "qos_throttled_ops", "qos_mgr_tenants",
                      "qos_exporter_families")


# -- the stage: keys, device, main's verdict ---------------------------------

def test_stage_writes_the_reference_keys():
    assert _stage_keys(SOURCES["port"], "stage_qos_storm") == QOS_KEYS
    assert len(QOS_KEYS) == 38


def test_gates_name_keys_of_the_stage():
    """Each flag and error count is a key the stage records; the error
    counts and the two counts that may read 0 elsewhere are readings at
    0; the legs' counts are not; the SLO grade is not a flag."""
    assert bench_driver.FLAG_KEYS["qos_storm"] == FLAGS
    assert set(RECORDED) <= QOS_KEYS
    assert not set(RECORDED) & set(FLAGS)
    assert bench_driver.ERROR_COUNT_KEYS["qos_storm"] == ERROR_KEYS
    assert set(FLAGS) | set(ERROR_KEYS) | set(MAY_READ_ZERO) \
        | set(MUST_BE_ABOVE_ZERO) <= QOS_KEYS
    assert set(ERROR_KEYS) | set(MAY_READ_ZERO) \
        <= bench_driver.ZERO_IS_A_READING
    assert not set(MUST_BE_ABOVE_ZERO) & bench_driver.ZERO_IS_A_READING


def test_stage_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(DeviceUnavailable):
        bench_driver.main(["--stage", "qos_storm"])


def _healthy() -> dict:
    """A record as a healthy run gives it: every reference key, flags
    true, error counts 0, measurements above 0."""
    out = {}
    for key in sorted(QOS_KEYS):
        if key in FLAGS + RECORDED or key == "qos_status_enabled":
            out[key] = True
        elif key in ERROR_KEYS:
            out[key] = 0
        else:
            out[key] = 1.5
    return out


def _main_on(monkeypatch, record: dict) -> int:
    monkeypatch.setattr(bench_driver, "stage_qos_storm",
                        lambda device: dict(record))
    return bench_driver.main(["--stage", "qos_storm", "--device", "cpu"])


def test_main_passes_a_healthy_record(monkeypatch, capsys):
    record = _healthy()
    assert _main_on(monkeypatch, record) == 0
    assert json.loads(capsys.readouterr().out) == record


@pytest.mark.parametrize("flag", FLAGS)
def test_main_fails_a_false_or_missing_flag(monkeypatch, capsys, flag):
    assert _main_on(monkeypatch, {**_healthy(), flag: False}) == 1
    assert flag in capsys.readouterr().err
    rec = _healthy()
    del rec[flag]
    assert _main_on(monkeypatch, rec) == 1


@pytest.mark.parametrize("grade", RECORDED)
def test_main_records_a_false_grade(monkeypatch, capsys, grade):
    record = {**_healthy(), grade: False}
    assert _main_on(monkeypatch, record) == 0
    assert json.loads(capsys.readouterr().out) == record


@pytest.mark.parametrize("key", ERROR_KEYS)
def test_main_fails_an_error_count(monkeypatch, capsys, key):
    assert _main_on(monkeypatch, {**_healthy(), key: 1}) == 1
    assert key in capsys.readouterr().err


@pytest.mark.parametrize("key", MUST_BE_ABOVE_ZERO)
def test_main_fails_a_leg_that_did_not_happen(monkeypatch, capsys, key):
    assert _main_on(monkeypatch, {**_healthy(), key: 0}) == 1
    assert key in capsys.readouterr().err


@pytest.mark.parametrize("key", MAY_READ_ZERO)
def test_main_passes_a_count_whose_zero_is_a_reading(monkeypatch, key):
    assert _main_on(monkeypatch, {**_healthy(), key: 0}) == 0


# -- the reference's op-queue cases on the port ------------------------------

def _cases() -> list[str]:
    src = open(os.path.join(TESTS, "test_op_queue.py")).read()
    return re.findall(r"^def (test_\w+)\(", src, re.M)


OP_QUEUE_CASES = _cases()


def test_every_op_queue_case_is_mirrored():
    assert len(OP_QUEUE_CASES) == 9


@pytest.mark.parametrize("case", OP_QUEUE_CASES)
def test_reference_op_queue_case_on_the_port(case, tmp_path):
    mod = load_reference_tests("test_op_queue", True, [], {},
                               edits=((_HARNESS, _PORT_HARNESS),))
    fn = getattr(mod, case)
    args = {"tmp_path": tmp_path}
    fn(*[args[p] for p in inspect.signature(fn).parameters])


# -- the whole stage: phase 19 on the CPU ------------------------------------

@pytest.mark.slow(reason="1000 clients over 3 worker processes: about 4 "
                         "minutes on an 8-core host, too long for the "
                         "tier-1 run")
def test_phase_19_on_the_cpu():
    """chip_smoke's phase 19 with --device cpu: the stage whole as a child
    process exits 0 (every flag True, every error count 0, no leg that
    did not happen), with its 1000 clients over 3 processes; the SLO
    grade is logged."""
    signal.setitimer(signal.ITIMER_REAL, chip_smoke.QOS_TIMEOUT_S + 60)
    r = chip_smoke.phase_qos("cpu")
    rec = r["record"]
    assert set(rec) == QOS_KEYS
    for flag in FLAGS:
        assert rec[flag] is True, flag
    for key in ERROR_KEYS:
        assert rec[key] == 0, key
    assert rec["qos_storm_clients"] == 1000
    assert rec["qos_storm_procs"] == 3
