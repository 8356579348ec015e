"""The port's placement layer (ceph_tpu_torch/crush/) against the JAX
package's, on the CPU: the same mappings and the same map on the wire.

- `do_rule` over 10,002 inputs (firstn over hosts, indep over hosts,
  indep over OSDs), with every device in, with devices out and with
  devices reweighted, equal in both packages;
- every case of tests/test_crush.py through both packages (imports
  renamed to the port), recording each mapping the case asks of CRUSH
  and the OSDMap: the records must be equal;
- `OSDMap.dumps()` byte-equal, each package `load_dict`s the other's,
  and a chain of seeded `Incremental`s applies the same in both;
- `convert.port_osdmap` turns a reference map whose EC pool names
  plugin `tpu` into one the port loads with plugin `cuda`.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import pytest

import ceph_tpu.crush as ref_crush
import ceph_tpu_torch.crush as port_crush
from ceph_tpu.ec.registry import factory as ref_factory
from ceph_tpu_torch import convert
from ceph_tpu_torch.ec.registry import factory as port_factory

from tests.test_torch_kv_objectstore import TESTS, load_reference_tests

PKGS = {"ref": ref_crush, "port": port_crush}
LAYOUT = (3, 3, 2, 2, 1)            # 11 OSDs on 5 hosts
INPUTS = 3334                       # per rule: 10,002 in all


def _map(crush):
    """root -> 5 hosts (3+3+2+2+1 OSDs), and three rules: replicated
    firstn over hosts, EC indep over hosts, EC indep over OSDs."""
    cm = crush.CrushMap()
    root = cm.add_bucket(10, "default")
    osd = 0
    for h, count in enumerate(LAYOUT):
        host = cm.add_bucket(1, f"host{h}")
        cm.add_item(root, host, float(count))
        for _ in range(count):
            cm.add_item(host, osd, 1.0, name=f"osd.{osd}")
            osd += 1
    cm.make_simple_rule(0, "rep", "default", failure_domain_type=1)
    cm.make_simple_rule(1, "ec-host", "default", failure_domain_type=1,
                        mode="indep")
    cm.make_simple_rule(2, "ec-osd", "default", failure_domain_type=0,
                        mode="indep")
    return cm


WEIGHTS = (
    {o: 1.0 for o in range(11)},                                # all in
    {**{o: 1.0 for o in range(11)}, 2: 0.0, 10: 0.0},           # two out
    {**{o: 1.0 for o in range(11)}, 5: 0.5, 9: 0.25, 0: 0.75},  # reweighted
)


@pytest.mark.parametrize("mode,rule,n", [("firstn", 0, 3), ("indep", 1, 5),
                                         ("indep", 2, 6)],
                         ids=["firstn-host", "indep-host", "indep-osd"])
def test_do_rule_equal_over_inputs(mode, rule, n):
    """INPUTS inputs a rule, cycling through the three weight vectors;
    with osd.10 out host4 is empty, so indep over all 5 hosts holes."""
    maps = {k: _map(c) for k, c in PKGS.items()}
    assert maps["port"]._rules[rule].steps[-2].mode == mode
    xs = range(rule, 3 * INPUTS, 3)
    out = {k: [cm.do_rule(rule, x, n, WEIGHTS[x % 3]) for x in xs]
           for k, cm in maps.items()}
    assert out["port"] == out["ref"]
    holes = sum(ref_crush.CRUSH_NONE in r for r in out["ref"])
    assert (holes > 0) == (rule == 1)
    assert all(2 not in r and 10 not in r
               for x, r in zip(xs, out["ref"]) if x % 3 == 1)


def test_indep_over_devices_moves_a_survivor_as_the_reference_does():
    """Where the failure domain is the device, the reference's domain
    draw sees liveness (straw2 scales a device by its live weight,
    ceph_tpu/crush/crush.py:160-162, :288), so a surviving rank can
    move: 3 OSDs one a host, n=2, x=2, osd.1 out turns [1, 2] into
    [2, 0] (mapper.c keeps osd.2 at rank 1). The port keeps the
    reference's mapping."""
    out = {}
    for k, crush in PKGS.items():
        cm = crush.CrushMap()
        root = cm.add_bucket(10, "default")
        for o in range(3):
            host = cm.add_bucket(1, f"host{o}")
            cm.add_item(root, host, 1.0)
            cm.add_item(host, o, 1.0, name=f"osd.{o}")
        cm.make_simple_rule(0, "ec", "default", failure_domain_type=0,
                            mode="indep")
        out[k] = (cm.do_rule(0, 2, 2, {0: 1.0, 1: 1.0, 2: 1.0}),
                  cm.do_rule(0, 2, 2, {0: 1.0, 1: 0.0, 2: 1.0}))
    assert out["port"] == out["ref"] == ([1, 2], [2, 0])


# -- the reference's cases through both packages -------------------------------

RECORD = {"CrushMap": ("do_rule",),
          "OSDMap": ("object_to_pg", "pg_to_up_acting_osds", "primary",
                     "dumps")}
CASES = re.findall(r"^def (test_\w+)\(\)",
                   open(os.path.join(TESTS, "test_crush.py")).read(), re.M)


@pytest.mark.parametrize("case", CASES)
def test_reference_case_same_mappings(case):
    logs = {}
    for pkg in ("ref", "port"):
        logs[pkg] = []
        mod = load_reference_tests("test_crush", pkg == "port", logs[pkg],
                                   RECORD)
        getattr(mod, case)()
    assert logs["port"] == logs["ref"]
    assert logs["ref"] or case == "test_stable_mod_growth"


def test_every_reference_case_is_mirrored():
    assert len(CASES) == 13


# -- the OSDMap on the wire ----------------------------------------------------

def _osdmap(crush, plugin: str):
    om = crush.OSDMap(_map(crush))
    for o in range(11):
        om.add_osd(o, addr=f"127.0.0.1:{6800 + o}")
        om.set_up(o, True)
    om.ec_profiles["k8m3"] = {"plugin": plugin, "k": "8", "m": "3",
                              "technique": "reed_sol_van",
                              "crush-failure-domain": "osd"}
    om.create_pool("rbd", size=3, pg_num=16, crush_rule=0)
    om.create_pool("ec", type="erasure", size=11, min_size=9, pg_num=8,
                   crush_rule=2, ec_profile="k8m3", stripe_width=8 << 20)
    om.inc_epoch()
    om.pg_temp[crush.PG(1, 3)] = [4, 5, 6]
    return om


def _mappings(om, crush) -> list:
    """(pg, up, acting) of every PG of every pool."""
    return [(str(pg), om.pg_to_up_acting_osds(pg))
            for pid, pool in sorted(om.pools.items())
            for pg in (crush.PG(pid, ps) for ps in range(pool.pg_num))]


def test_osdmap_dumps_byte_equal_and_cross_load():
    ref, port = _osdmap(ref_crush, "jerasure"), _osdmap(port_crush, "jerasure")
    assert port.dumps() == ref.dumps()
    assert _mappings(port, port_crush) == _mappings(ref, ref_crush)
    into_port = port_crush.OSDMap()
    into_port.load_dict(json.loads(ref.dumps()))
    into_ref = ref_crush.OSDMap()
    into_ref.load_dict(json.loads(port.dumps()))
    assert into_port.dumps() == into_ref.dumps() == ref.dumps()
    assert _mappings(into_port, port_crush) == \
        _mappings(into_ref, ref_crush) == _mappings(ref, ref_crush)


def _incrementals(crush, epoch: int, rng) -> list:
    """A seeded chain: OSDs down, out, back in and up, reweighted; a pool
    added; pg_temp set and erased; an EC profile added."""
    incs = []
    for i in range(8):
        inc = crush.Incremental(epoch=epoch + 1 + i)
        victims = sorted({int(v) for v in rng.integers(0, 11, 2)})
        if i % 4 == 0:
            inc.new_down = victims
            inc.new_out = victims[:1]
        elif i % 4 == 1:
            inc.new_up = {v: f"127.0.0.1:{7000 + v}" for v in victims}
            inc.new_in = victims
        elif i % 4 == 2:
            inc.new_weights = {v: float(rng.integers(1, 5)) / 4
                               for v in victims}
            inc.new_pg_temp = {crush.PG(2, i): [int(v) for v in
                                                rng.permutation(11)]}
        else:
            inc.new_pools = {10 + i: crush.Pool(id=10 + i, name=f"p{i}",
                                                size=3, pg_num=8)}
            inc.new_pg_temp = {crush.PG(2, i - 1): []}
            inc.new_ec_profiles = {f"prof{i}": {"plugin": "isa",
                                                "k": "4", "m": "2"}}
        incs.append(inc)
    return incs


def test_incremental_chain_applies_the_same():
    ref, port = _osdmap(ref_crush, "jerasure"), _osdmap(port_crush, "jerasure")
    for r_inc, p_inc in zip(_incrementals(ref_crush, ref.epoch,
                                          np.random.default_rng(8)),
                            _incrementals(port_crush, port.epoch,
                                          np.random.default_rng(8))):
        assert json.dumps(p_inc.to_dict(), sort_keys=True) == \
            json.dumps(r_inc.to_dict(), sort_keys=True)
        ref.apply_incremental(r_inc)
        # the port applies the reference's incremental off the wire
        port.apply_incremental(port_crush.Incremental.from_dict(
            json.loads(json.dumps(r_inc.to_dict()))))
        assert port.dumps() == ref.dumps()
        assert _mappings(port, port_crush) == _mappings(ref, ref_crush)
    assert ref.epoch == port.epoch == 9
    with pytest.raises(ValueError):
        port.apply_incremental(p_inc)


def test_port_osdmap_maps_tpu_profiles_to_cuda():
    """A reference map with plugin `tpu` loads in the port as `cuda`:
    nothing else differs, and the port builds the pool's code from it
    with the reference's generator."""
    ref = _osdmap(ref_crush, "tpu")
    d = json.loads(ref.dumps())
    ported = convert.port_osdmap(d)
    assert d["ec_profiles"]["k8m3"]["plugin"] == "tpu"     # input untouched
    assert ported["ec_profiles"]["k8m3"]["plugin"] == "cuda"
    assert {k: v for k, v in ported.items() if k != "ec_profiles"} == \
        {k: v for k, v in d.items() if k != "ec_profiles"}
    om = port_crush.OSDMap()
    om.load_dict(ported)
    prof = om.ec_profiles[om.get_pool("ec").ec_profile]
    assert prof == {**d["ec_profiles"]["k8m3"], "plugin": "cuda"}
    code = port_factory(prof["plugin"], {**prof, "device": "cpu"})
    ref_code = ref_factory("tpu", d["ec_profiles"]["k8m3"])
    assert np.array_equal(np.asarray(convert.generator(code)),
                          np.asarray(convert.generator(ref_code)))
    assert _mappings(om, port_crush) == _mappings(ref, ref_crush)
