"""The PyTorch port stands alone: it imports neither jax nor any module of
the JAX package `ceph_tpu`, and its entry points refuse to run on a
machine without CUDA unless the caller asks for the CPU."""
import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import ceph_tpu_torch

PKG_DIR = os.path.dirname(ceph_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)


def _port_modules() -> list[str]:
    names = ["ceph_tpu_torch"]
    for info in pkgutil.walk_packages([PKG_DIR], prefix="ceph_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def _is_reference(name: str) -> bool:
    # "ceph_tpu_torch".startswith("ceph_tpu") is True: match exactly
    return name == "ceph_tpu" or name.startswith("ceph_tpu.")


#: the control plane, the OSD and librados: copies of the reference's
#: modules with their imports renamed
CLUSTER_COPIES = (
    "ceph_tpu_torch.mon", "ceph_tpu_torch.mon.store",
    "ceph_tpu_torch.mon.paxos", "ceph_tpu_torch.mon.monitor",
    "ceph_tpu_torch.mon.mon_client", "ceph_tpu_torch.mgr",
    "ceph_tpu_torch.mgr.mgr_client", "ceph_tpu_torch.osd.scheduler",
    "ceph_tpu_torch.osd.scheduler.profile",
    "ceph_tpu_torch.osd.scheduler.dmclock",
    "ceph_tpu_torch.utils.work_queue", "ceph_tpu_torch.osd.pglog",
    "ceph_tpu_torch.osd.snaps", "ceph_tpu_torch.osd.backend",
    "ceph_tpu_torch.cls", "ceph_tpu_torch.cls.registry",
    "ceph_tpu_torch.cls.lock", "ceph_tpu_torch.osd.pg",
    "ceph_tpu_torch.osd.ec_backend", "ceph_tpu_torch.osd.scrub",
    "ceph_tpu_torch.osd.daemon", "ceph_tpu_torch.rados",
    "ceph_tpu_torch.rados.client", "ceph_tpu_torch.rados.aio",
    # the process half of the reactor, the cluster tools and the mgr
    "ceph_tpu_torch.utils.reactor", "ceph_tpu_torch.utils.reactor_worker",
    "ceph_tpu_torch.tools.cluster_boot", "ceph_tpu_torch.tools.rados_bench",
    "ceph_tpu_torch.mgr.history", "ceph_tpu_torch.mgr.exporter",
    "ceph_tpu_torch.mgr.daemon",
    # the access layers, vstart and the operator tools
    "ceph_tpu_torch.rbd", "ceph_tpu_torch.rbd.image",
    "ceph_tpu_torch.rgw", "ceph_tpu_torch.rgw.gateway",
    "ceph_tpu_torch.mds", "ceph_tpu_torch.mds.daemon",
    "ceph_tpu_torch.mds.client", "ceph_tpu_torch.tools.vstart",
    "ceph_tpu_torch.tools.rados_cli", "ceph_tpu_torch.tools.rbd_cli",
    "ceph_tpu_torch.tools.cephfs_shell", "ceph_tpu_torch.tools.crushtool",
    "ceph_tpu_torch.tools.monmaptool", "ceph_tpu_torch.tools.osdmaptool",
    "ceph_tpu_torch.tools.objectstore_tool",
    "ceph_tpu_torch.tools.cephadm",
    # the client fleet and the model checker with its thrasher
    "ceph_tpu_torch.qa", "ceph_tpu_torch.qa.rados_model",
    "ceph_tpu_torch.tools.rados_swarm",
    # the linter: it holds no kernel and touches no device
    "ceph_tpu_torch.tools.lint_tool", "ceph_tpu_torch.tools.radoslint",
    "ceph_tpu_torch.tools.radoslint.__main__",
    "ceph_tpu_torch.tools.radoslint.checkers",
    "ceph_tpu_torch.tools.radoslint.cli",
    "ceph_tpu_torch.tools.radoslint.core",
    "ceph_tpu_torch.tools.radoslint.lifetimes",
    "ceph_tpu_torch.tools.radoslint.lockorder",
    "ceph_tpu_torch.tools.radoslint.project")

#: the device seams, where a copy may differ from the reference: module
#: -> (functions, imports the copy adds)
SEAMS = {
    # the failure reports: the mon drops a report about an older
    # incarnation of its target (the reporter's epoch before the
    # target's last boot, or its address then), as upstream's
    # OSDMonitor::preprocess_failure does; the reference counts it, and a
    # report landing after a quick re-boot marks the revived OSD down
    # again (ROADMAP §3), and logs every report and what became of it.
    # The reporter sends its epoch and the address its map gives the
    # target
    "ceph_tpu_torch.mon.monitor": (
        {"OSDMonitor.__init__", "OSDMonitor.apply_commit",
         "OSDMonitor.handle_failure"}, set()),
    "ceph_tpu_torch.mon.mon_client": ({"MonClient.report_failure"}, set()),
    # the device, the heartbeat forgetting a peer that left every acting
    # set (the reference keeps its stamp: ROADMAP §3) or re-booted at a
    # new address, and its failure reports naming the incarnation they
    # are about (logged at level 1)
    "ceph_tpu_torch.osd.daemon": (
        {"OSD.__init__", "OSD.start", "OSD._heartbeat"},
        {"from ceph_tpu_torch import device as _device"}),
    "ceph_tpu_torch.osd.ec_backend": ({"ECBackend.__init__"}, set()),
    # the spawn line names the port's worker; a boot carries its device
    "ceph_tpu_torch.utils.reactor": (
        {"ProcShardPool._spawn", "ProcShardPool.boot_osd"}, set()),
    # the OSD's device, and the verbs that read the worker's device side
    # and scrub its OSDs
    "ceph_tpu_torch.utils.reactor_worker": (
        {"_Worker.__init__", "_Worker._boot_osd", "_Worker._service",
         "_Worker._offload_status", "_Worker._device_status",
         "_Worker._scrub", "_Worker._pinned_bytes"}, set()),
    # the OSDs' device, the parent's kernel build, DeviceUnavailable
    "ceph_tpu_torch.tools.cluster_boot": (
        {"ephemeral_cluster", "boot_worker_osd"},
        {"from ceph_tpu_torch.device import DeviceUnavailable"}),
    "ceph_tpu_torch.tools.rados_bench": ({"_main", "main"}, set()),
    # the OSDs' device (in-process and in workers), the smoke's EC
    # profile and its --device
    "ceph_tpu_torch.tools.vstart": (
        {"VCluster.__init__", "VCluster.start_osd", "smoke", "main"},
        set()),
    # the OSD spec's device
    "ceph_tpu_torch.tools.cephadm": ({"CephadmCluster.daemon_start"},
                                     set()),
    # the lazy export of the model checker, restored: a copy but for the
    # package's name, no seam
    "ceph_tpu_torch.qa": (set(), set()),
    # the worker module the fleet spawns (a string, out of reach of the
    # import rename); the standalone cluster's OSDs and its plugin-cuda
    # pool on --device
    "ceph_tpu_torch.tools.rados_swarm": ({"run_swarm", "_main", "main"},
                                         set()),
    # the linter's default paths, strings the import rename cannot reach:
    # the port's lints the port's tree
    "ceph_tpu_torch.tools.lint_tool": ({"main"}, set()),
    "ceph_tpu_torch.tools.radoslint.cli": ({"build_parser"}, set()),
    # the cache's name at the lint root: the two linters' rule hashes
    # differ, and one name would make each run throw the other's away
    "ceph_tpu_torch.tools.radoslint.core": ({"CACHE_NAME ="}, set()),
}


def _source_path(name: str, pkg: str) -> str:
    rel = name.split(".", 1)[1].replace(".", os.sep) if "." in name else ""
    base = os.path.join(REPO, pkg, rel)
    return os.path.join(base, "__init__.py") if os.path.isdir(base) \
        else base + ".py"


def _shape(path: str, rename: bool) -> tuple[dict, set]:
    """A module's definitions as {qualified name: AST dump} (docstrings
    dropped) and its import statements, with `ceph_tpu` renamed to the
    port's package when `rename`."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef)) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        if rename and isinstance(node, ast.ImportFrom) and node.module \
                and _is_reference(node.module):
            node.module = "ceph_tpu_torch" + node.module[len("ceph_tpu"):]
        if rename and isinstance(node, ast.alias) and _is_reference(
                node.name):
            node.name = "ceph_tpu_torch" + node.name[len("ceph_tpu"):]
    defs, imports = {}, set()

    def visit(stmts, prefix):
        for i, st in enumerate(stmts):
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs[prefix + st.name] = ast.dump(st)
            elif isinstance(st, ast.ClassDef):
                visit(st.body, prefix + st.name + ".")
                st.body = []
                defs[prefix + st.name] = ast.dump(st)
            elif isinstance(st, (ast.Import, ast.ImportFrom)) and not prefix:
                imports.add(ast.unparse(st))
            elif (isinstance(st, ast.Assign) and len(st.targets) == 1
                  and isinstance(st.targets[0], ast.Name)
                  and f"{prefix}{st.targets[0].id} =" not in defs):
                # an assignment to one name is keyed by it, so that a
                # seam can name it
                defs[f"{prefix}{st.targets[0].id} ="] = ast.dump(st)
            else:
                defs[f"{prefix}<stmt {i}>"] = ast.dump(st)
    visit(tree.body, "")
    return defs, imports


@pytest.mark.parametrize("name", CLUSTER_COPIES)
def test_copy_is_the_reference_but_for_names_and_seams(name):
    """Each copied module is AST-equal to the reference's once the
    package is renamed and docstrings are dropped, except in the device
    seams listed in SEAMS."""
    port_defs, port_imports = _shape(_source_path(name, "ceph_tpu_torch"),
                                     rename=False)
    ref_defs, ref_imports = _shape(_source_path(name, "ceph_tpu"),
                                   rename=True)
    seam_fns, seam_imports = SEAMS.get(name, (set(), set()))
    assert port_imports - ref_imports == seam_imports
    assert ref_imports <= port_imports
    differ = {k for k in port_defs.keys() | ref_defs.keys()
              if port_defs.get(k) != ref_defs.get(k)}
    assert differ == seam_fns


#: the bench driver's stages copied whole from the reference's: function
#: -> its device seams, each (reference, port) in `ast.unparse` form,
#: applied once each to the reference function once renamed
STAGE_SEAMS = {
    "stage_failure_storm": (
        ("def stage_failure_storm() -> dict:",
         "def stage_failure_storm(device: str | None=None) -> dict:"),
        # the stage's device, checked to exist, its context opened
        ("    KS, MS, DS = (8, 3, 10)",
         "    device, _platform = _cluster_device(device)\n"
         "    KS, MS, DS = (8, 3, 10)"),
        # phase A-B: the OSDs (booted and revived) and clay's MDS code
        ("store_factory=store_factory)",
         "store_factory=store_factory, device=device)"),
        ("'scalar_mds': 'jerasure'}",
         "'scalar_mds': 'jerasure', 'device': device}"),
        ("OSD(i, mon_addrs, store=stores[i])",
         "OSD(i, mon_addrs, store=stores[i], device=device)"),
        ("OSD(0, mon_addrs, store=stores[0])",
         "OSD(0, mon_addrs, store=stores[0], device=device)"),
        # phase C: the workers' OSDs, the drill's profile in the port's
        # plugin names on the stage's device
        ("        from ceph_tpu_torch.mgr.daemon import MgrDaemon\n"
         "        from ceph_tpu_torch.tools.cluster_boot import "
         "ephemeral_cluster\n"
         "        from ceph_tpu_torch.utils import flight",
         "        from ceph_tpu_torch import convert\n"
         "        from ceph_tpu_torch.mgr.daemon import MgrDaemon\n"
         "        from ceph_tpu_torch.tools.cluster_boot import "
         "ephemeral_cluster\n"
         "        from ceph_tpu_torch.utils import flight"),
        ("reactor_procs=2)", "reactor_procs=2, device=device)"),
        ("'profile': {'plugin': 'tpu', 'k': '2', 'm': '1'}",
         "'profile': {**convert.port_profile({'plugin': 'tpu', 'k': '2', "
         "'m': '1'}), 'device': device}"),
        # phase D: the deadlock drill's OSDs
        ("ephemeral_cluster(2, prefix='bench-dl-')",
         "ephemeral_cluster(2, prefix='bench-dl-', device=device)")),
    "stage_interleave": (
        ("def stage_interleave() -> dict:",
         "def stage_interleave(device: str | None=None) -> dict:"),
        ("    t0 = time.perf_counter()\n    SEEDS",
         "    t0 = time.perf_counter()\n"
         "    device, platform = _cluster_device(device)\n    SEEDS"),
        ("ephemeral_cluster(KI + MI, prefix='bench-ilv-')",
         "ephemeral_cluster(KI + MI, prefix='bench-ilv-', device=device)"),
        # the device plugin: a jerasure pool's batched stripes run on the
        # host codec, in both packages, and would never reach the card
        ("'profile': {'plugin': 'jerasure', 'k': str(KI), 'm': str(MI)}",
         "'profile': {'plugin': 'cuda', 'k': str(KI), 'm': str(MI), "
         "'device': device}"),
        # the record's platform is the stage's device's
        ("'platform': 'cpu'", "'platform': platform")),
    "stage_swarm": (
        ("def stage_swarm() -> dict:",
         "def stage_swarm(device: str | None=None) -> dict:"),
        # the stage's device, checked to exist, its context opened
        ("    t0 = time.perf_counter()\n    results: dict = {}",
         "    t0 = time.perf_counter()\n"
         "    device, _platform = _cluster_device(device)\n"
         "    results: dict = {}"),
        ("VCluster(base, n_mons=1, n_osds=N_OSDS, with_mgr=True)",
         "VCluster(base, n_mons=1, n_osds=N_OSDS, with_mgr=True, "
         "device=device)"),
        # the device plugin, as the interleave sweep's
        ("'profile': {'plugin': 'jerasure', 'k': '2', 'm': '1'}",
         "'profile': {'plugin': 'cuda', 'k': '2', 'm': '1', "
         "'device': device}"),
        # the clients wait 60 s an attempt and an op, as the reference's
        # scrub and QoS storms' fleets do: a write queued past the 5 s
        # attempt is resent and answered EIO (ROADMAP §3)
        ("slow_readers=16, connect_batch=40)",
         "slow_readers=16, connect_batch=40, op_timeout=60.0)")),
    "stage_scrub_storm": (
        ("def stage_scrub_storm() -> dict:",
         "def stage_scrub_storm(device: str | None=None) -> dict:"),
        ("    t0 = time.perf_counter()\n    results: dict = {}",
         "    t0 = time.perf_counter()\n"
         "    device, _platform = _cluster_device(device)\n"
         "    results: dict = {}"),
        ("        import tempfile\n"
         "        from ceph_tpu_torch.offload import service as offload",
         "        import tempfile\n"
         "        from ceph_tpu_torch import convert\n"
         "        from ceph_tpu_torch.offload import service as offload"),
        ("VCluster(base, n_mons=1, n_osds=N_OSDS, with_mgr=True)",
         "VCluster(base, n_mons=1, n_osds=N_OSDS, with_mgr=True, "
         "device=device)"),
        # clay's MDS code in the port's plugin names on the stage's device
        ("'profile': {'plugin': 'clay', 'k': str(K8), 'm': str(M3), "
         "'d': str(D10), 'scalar_mds': 'tpu'}",
         "'profile': {**convert.port_profile({'plugin': 'clay', "
         "'k': str(K8), 'm': str(M3), 'd': str(D10), "
         "'scalar_mds': 'tpu'}), 'device': device}")),
    "stage_qos_storm": (
        ("def stage_qos_storm() -> dict:",
         "def stage_qos_storm(device: str | None=None) -> dict:"),
        ("    t0 = time.perf_counter()\n    results: dict = {}",
         "    t0 = time.perf_counter()\n"
         "    device, _platform = _cluster_device(device)\n"
         "    results: dict = {}"),
        ("VCluster(base, n_mons=1, n_osds=N_OSDS, with_mgr=True)",
         "VCluster(base, n_mons=1, n_osds=N_OSDS, with_mgr=True, "
         "device=device)"),
        # the device plugin, as the swarm's; k=2 m=2 kept (size 4,
        # min_size 3: phase B's degraded writes go on with one OSD down)
        ("'profile': {'plugin': 'jerasure', 'k': '2', 'm': '2'}",
         "'profile': {'plugin': 'cuda', 'k': '2', 'm': '2', "
         "'device': device}")),
}


def _function_source(path: str, name: str, rename: bool) -> str:
    """Top-level function `name` of `path` as `ast.unparse` gives it,
    docstrings dropped, `ceph_tpu` imports renamed to the port's when
    `rename`."""
    tree = ast.parse(open(path).read())
    fn = next(st for st in tree.body if isinstance(st, ast.FunctionDef)
              and st.name == name)
    for node in ast.walk(fn):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        if rename and isinstance(node, ast.ImportFrom) and node.module \
                and _is_reference(node.module):
            node.module = "ceph_tpu_torch" + node.module[len("ceph_tpu"):]
    return ast.unparse(fn)


@pytest.mark.parametrize("name", sorted(STAGE_SEAMS))
def test_stage_is_the_reference_but_for_names_and_seams(name):
    """The failure storm, the interleave sweep, the swarm and the scrub
    storm are the reference's functions with `ceph_tpu` renamed and
    docstrings dropped, but for the device seams of STAGE_SEAMS, each
    found once."""
    ref = _function_source(_source_path("ceph_tpu_torch.tools.bench_driver",
                                        "ceph_tpu"), name, rename=True)
    for old, new in STAGE_SEAMS[name]:
        assert ref.count(old) == 1, old
        ref = ref.replace(old, new)
    port = _function_source(_source_path(
        "ceph_tpu_torch.tools.bench_driver", "ceph_tpu_torch"), name,
        rename=False)
    assert port == ref


def test_mgr_exports_what_the_reference_exports():
    """The port's mgr exports the same names as the reference's, each
    defined in the port."""
    from ceph_tpu import mgr as ref_mgr
    from ceph_tpu_torch import mgr
    assert mgr.__all__ == ref_mgr.__all__
    for name in mgr.__all__:
        assert getattr(mgr, name).__module__.startswith("ceph_tpu_torch.")


def test_worker_spawn_line_names_the_port():
    """The worker module is a string constant, out of reach of an import
    rename: the port's pool spawns the port's worker."""
    src = open(_source_path("ceph_tpu_torch.utils.reactor",
                            "ceph_tpu_torch")).read()
    assert '"ceph_tpu_torch.utils.reactor_worker"' in src
    assert '"ceph_tpu.utils.reactor_worker"' not in src


def test_swarm_spawn_line_names_the_port():
    """The fleet's worker module is a string constant too: the port's
    run_swarm spawns the port's rados_swarm, never the reference's."""
    src = open(_source_path("ceph_tpu_torch.tools.rados_swarm",
                            "ceph_tpu_torch")).read()
    assert '"-m", "ceph_tpu_torch.tools.rados_swarm"' in src
    assert '"ceph_tpu.tools.rados_swarm"' not in src


def test_linter_defaults_name_the_port(monkeypatch):
    """The linter's default paths are string constants too: the port's
    CLI and lint_tool lint the port's tree, never the reference's, and
    keep a cache of a name of their own."""
    import argparse

    from ceph_tpu_torch.tools import lint_tool
    from ceph_tpu_torch.tools.radoslint import cli, core
    assert cli.build_parser().parse_args([]).paths == ["ceph_tpu_torch"]
    parse = argparse.ArgumentParser.parse_args
    seen = []

    def record(self, args=None, namespace=None):
        seen.append(parse(self, args, namespace).paths)
        raise SystemExit(0)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", record)
    for argv in (["check"], ["baseline", "write"], ["baseline", "prune"]):
        with pytest.raises(SystemExit):
            lint_tool.main(argv)
    assert seen == [["ceph_tpu_torch"]] * 3
    assert core.CACHE_NAME == ".radoslint_torch_cache.json"


def test_every_module_is_listed():
    mods = _port_modules()
    for expected in ("ceph_tpu_torch.device", "ceph_tpu_torch.convert",
                     "ceph_tpu_torch.ops.rs_codec", "ceph_tpu_torch.ops.crc32c",
                     "ceph_tpu_torch.ops._build", "ceph_tpu_torch.ec.plugin_cuda",
                     "ceph_tpu_torch.ec.plugin_jerasure",
                     "ceph_tpu_torch.ec.bitmatrix",
                     "ceph_tpu_torch.ec.plugin_isa",
                     "ceph_tpu_torch.ec.plugin_shec",
                     "ceph_tpu_torch.ec.plugin_lrc",
                     "ceph_tpu_torch.ec.plugin_clay",
                     "ceph_tpu_torch.tools.ec_non_regression",
                     "ceph_tpu_torch.tools.ec_tool",
                     "ceph_tpu_torch.tools.gen_bitmatrix_tables",
                     "ceph_tpu_torch.osd.ec_util",
                     "ceph_tpu_torch.utils.checksummer",
                     "ceph_tpu_torch.native.ec_native",
                     "ceph_tpu_torch.tools.ec_benchmark",
                     "ceph_tpu_torch.offload",
                     "ceph_tpu_torch.offload.service",
                     "ceph_tpu_torch.parallel.mesh",
                     "ceph_tpu_torch.utils.dout",
                     "ceph_tpu_torch.utils.perf_counters",
                     "ceph_tpu_torch.utils.throttle",
                     "ceph_tpu_torch.utils.config",
                     "ceph_tpu_torch.utils.tracer",
                     "ceph_tpu_torch.utils.critpath",
                     "ceph_tpu_torch.utils.flight",
                     "ceph_tpu_torch.utils.copytrack",
                     "ceph_tpu_torch.tools.bench_driver",
                     "ceph_tpu_torch.utils.loophook",
                     "ceph_tpu_torch.utils.crash",
                     "ceph_tpu_torch.utils.sanitizer",
                     "ceph_tpu_torch.qa",
                     "ceph_tpu_torch.qa.faultinject",
                     "ceph_tpu_torch.qa.interleave",
                     "ceph_tpu_torch.utils.async_util",
                     "ceph_tpu_torch.utils.loopprof",
                     "ceph_tpu_torch.utils.admin_socket",
                     "ceph_tpu_torch.utils.reactor",
                     "ceph_tpu_torch.utils.buffer",
                     "ceph_tpu_torch.kv", "ceph_tpu_torch.kv.keyvaluedb",
                     "ceph_tpu_torch.kv.lsm",
                     "ceph_tpu_torch.objectstore",
                     "ceph_tpu_torch.objectstore.types",
                     "ceph_tpu_torch.objectstore.store",
                     "ceph_tpu_torch.objectstore.memstore",
                     "ceph_tpu_torch.objectstore.filestore",
                     "ceph_tpu_torch.objectstore.bluestore",
                     "ceph_tpu_torch.crush", "ceph_tpu_torch.crush.crush",
                     "ceph_tpu_torch.crush.osdmap",
                     "ceph_tpu_torch.native.frame_native",
                     "ceph_tpu_torch.msg", "ceph_tpu_torch.msg.frames",
                     "ceph_tpu_torch.msg.messages",
                     "ceph_tpu_torch.msg.messenger",
                     *CLUSTER_COPIES):
        assert expected in mods


def test_imports_without_jax_or_reference():
    """Every port module imports with jax blocked, and afterwards no
    module named ceph_tpu or ceph_tpu.* is loaded."""
    # a package's __main__ runs its command when imported: its imports
    # are held by the source scan below
    modules = [m for m in _port_modules() if not m.endswith(".__main__")]
    script = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(n for n in sys.modules if n == 'ceph_tpu' or "
        "n.startswith('ceph_tpu.') or n == 'jax' and sys.modules[n] is not None)\n"
        "print('LOADED', bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "LOADED []" in res.stdout


@pytest.mark.parametrize("path", sorted(
    os.path.relpath(os.path.join(d, f), REPO)
    for d, _, files in os.walk(PKG_DIR) for f in files if f.endswith(".py")))
def test_source_has_no_jax_or_reference_import(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert not (name == "jax" or name.startswith("jax.")
                        or name == "jaxlib" or _is_reference(name)), \
                f"{path}:{node.lineno} imports {name}"


def _new_service():
    import asyncio

    from ceph_tpu_torch import offload

    async def make():
        return offload.get_service()
    return asyncio.run(make())


def _osd_start():
    import asyncio

    from ceph_tpu_torch.osd.daemon import OSD
    return asyncio.run(OSD(0, [("127.0.0.1", 1)]).start())


def _cluster():
    import asyncio

    from ceph_tpu_torch.tools.cluster_boot import ephemeral_cluster

    async def boot():
        async with ephemeral_cluster(1, prefix="iso-"):
            pass
    return asyncio.run(asyncio.wait_for(boot(), 30))


def _vcluster():
    import asyncio
    import tempfile

    from ceph_tpu_torch.tools.vstart import VCluster

    async def boot():
        with tempfile.TemporaryDirectory(prefix="iso-vstart-") as base:
            c = VCluster(base, n_osds=1)
            try:
                await c.start()
            finally:
                await c.stop()
    return asyncio.run(asyncio.wait_for(boot(), 30))


def _cephadm():
    import asyncio
    import tempfile

    from ceph_tpu_torch.tools.cephadm import CephadmCluster

    async def boot():
        with tempfile.TemporaryDirectory(prefix="iso-cephadm-") as base:
            c = CephadmCluster(base)
            try:
                await c.apply({"mon": {"count": 1},
                               "osd": {"count": 1, "backend": "memstore"}})
            finally:
                await c.stop()
    return asyncio.run(asyncio.wait_for(boot(), 30))


def _entry_points():
    from ceph_tpu_torch import device
    from ceph_tpu_torch.parallel import mesh
    from ceph_tpu_torch.ec import gf256
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.ops import crc32c, rs_codec
    from ceph_tpu_torch.tools import (bench_driver, ec_benchmark,
                                      ec_non_regression, ec_tool)
    from ceph_tpu_torch.utils.checksummer import Checksummer
    M = gf256.reed_sol_van_matrix(4, 2)
    data = np.zeros((4, 128), dtype=np.uint8)
    return {
        "resolve": lambda: device.resolve(),
        "MatrixCodec.apply": lambda: rs_codec.MatrixCodec.get(M).apply(data),
        "Crc32cDevice": lambda: crc32c.Crc32cDevice(4096),
        "plugin cuda": lambda: factory("cuda", {"k": "4", "m": "2"}),
        "plugin jerasure": lambda: factory("jerasure", {"k": "4", "m": "2"}),
        "plugin jerasure liberation": lambda: factory(
            "jerasure", {"k": "4", "m": "2", "technique": "liberation"}),
        "plugin isa": lambda: factory("isa", {"k": "8", "m": "3"}),
        "plugin shec": lambda: factory("shec", {"k": "6", "m": "4",
                                                "c": "3"}),
        "plugin lrc": lambda: factory("lrc", {"k": "4", "m": "2", "l": "3"}),
        "plugin clay": lambda: factory("clay", {"k": "8", "m": "4",
                                                "d": "11"}),
        "ec_non_regression": lambda: ec_non_regression.check_all(
            os.path.join(REPO, "ceph-erasure-code-corpus")),
        "ec_tool": lambda: ec_tool.main(["calc-chunk-size",
                                         "shec,k=6,m=4,c=3", "4096"]),
        "Checksummer device": lambda: Checksummer(
            "crc32c", 4096, use_device=True).calculate(bytes(4096)),
        "ec_benchmark": lambda: ec_benchmark.run_bench(ec_benchmark.BenchConfig(
            plugin="cuda", mode="batched", size=4096, batch=1)),
        "bench_driver device": lambda: bench_driver.stage_device(),
        "bench_driver probe": lambda: bench_driver.stage_probe(),
        "offload service": _new_service,
        "OSD.start": _osd_start,
        "ephemeral_cluster": _cluster,
        "bench_driver cluster_tpu": lambda: bench_driver.stage_cluster_tpu(),
        "bench_driver attribution": lambda: bench_driver.stage_attribution(),
        "bench_driver cluster": lambda: bench_driver.stage_cluster(),
        "bench_driver failure_storm": lambda:
            bench_driver.stage_failure_storm(),
        "bench_driver interleave": lambda: bench_driver.stage_interleave(),
        "bench_driver swarm": lambda: bench_driver.stage_swarm(),
        "bench_driver scrub_storm": lambda: bench_driver.stage_scrub_storm(),
        "bench_driver qos_storm": lambda: bench_driver.stage_qos_storm(),
        "VCluster.start": _vcluster,
        "cephadm apply": _cephadm,
        "make_mesh": lambda: mesh.make_mesh(),
        "mesh_storage_impl": lambda: mesh.mesh_storage_impl(
            mesh.make_mesh(), 4, 2),
    }


@pytest.mark.parametrize("entry", sorted(_entry_points()))
def test_entry_point_without_cuda_raises(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from ceph_tpu_torch.device import DeviceUnavailable
    with pytest.raises(DeviceUnavailable):
        _entry_points()[entry]()


def test_cpu_is_taken_only_when_asked():
    from ceph_tpu_torch import device
    assert device.resolve("cpu").type == "cpu"
    with pytest.raises(device.DeviceUnavailable):
        device.resolve("mps")
