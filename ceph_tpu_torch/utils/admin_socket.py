"""Admin socket: unix-domain JSON command endpoint per daemon.

Re-creation of the reference's AdminSocket (src/common/admin_socket.{h,cc}):
daemons expose a unix socket accepting newline-terminated JSON requests
`{"prefix": "<command>", ...args}` and answering with a JSON document.
Built-in commands: help, version, perf dump, perf schema, config show,
config diff, config set, config get, dump_recent (log ring). Components
register additional hooks with `register_command`.

The port's copy of ceph_tpu/utils/admin_socket.py (jax-free; the
port imports nothing of the JAX package).
"""
from __future__ import annotations

import json
import os
import socket
import threading
from typing import Callable

from ceph_tpu_torch.utils import tracer
from ceph_tpu_torch.utils.dout import get_logger
from ceph_tpu_torch.utils.perf_counters import PerfCountersCollection

VERSION = "ceph-tpu-torch 0.2"


class AdminSocket:
    def __init__(self, path: str, config=None):
        self.path = path
        self.config = config
        self._hooks: dict[str, tuple[Callable, str]] = {}
        self._lock = threading.Lock()
        self._server: socket.socket | None = None
        self._thread: threading.Thread | None = None
        self._running = False
        self._register_builtins()

    # -- hooks ---------------------------------------------------------------

    def register_command(self, prefix: str, hook: Callable[[dict], object],
                         help: str = "") -> None:
        with self._lock:
            if prefix in self._hooks:
                raise ValueError(f"command {prefix!r} already registered")
            self._hooks[prefix] = (hook, help)

    def _register_builtins(self) -> None:
        pc = PerfCountersCollection.instance()
        self.register_command("help", lambda req: {
            p: h for p, (_, h) in sorted(self._hooks.items())},
            "list available commands")
        self.register_command("version", lambda req: {"version": VERSION},
                              "framework version")
        self.register_command("perf dump",
                              lambda req: pc.dump(req.get("logger")),
                              "dump perf counter values")
        self.register_command("perf schema", lambda req: pc.schema(),
                              "dump perf counter schema")
        from ceph_tpu_torch.utils import flight

        def _perf_reset(req):
            out = pc.reset(req.get("logger"))
            # a perf reset means "start my observation over": the local
            # flight ring is part of that observation surface, and a
            # stale event tail would contradict the zeroed counters.
            # The mgr side notices the counters moving backwards and
            # drops this daemon's history buckets on its own.
            out["flight_cleared"] = flight.reset()["cleared"]
            return out
        self.register_command("perf reset", _perf_reset,
                              "zero all perf counters (or one "
                              "logger's) and clear the local "
                              "flight-recorder ring")
        self.register_command(
            "events dump",
            lambda req: flight.dump(req.get("type"), req.get("entity")),
            "flight-recorder ring (structured events, oldest first) "
            "with the mono/wall anchor pair; type=/entity= filter")
        self.register_command(
            "events reset",
            lambda req: flight.reset(),
            "clear the flight-recorder ring (snapshots survive)")
        self.register_command(
            "events snapshots",
            lambda req: flight.snapshots(),
            "auto-frozen flight rings (crash records, WARN+ health "
            "transitions)")
        self.register_command("dump_recent",
                              lambda req: get_logger().ring.entries(),
                              "recent log events")
        from ceph_tpu_torch.utils import crash
        self.register_command(
            "crash ls",
            lambda req: crash.ls(bool(req.get("all", False))),
            "crash records (all=true includes archived)")
        self.register_command(
            "crash archive",
            lambda req: {"archived": crash.archive(req.get("id"))},
            "acknowledge crash records (id=... for one, else all): "
            "they leave the RECENT_CRASH health surface")
        self.register_command("trace dump",
                              lambda req: tracer.dump(req.get("trace_id")),
                              "collected op trace spans grouped by trace")
        self.register_command("trace reset", lambda req: tracer.reset(),
                              "clear the span collector")
        from ceph_tpu_torch.utils import loopprof
        self.register_command(
            "profile dump",
            lambda req: loopprof.dump(req.get("top")),
            "loop profiler: busy fraction, executor depth, top stall "
            "sites (arm with config set profiler_enabled true)")
        self.register_command("profile reset",
                              lambda req: loopprof.reset(),
                              "zero the loop profiler's samples")
        from ceph_tpu_torch.utils import sanitizer
        self.register_command(
            "deadlock dump",
            lambda req: sanitizer.deadlock_dump(),
            "lockdep state: order graph size, retained inversions, "
            "live lock/grant waits + holders with task spawn sites, "
            "parked-task census, and a fresh wait-for-graph cycle scan "
            "(arm with config set sanitizer_lockdep true)")
        if self.config is not None:
            self.register_command("config show",
                                  lambda req: self.config.show(),
                                  "all effective option values")
            self.register_command("config diff",
                                  lambda req: self.config.diff(),
                                  "non-default options")
            self.register_command("config get", lambda req: {
                req["key"]: self.config.get(req["key"])},
                "get one option")

            def _set(req):
                self.config.set(req["key"], req["value"])
                return {"success": True}
            self.register_command("config set", _set, "set one option")

    # -- server --------------------------------------------------------------

    def start(self) -> None:
        if self._running:
            return
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass
        self._server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._server.bind(self.path)
        self._server.listen(8)
        self._running = True
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name=f"admin-socket:{self.path}")
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._server is not None:
            self._server.close()
            self._server = None
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _serve(self) -> None:
        while self._running:
            server = self._server
            if server is None:
                return
            try:
                conn, _ = server.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            with conn:
                data = b""
                while not data.endswith(b"\n"):
                    part = conn.recv(65536)
                    if not part:
                        break
                    data += part
                response = self.execute_line(data.decode(errors="replace"))
                conn.sendall(response.encode() + b"\n")
        except OSError:
            pass

    # -- dispatch ------------------------------------------------------------

    def execute(self, request: dict) -> dict:
        prefix = request.get("prefix", "")
        with self._lock:
            hook = self._hooks.get(prefix)
        if hook is None:
            return {"error": f"unknown command {prefix!r}; try 'help'"}
        try:
            return {"result": hook[0](request)}
        except Exception as e:  # surface hook errors as JSON, never crash
            return {"error": f"{type(e).__name__}: {e}"}

    def execute_line(self, line: str) -> str:
        line = line.strip()
        try:
            request = json.loads(line) if line.startswith("{") else {
                "prefix": line}
        except json.JSONDecodeError as e:
            return json.dumps({"error": f"bad JSON: {e}"})
        return json.dumps(self.execute(request))


def admin_command(path: str, request: dict | str, timeout: float = 5.0) -> dict:
    """Client helper: send one command to a daemon's admin socket."""
    if isinstance(request, str):
        request = {"prefix": request}
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(path)
        s.sendall(json.dumps(request).encode() + b"\n")
        data = b""
        while not data.endswith(b"\n"):
            part = s.recv(65536)
            if not part:
                break
            data += part
    return json.loads(data.decode())
