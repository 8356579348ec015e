"""The port's wire (ceph_tpu_torch/msg/, native/frame_native.py) against
the JAX package's, on the CPU:

- the port's native loader declares the frame codec's argument types,
  so `frame_native.available()` is True wherever g++ built the library
  and a pack passes 64-bit pointers whole;
- frames byte-equal across the packages under the native and the Python
  codec (fuzzed segments, scatter segments), each package decoding the
  other's, and every truncation and corruption refused the same way;
- the cases of tests/test_frames_native.py and tests/test_msg.py on the
  port (their imports renamed);
- a port Messenger and a reference Messenger exchanging MOSDOp /
  MOSDOpReply over loopback, both ways, with and without the cephx-lite
  key: the wire is compatible;
- the same fault-injection log (drop, dup, delay) from one seed in both
  packages over a live connection.

Every test runs under a hard timeout (SIGALRM), besides the asyncio
timeouts inside it.
"""
from __future__ import annotations

import asyncio
import random
import signal
import struct

import pytest

from ceph_tpu import native as ref_native
from ceph_tpu.msg import frames as ref_frames
from ceph_tpu.msg import messages as ref_messages
from ceph_tpu.msg import messenger as ref_messenger
from ceph_tpu.qa import faultinject as ref_faultinject
from ceph_tpu_torch import native
from ceph_tpu_torch.msg import frames, messages, messenger
from ceph_tpu_torch.native import frame_native
from ceph_tpu_torch.qa import faultinject

from tests.test_frames_native import _flat_segments, _rand_frame
from tests.test_torch_kv_objectstore import TESTS, load_reference_tests

HARD_TIMEOUT_S = 60
PKGS = {"ref": (ref_frames, ref_messages, ref_messenger, ref_faultinject),
        "port": (frames, messages, messenger, faultinject)}


@pytest.fixture(autouse=True)
def _guards():
    """A hard timeout that fires even in a loop that never yields; both
    packages' codec choice and injector restored; and the port's own
    leak gates (tests/conftest.py gates the reference's modules)."""
    def expire(signum, frame):
        raise TimeoutError(f"test ran past {HARD_TIMEOUT_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, HARD_TIMEOUT_S)
    was = (frames.native_active(), ref_frames.native_active())
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
        frames.set_native(was[0])
        ref_frames.set_native(was[1])
        for fi in (faultinject, ref_faultinject):
            fi.set_enabled(False)
            fi.get_injector().msg_drop = 0.0
            fi.get_injector().msg_dup = 0.0
            fi.get_injector().msg_delay = 0.0
            fi.reset(seed=0)
    from ceph_tpu_torch.utils import loopprof, sanitizer
    assert not loopprof.installed_loops(), "port loopprof left armed"
    strays = sanitizer.take_foreign_call_soon()
    assert not strays, f"port sanitizer saw foreign call_soon: {strays}"


def run(coro, timeout=30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _native_or_skip() -> None:
    """Both packages' native frame codec, or a skip where the test
    machine has no compiler (as tests/test_frames_native.py does)."""
    for mod in (native, ref_native):
        try:
            mod.load()
        except mod.NativeUnavailable as e:
            pytest.skip(f"native library unavailable: {e}")
    from ceph_tpu.native import frame_native as ref_frame_native
    assert frame_native.available() and ref_frame_native.available()


# -- the native loader ---------------------------------------------------------

def test_native_loader_declares_the_frame_codec():
    """The port's load() declares frame_pack / frame_verify_body as the
    reference's does; without it ctypes passes pointers as C ints. A
    frame over a buffer high in the address space packs whole."""
    _native_or_skip()
    lib, ref_lib = native.load(), ref_native.load()
    for fn in ("frame_pack", "frame_verify_body"):
        ours, theirs = getattr(lib, fn), getattr(ref_lib, fn)
        assert ours.restype == theirs.restype
        assert [t.__name__ for t in ours.argtypes] == \
            [t.__name__ for t in theirs.argtypes]
    assert frames.native_active()              # chosen at import
    big = bytearray(random.Random(1).randbytes(3 << 20))
    blob = frame_native.pack(frames.MAGIC, int(frames.Tag.MESSAGE),
                             [b"hdr", big, [b"a", memoryview(big)[:9]]])
    frames.set_native(False)
    assert frames.Frame(frames.Tag.MESSAGE,
                        [b"hdr", bytes(big), b"a" + bytes(big[:9])]
                        ).encode() == blob
    frames.set_native(True)
    got = frames.Frame.decode(bytes(blob))
    assert bytes(got.segments[1]) == bytes(big)


# -- frames across the packages ------------------------------------------------

def test_frames_byte_equal_across_packages():
    """300 fuzzed frames: one wire form from both packages and both
    codecs; each package decodes the other's."""
    _native_or_skip()
    rng = random.Random(0xEC02)
    for trial in range(300):
        f = _rand_frame(rng)
        wires = []
        for mod in (ref_frames, frames):
            g = mod.Frame(mod.Tag(int(f.tag)), f.segments)
            for use_native in (True, False):
                assert mod.set_native(use_native) == use_native
                wires.append(bytes(g.encode()))
                wires.append(b"".join(bytes(p) for p in g.encode_parts()))
        assert len(set(wires)) == 1, trial
        flat = _flat_segments(f.segments)
        for mod in (ref_frames, frames):
            for use_native in (True, False):
                mod.set_native(use_native)
                got = mod.Frame.decode(wires[0])
                assert int(got.tag) == int(f.tag)
                assert [bytes(s) for s in got.segments] == flat, trial


def _refusal(mod, blob: bytes):
    try:
        mod.Frame.decode(blob)
    except mod.FrameError as e:
        return str(e)
    return None


def test_truncations_and_corruptions_refused_alike():
    """Every cut and single-bit flip of one frame: FrameError with the
    same message in both packages, under either codec."""
    _native_or_skip()
    rng = random.Random(7)
    f = frames.Frame(frames.Tag.MESSAGE, [b"hdr", rng.randbytes(513), b"",
                                          rng.randbytes(70)])
    blob = bytes(f.encode())
    bad = [blob[:cut] for cut in range(len(blob))]
    for pos in range(len(blob)):
        flipped = bytearray(blob)
        flipped[pos] ^= 1 << (pos % 8)
        bad.append(bytes(flipped))
    bad.append(b"\x00\x00" + blob[2:])
    for use_native in (True, False):
        frames.set_native(use_native)
        ref_frames.set_native(use_native)
        for b in bad:
            ours = _refusal(frames, b)
            assert ours is not None
            assert ours == _refusal(ref_frames, b)


# -- the reference's frame and messenger cases on the port ---------------------

FRAME_CASES = ("test_native_python_fuzz_parity",
               "test_truncations_and_corruptions_agree",
               "test_python_fallback_passes_full_frame_suite",
               "test_set_native_disabled_under_env")
MSG_CASES = ("test_frame_roundtrip_and_crc", "test_request_reply_roundtrip",
             "test_many_messages_ordered",
             "test_lossless_reconnect_replays_without_loss_or_dup",
             "test_restarted_entity_supersedes_old_session",
             "test_concurrent_connect_shares_one_session",
             "test_lossy_reset_notifies_dispatcher",
             "test_reconnect_to_restarted_peer_gets_session_reset",
             "test_auth_mutual_handshake_and_rejection")


@pytest.mark.parametrize("case", FRAME_CASES)
def test_reference_frame_case_on_the_port(case):
    mod = load_reference_tests("test_frames_native", True, [], {})
    assert mod.frames is frames
    fn = getattr(mod, case)
    if "both_codecs" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        mod._native_or_skip()
        fn(None)
    else:
        fn()


@pytest.mark.parametrize("case", MSG_CASES)
def test_reference_msg_case_on_the_port(case):
    mod = load_reference_tests("test_msg", True, [], {})
    assert mod.Messenger is messenger.Messenger
    getattr(mod, case)()


def test_every_reference_case_is_mirrored():
    for name, cases in (("test_frames_native", FRAME_CASES),
                        ("test_msg", MSG_CASES)):
        src = open(f"{TESTS}/{name}.py").read()
        assert sorted(cases) == sorted(
            line[4:line.index("(")] for line in src.splitlines()
            if line.startswith("def test_"))


# -- one wire, two packages ----------------------------------------------------

def _osd_server(pkg):
    """A dispatcher answering each MOSDOp with an MOSDOpReply that
    carries back its tid, its data reversed and the data's crc."""
    _, msgs, ms, _ = PKGS[pkg]

    class OSD(ms.Dispatcher):
        async def ms_dispatch(self, conn, msg):
            if isinstance(msg, msgs.MOSDOp):
                data = bytes(msg.data)
                conn.send_message(msgs.MOSDOpReply(
                    {"tid": msg.payload["tid"], "rc": 0,
                     "out": [{"len": len(data)}]}, data[::-1]))
                return True
            return False
    return OSD()


def _client_sink(pkg, want: int):
    _, msgs, ms, _ = PKGS[pkg]

    class Sink(ms.Dispatcher):
        def __init__(self):
            self.replies: dict[int, tuple] = {}
            self.done = asyncio.Event()

        async def ms_dispatch(self, conn, msg):
            if isinstance(msg, msgs.MOSDOpReply):
                self.replies[msg.payload["tid"]] = (msg.payload,
                                                    bytes(msg.data))
                if len(self.replies) == want:
                    self.done.set()
                return True
            return False
    return Sink()


@pytest.mark.parametrize("auth", [None, b"cluster-key"],
                         ids=["plain", "cephx-lite"])
@pytest.mark.parametrize("server,client", [("port", "ref"), ("ref", "port")],
                         ids=["port-server", "ref-server"])
def test_messenger_wire_compatible_across_packages(server, client, auth):
    """MOSDOps of 0 B to 2 MiB (batchable, so several ride one envelope)
    from one package's Messenger to the other's, replies back; the port
    end uses the Python codec in the keyed case."""
    _native_or_skip()
    frames.set_native(auth is None)
    rng = random.Random(11)
    datas = [rng.randbytes(n) for n in (0, 1, 4096, 70000, 2 << 20)] * 4
    s_msgs, s_ms = PKGS[server][1:3]
    c_msgs, c_ms = PKGS[client][1:3]

    async def main():
        srv = s_ms.Messenger("osd.3", auth_key=auth)
        srv.add_dispatcher(_osd_server(server))
        addr = await srv.bind()
        cli = c_ms.Messenger("client.7", auth_key=auth)
        sink = _client_sink(client, len(datas))
        cli.add_dispatcher(sink)
        try:
            conn = await cli.connect(addr, c_ms.Policy.lossy_client())
            for tid, data in enumerate(datas):
                conn.send_message(c_msgs.MOSDOp(
                    {"tid": tid, "pg": "1.2", "oid": f"obj{tid}",
                     "ops": [{"op": "write", "off": 0, "len": len(data)}]},
                    data))
            await asyncio.wait_for(sink.done.wait(), 20)
            assert conn.peer_name == "osd.3"
        finally:
            await cli.shutdown()
            await srv.shutdown()
        return sink.replies
    replies = run(main())
    assert sorted(replies) == list(range(len(datas)))
    for tid, data in enumerate(datas):
        payload, back = replies[tid]
        assert payload == {"tid": tid, "rc": 0, "out": [{"len": len(data)}]}
        assert back == data[::-1]


def test_same_injection_log_from_one_seed_in_both_packages():
    """120 MPings over one connection with drop, dup and delay armed
    from seed 5: the same injection log in both packages, and the same
    deliveries (each message once, twice or never as the log says)."""
    def drive(pkg):
        _, msgs, ms, fi = PKGS[pkg]
        fi.reset(seed=5)
        inj = fi.get_injector()
        inj.msg_drop, inj.msg_dup, inj.msg_delay = 0.1, 0.1, 0.1
        inj.msg_delay_ms = 5.0
        fi.set_enabled(True)

        class Count(ms.Dispatcher):
            def __init__(self):
                self.got: list[int] = []

            async def ms_dispatch(self, conn, msg):
                self.got.append(msg.payload["i"])
                return True

        async def main():
            srv = ms.Messenger("osd.1")
            count = Count()
            srv.add_dispatcher(count)
            addr = await srv.bind()
            cli = ms.Messenger("osd.2")
            try:
                conn = await cli.connect(addr, ms.Policy.lossless_peer())
                for i in range(120):
                    conn.send_message(msgs.MPing({"i": i}))
                log = inj.log
                for _ in range(400):
                    dropped = sum(1 for e in log if e[2] == "drop")
                    dups = sum(1 for e in log if e[2] == "dup")
                    if len(count.got) == 120 - dropped + dups and \
                            len(log) and inj._counts.get("msg") == 120:
                        break
                    await asyncio.sleep(0.01)
                await asyncio.sleep(0.05)
            finally:
                await cli.shutdown()
                await srv.shutdown()
            return list(inj.log), sorted(count.got)
        try:
            return run(main())
        finally:
            fi.set_enabled(False)
    ref_log, ref_got = drive("ref")
    log, got = drive("port")
    assert log == ref_log
    assert got == ref_got
    actions = {e[2] for e in log}
    assert actions == {"drop", "dup", "delay"}
    dropped = {e[1] for e in log if e[2] == "drop"}
    assert len(got) == 120 - len(dropped) + sum(e[2] == "dup" for e in log)


def test_batch_envelope_equal_across_packages():
    """pack_batch of the same sub-ops gives the same frame in both
    packages, and each package's unpack_batch of the other's frame gives
    the same messages."""
    wires = []
    for frm, msgs in ((ref_frames, ref_messages), (frames, messages)):
        subs = []
        for seq in range(1, 6):
            m = msgs.MOSDECSubOpWrite(
                {"pgid": [2, 7], "tid": seq, "shard": seq % 3,
                 "chunk_off": seq << 12},
                random.Random(seq).randbytes(100 * seq))
            m.seq = seq
            subs.append(m)
        wires.append(bytes(frm.Frame(
            frm.Tag.MESSAGE, msgs.pack_batch(subs).encode_segments()).encode()))
    assert wires[0] == wires[1]
    assert struct.unpack_from("<H", wires[0])[0] == frames.MAGIC
    for (frm, msgs), wire in (((ref_frames, ref_messages), wires[1]),
                              ((frames, messages), wires[0])):
        env = msgs.Message.decode_segments(frm.Frame.decode(wire).segments)
        assert [(type(m).__name__, m.seq, m.payload["tid"], bytes(m.data))
                for m in msgs.unpack_batch(env)] == [
            ("MOSDECSubOpWrite", s, s, random.Random(s).randbytes(100 * s))
            for s in range(1, 6)]
