"""Wire messaging: msgr2-subset protocol over asyncio TCP.

The reference's messenger stack (src/msg/, src/msg/async/) gives every
daemon and client a common substrate: typed messages, framed transport
with per-segment crc32c, lossy vs lossless connection policies, session
reconnect/replay, and dispatcher callbacks. This package re-creates that
contract idiomatically on asyncio instead of translating the epoll state
machines: one event loop per daemon process, coroutine per connection.

  frames     TLV frame encode/decode + banner (ProtocolV2-subset: crc
             mode only — no secure mode / compression; frames_v2.h)
  messenger  Messenger/Connection/Dispatcher + reconnect and replay
             (AsyncMessenger + ProtocolV2 session logic)
  messages   typed Message registry (src/messages/ equivalents)

The port's copy of ceph_tpu/msg/__init__.py (jax-free; the port imports
nothing of the JAX package).
"""
from ceph_tpu_torch.msg.frames import Frame, Tag, FrameError
from ceph_tpu_torch.msg.messenger import (Messenger, Connection, Dispatcher,
                                         Policy)
from ceph_tpu_torch.msg.messages import Message, register_message

__all__ = ["Frame", "Tag", "FrameError", "Messenger", "Connection",
           "Dispatcher", "Policy", "Message", "register_message"]
