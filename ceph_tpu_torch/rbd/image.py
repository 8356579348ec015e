"""Block images striped over RADOS objects: snapshots, clones,
exclusive lock, header watch.

Re-creation of the reference librbd essentials (src/librbd/):

  * data layout: a small header object plus data objects named
    <prefix>.<index> each holding 2^order bytes; image I/O maps byte
    extents onto object extents (io/ObjectDispatch striping, format 2);
    sparse semantics — absent data objects read as zeros, discard
    deletes whole covered objects and zeroes partial edges;
  * image snapshots ride RADOS self-managed snapshots on the data
    objects (librbd::Operations::snap_create -> selfmanaged snap +
    per-image SnapContext on every write; reads at a snap resolve the
    covering clones); rollback re-materializes per-object snap state;
  * layering: a clone's header names its parent image@snap and the
    overlap; reads fall through to the parent for absent child objects,
    writes COPY-UP the parent object first (io/CopyupRequest), and
    flatten materializes everything then drops the parent link
    (librbd::Operations::flatten);
  * exclusive lock ownership serializes through the `lock` object
    class on the header (cls_lock, exactly what the reference does);
  * every open image watches its header and re-reads it on notify, so
    resize/snap/flatten from another client invalidate cached state
    (librbd's header watcher).

Idiomatic divergences: the header is a JSON blob in the header object's
DATA (works on replicated and EC pools alike — EC pools reject omap,
which the reference header uses); snapshots/locks require replicated
pools (RADOS snaps and cls-lock omap are gated off EC); no journaling
or mirroring; child images are not tracked on the parent, so removing
a snapped parent under a clone is the operator's footgun (the
reference refuses via the children list).
"""
from __future__ import annotations

import asyncio
import json
import secrets

from ceph_tpu_torch.rados.client import IoCtx, ObjectNotFound, RadosError

DEFAULT_ORDER = 22          # 4 MiB objects, the reference default
LOCK_NAME = "rbd_lock"      # the reference's RBD_LOCK_NAME


class ImageNotFound(Exception):
    pass


def _header_oid(name: str) -> str:
    return f"rbd_header.{name}"


class RBD:
    """Pool-level image admin (librbd.RBD)."""

    @staticmethod
    async def create(ioctx: IoCtx, name: str, size: int,
                     order: int = DEFAULT_ORDER,
                     parent: dict | None = None,
                     data_pool: str | None = None) -> None:
        """`data_pool` puts the DATA objects in a different (typically
        erasure-coded) pool while the header stays in this replicated
        pool — the reference's `rbd create --data-pool` EC layout
        (librbd image-meta data_pool_id)."""
        if not 12 <= order <= 26:
            raise ValueError(f"order {order} out of range 12..26")
        hdr = {"name": name, "size": int(size), "order": order,
               "object_prefix": f"rbd_data.{name}",
               "snap_seq": 0, "snaps": {}, "parent": parent,
               "data_pool": data_pool}
        oid = _header_oid(name)
        try:
            # one message, two ops: exclusive create + header write run
            # back to back on the primary, so a lost client cannot leave
            # an empty header bricking the name
            await ioctx.client.submit(
                ioctx.pool_name, oid,
                [{"op": "create", "oid": oid, "exclusive": True},
                 {"op": "write_full", "oid": oid}],
                json.dumps(hdr).encode())
        except RadosError as e:
            if e.rc == -17:
                raise RadosError(-17, f"image {name!r} exists") from None
            raise

    @staticmethod
    async def clone(ioctx: IoCtx, parent_name: str, snap_name: str,
                    child_name: str,
                    data_pool: str | None = None) -> None:
        """Layered clone of parent@snap (librbd::clone): the child
        starts empty; reads fall through to the parent's snapshot. The
        child inherits the parent's data pool unless one is given."""
        parent = await Image.open(ioctx, parent_name)
        try:
            snap = parent.header["snaps"].get(snap_name)
            if snap is None:
                raise RadosError(-2, f"no snap {snap_name!r} on "
                                     f"{parent_name!r}")
            await RBD.create(
                ioctx, child_name, snap["size"], order=parent.order,
                parent={"image": parent_name, "snap_name": snap_name,
                        "snap_id": snap["id"], "overlap": snap["size"]},
                data_pool=data_pool
                or parent.header.get("data_pool"))
        finally:
            await parent.close()

    @staticmethod
    async def list(ioctx: IoCtx) -> list[str]:
        out = []
        for oid in await ioctx.list_objects():
            if oid.startswith("rbd_header."):
                out.append(oid[len("rbd_header."):])
        return sorted(out)

    @staticmethod
    async def remove(ioctx: IoCtx, name: str) -> None:
        img = await Image.open(ioctx, name)
        try:
            # purge image snapshots so their RADOS clones get trimmed
            for snap_name in list(img.header.get("snaps", {})):
                await img.snap_remove(snap_name)
            n_objs = -(-img.size // img.object_size) if img.size else 0
            for i in range(n_objs):
                try:
                    await img.data_ioctx.remove(img._data_oid(i))
                except ObjectNotFound:
                    pass
            await img.ioctx.remove(_header_oid(name))
        finally:
            await img.close()


class Image:
    """One open image handle (librbd::Image). `snap_name` opens a
    read-only view at that snapshot."""

    def __init__(self, ioctx: IoCtx, header: dict,
                 snap_name: str | None = None):
        # PRIVATE IoCtxs: the image owns its write SnapContext
        # (librbd's per-ImageCtx snapc) without clobbering the caller's.
        # Data objects may live in a separate (EC) pool; the snapc
        # applies to DATA only — header rewrites never clone
        self.ioctx = IoCtx(ioctx.client, ioctx.pool_name)
        self.data_ioctx = IoCtx(ioctx.client,
                                header.get("data_pool")
                                or ioctx.pool_name)
        self.header = header
        # pre-snapshot headers lack these fields
        header.setdefault("snaps", {})
        header.setdefault("snap_seq", 0)
        header.setdefault("parent", None)
        self.name = header["name"]
        self.order = int(header["order"])
        self.object_prefix = header["object_prefix"]
        self.snap_name = snap_name
        if snap_name is not None:
            snap = header["snaps"].get(snap_name)
            if snap is None:
                raise RadosError(-2, f"no snap {snap_name!r}")
            self.snap_id = snap["id"]
            self.size = int(snap["size"])
            # older snap records predate parent pinning: fall back to
            # the live header's link
            self._view_parent = snap.get("parent",
                                         header.get("parent"))
        else:
            self.snap_id = None
            self.size = int(header["size"])
            self._view_parent = None
        self._apply_snapc()
        # serialize header rewrites (resize/snap ops) per open handle
        self._hdr_lock = asyncio.Lock()
        self._watch_cookie: int | None = None
        self._lock_cookie: str | None = None
        self._parent: Image | None = None
        # object indices known present (the reference's object map):
        # spares layered writes a stat round-trip per extent
        self._present: set[int] = set()

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    async def open(cls, ioctx: IoCtx, name: str,
                   snap_name: str | None = None,
                   watch: bool = False) -> "Image":
        try:
            raw = await ioctx.read(_header_oid(name))
        except ObjectNotFound:
            raise ImageNotFound(name) from None
        if not raw:
            # torn create (header object without content): treat as
            # absent so the name can be re-created or removed
            raise ImageNotFound(name)
        img = cls(ioctx, json.loads(raw), snap_name=snap_name)
        if watch:
            img._watch_cookie = await img.ioctx.watch(
                _header_oid(name), img._on_header_notify)
        return img

    async def close(self) -> None:
        if self._lock_cookie is not None:
            try:
                await self.lock_release()
            except Exception:
                pass
        if self._watch_cookie is not None:
            try:
                await self.ioctx.unwatch(self._watch_cookie)
            except Exception:
                pass
            self._watch_cookie = None
        if self._parent is not None:
            await self._parent.close()
            self._parent = None

    # -- header cache / invalidation -----------------------------------------

    def _apply_snapc(self) -> None:
        """Install the image's write SnapContext (every data write
        clones-on-write against the newest image snap)."""
        ids = sorted((s["id"] for s in self.header.get("snaps", {})
                      .values()), reverse=True)
        self.data_ioctx.set_snap_context(
            self.header.get("snap_seq", 0) if ids else 0, ids)

    async def refresh(self) -> None:
        """Re-read the header (librbd ImageCtx::refresh)."""
        raw = await self.ioctx.read(_header_oid(self.name))
        self.header = json.loads(raw)
        if self.snap_id is None:
            self.size = int(self.header["size"])
        self._apply_snapc()
        if self._parent is not None and not self.header.get("parent"):
            await self._parent.close()      # flattened under us
            self._parent = None

    def _on_header_notify(self, notify_id, data):
        # watch callback: schedule a refresh; the ack needs no payload
        return asyncio.get_running_loop().create_task(self.refresh())

    async def _notify_header(self) -> None:
        try:
            await self.ioctx.notify(_header_oid(self.name), b"refresh",
                                    timeout=2.0)
        except Exception:
            pass                    # best-effort invalidation

    async def _write_header(self) -> None:
        await self.ioctx.write_full(_header_oid(self.name),
                                    json.dumps(self.header).encode())

    # -- layout --------------------------------------------------------------

    @property
    def object_size(self) -> int:
        return 1 << self.order

    def _data_oid(self, index: int) -> str:
        return f"{self.object_prefix}.{index:016x}"

    def _extents(self, offset: int, length: int):
        """(object index, in-object offset, length) covering the range."""
        S = self.object_size
        while length > 0:
            idx = offset // S
            ooff = offset % S
            n = min(length, S - ooff)
            yield idx, ooff, n
            offset += n
            length -= n

    # -- parent (layering) ---------------------------------------------------

    def _parent_ref(self) -> dict | None:
        """The parent link THIS handle reads through: the pinned
        per-snapshot link for snap views, the live header's otherwise."""
        if self.snap_id is not None:
            return self._view_parent
        return self.header.get("parent")

    async def _get_parent(self) -> "Image | None":
        p = self._parent_ref()
        if p is None:
            return None
        if self._parent is None:
            self._parent = await Image.open(self.ioctx, p["image"],
                                            snap_name=p["snap_name"])
        return self._parent

    async def _read_parent(self, idx: int, ooff: int, n: int) -> bytes:
        """Bytes from the parent snapshot for the child's absent object
        (clipped to the overlap); zeros beyond."""
        p = self._parent_ref()
        if p is None:
            return b"\0" * n
        off = idx * self.object_size + ooff
        overlap = int(p.get("overlap", 0))
        if off >= overlap:
            return b"\0" * n
        n_in = min(n, overlap - off)
        parent = await self._get_parent()
        data = await parent.read(off, n_in)
        return data + b"\0" * (n - len(data))

    async def _copyup(self, idx: int) -> None:
        """Materialize the parent's object content in the child before
        the first write to it (io/CopyupRequest)."""
        p = self.header.get("parent")
        if p is None:
            return
        base = await self._read_parent(idx, 0, self.object_size)
        base = base.rstrip(b"\0")
        if base:
            await self.data_ioctx.write(self._data_oid(idx), base, offset=0)
        else:
            # parent reads as zeros here: an empty child object still
            # must exist to stop future parent fall-through after the
            # partial write below extends it
            await self.data_ioctx.create(self._data_oid(idx),
                                    exclusive=False)

    # -- I/O -----------------------------------------------------------------

    async def read(self, offset: int, length: int) -> bytes:
        """Sparse read: absent objects fall through to the parent (when
        layered) then to zeros; the range clamps to the image size."""
        if offset >= self.size:
            return b""
        length = min(length, self.size - offset)
        parts = []
        for idx, ooff, n in self._extents(offset, length):
            try:
                if self.snap_id is not None:
                    data = await self.data_ioctx.read(
                        self._data_oid(idx), offset=ooff, length=n,
                        snapid=self.snap_id)
                else:
                    data = await self.data_ioctx.read(
                        self._data_oid(idx), offset=ooff, length=n)
                parts.append(data + b"\0" * (n - len(data)))
            except ObjectNotFound:
                # falls through to the snap-pinned parent for views,
                # the live parent for head reads
                parts.append(await self._read_parent(idx, ooff, n))
        return b"".join(parts)

    def _require_writable(self) -> None:
        if self.snap_id is not None:
            raise RadosError(-30, "image opened at a snapshot "
                                  "(read-only)")                # EROFS

    async def _object_absent(self, idx: int) -> bool:
        if idx in self._present:
            return False
        try:
            await self.data_ioctx.stat(self._data_oid(idx))
            self._present.add(idx)
            return False
        except ObjectNotFound:
            return True

    async def write(self, offset: int, data: bytes) -> int:
        self._require_writable()
        if offset + len(data) > self.size:
            raise RadosError(-27, f"write past image end "
                                  f"({offset}+{len(data)} > {self.size})")
        layered = self.header.get("parent") is not None
        for idx, ooff, n in self._extents(offset, len(data)):
            if layered and not (ooff == 0 and n == self.object_size) \
                    and await self._object_absent(idx):
                await self._copyup(idx)
            rel = (idx * self.object_size + ooff) - offset
            await self.data_ioctx.write(self._data_oid(idx),
                                   data[rel:rel + n], offset=ooff)
            self._present.add(idx)
        return len(data)

    async def _zero_stored(self, idx: int, ooff: int, n: int) -> None:
        """Zero [ooff, ooff+n) of a data object WITHOUT allocating: an
        absent object already reads as zeros, and stored bytes past its
        end do too, so only the overlap with the stored extent is
        rewritten."""
        try:
            stored = (await self.data_ioctx.stat(self._data_oid(idx)))["size"]
        except ObjectNotFound:
            return
        n = min(n, stored - ooff)
        if n > 0:
            await self.data_ioctx.write(self._data_oid(idx), b"\0" * n,
                                   offset=ooff)

    def _parent_covers(self, idx: int) -> bool:
        p = self.header.get("parent")
        return p is not None and \
            idx * self.object_size < int(p.get("overlap", 0))

    async def discard(self, offset: int, length: int) -> None:
        """Deallocate: whole covered objects are removed (sparse again),
        partial edges are zero-filled. Under a parent overlap, removal
        would expose the parent again, so those objects are zeroed."""
        self._require_writable()
        for idx, ooff, n in self._extents(offset, length):
            if ooff == 0 and n == self.object_size \
                    and not self._parent_covers(idx):
                try:
                    await self.data_ioctx.remove(self._data_oid(idx))
                except ObjectNotFound:
                    pass
                self._present.discard(idx)
            elif self._parent_covers(idx):
                # a full-object zero needs no copy-up (everything the
                # parent would show through is overwritten anyway)
                if not (ooff == 0 and n == self.object_size) \
                        and await self._object_absent(idx):
                    await self._copyup(idx)
                await self.data_ioctx.write(self._data_oid(idx), b"\0" * n,
                                       offset=ooff)
                self._present.add(idx)
            else:
                await self._zero_stored(idx, ooff, n)

    async def resize(self, new_size: int) -> None:
        self._require_writable()
        async with self._hdr_lock:
            old_size = self.size
            if new_size < old_size:
                S = self.object_size
                first_dead = -(-new_size // S)
                n_objs = -(-old_size // S)
                for i in range(first_dead, n_objs):
                    try:
                        await self.data_ioctx.remove(self._data_oid(i))
                    except ObjectNotFound:
                        pass
                    self._present.discard(i)
                # zero the shrunk tail inside the boundary object so a
                # later resize-up reads zeros there, not stale bytes
                if new_size % S:
                    await self._zero_stored(new_size // S, new_size % S,
                                            S - new_size % S)
                p = self.header.get("parent")
                if p is not None:
                    p["overlap"] = min(int(p.get("overlap", 0)),
                                       int(new_size))
            self.size = int(new_size)
            self.header["size"] = self.size
            await self._write_header()
        await self._notify_header()

    # -- snapshots (librbd::Operations::snap_*) ------------------------------

    async def snap_create(self, snap_name: str) -> int:
        self._require_writable()
        async with self._hdr_lock:
            if snap_name in self.header["snaps"]:
                raise RadosError(-17, f"snap {snap_name!r} exists")
            snapid = await self.data_ioctx.selfmanaged_snap_create()
            # pin the parent linkage AS OF the snapshot: flatten (or a
            # shrinking resize clamping the overlap) must not turn this
            # snap's parent-backed reads into zeros later
            parent = self.header.get("parent")
            self.header["snaps"][snap_name] = {
                "id": snapid, "size": self.size,
                "parent": dict(parent) if parent else None}
            self.header["snap_seq"] = snapid
            await self._write_header()
            self._apply_snapc()
        await self._notify_header()
        return snapid

    async def snap_remove(self, snap_name: str) -> None:
        async with self._hdr_lock:
            snap = self.header["snaps"].pop(snap_name, None)
            if snap is None:
                raise RadosError(-2, f"no snap {snap_name!r}")
            await self._write_header()
            self._apply_snapc()
            # the OSDs trim the per-object clones in the background
            await self.data_ioctx.selfmanaged_snap_rm(snap["id"])
        await self._notify_header()

    def snap_list(self) -> dict[str, dict]:
        return dict(self.header.get("snaps", {}))

    async def snap_rollback(self, snap_name: str) -> None:
        """Restore head data to the snapshot's state."""
        self._require_writable()
        snap = self.header["snaps"].get(snap_name)
        if snap is None:
            raise RadosError(-2, f"no snap {snap_name!r}")
        S = self.object_size
        n_objs = -(-max(self.size, snap["size"]) // S)
        for idx in range(n_objs):
            oid = self._data_oid(idx)
            try:
                await self.data_ioctx.rollback(oid, snap["id"])
            except RadosError as e:
                if e.rc != -2:
                    raise
                # object did not exist at the snap: drop the head copy
                try:
                    await self.data_ioctx.remove(oid)
                except ObjectNotFound:
                    pass
                self._present.discard(idx)
        async with self._hdr_lock:
            self.size = int(snap["size"])
            self.header["size"] = self.size
            await self._write_header()
        await self._notify_header()

    # -- flatten (drop the parent link) --------------------------------------

    async def flatten(self) -> None:
        self._require_writable()
        p = self.header.get("parent")
        if p is None:
            return
        S = self.object_size
        overlap = int(p.get("overlap", 0))
        for idx in range(-(-overlap // S)):
            if await self._object_absent(idx):
                base = await self._read_parent(idx, 0, S)
                base = base.rstrip(b"\0")
                if base:
                    await self.data_ioctx.write(self._data_oid(idx), base,
                                           offset=0)
        async with self._hdr_lock:
            self.header["parent"] = None
            await self._write_header()
        if self._parent is not None:
            await self._parent.close()
            self._parent = None
        await self._notify_header()

    # -- exclusive lock (cls_lock on the header) -----------------------------

    async def lock_acquire(self) -> str:
        """Take the image's exclusive lock (librbd::ExclusiveLock via
        cls_lock on the header object). Raises EBUSY when held."""
        cookie = secrets.token_hex(8)
        await self.ioctx.call(
            _header_oid(self.name), "lock", "lock",
            json.dumps({"name": LOCK_NAME, "cookie": cookie,
                        "locker": f"client.{self.ioctx.client._nonce}"}
                       ).encode())
        self._lock_cookie = cookie
        return cookie

    async def lock_release(self) -> None:
        if self._lock_cookie is None:
            return
        await self.ioctx.call(
            _header_oid(self.name), "lock", "unlock",
            json.dumps({"name": LOCK_NAME,
                        "cookie": self._lock_cookie}).encode())
        self._lock_cookie = None

    async def lock_info(self) -> dict:
        out = await self.ioctx.call(
            _header_oid(self.name), "lock", "get_info",
            json.dumps({"name": LOCK_NAME}).encode())
        return json.loads(out) if out else {}

    async def break_lock(self) -> None:
        await self.ioctx.call(
            _header_oid(self.name), "lock", "break_lock",
            json.dumps({"name": LOCK_NAME}).encode())

    async def stat(self) -> dict:
        return {"size": self.size, "order": self.order,
                "object_size": self.object_size,
                "num_objs": -(-self.size // self.object_size),
                "snap_count": len(self.header.get("snaps", {})),
                "parent": self.header.get("parent")}
