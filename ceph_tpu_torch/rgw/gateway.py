"""S3-subset HTTP gateway.

Re-creation of the reference RGW request path shape
(src/rgw/rgw_asio_frontend.cc HTTP frontend -> rgw_process.cc:265
process_request -> RGWOp handlers -> RADOS store driver):

  * buckets:   PUT /bucket        create   (bucket index object with an
                                           omap entry per object, like
                                           cls_rgw's bucket index)
               GET /bucket        list objects (XML ListBucketResult)
               DELETE /bucket     remove (must be empty)
               GET /              list buckets
  * objects:   PUT /bucket/key    write (body = payload)
               GET /bucket/key    read (+ ETag = crc32c hex)
               HEAD /bucket/key   stat
               DELETE /bucket/key remove

Layout in RADOS: an index pool (+ optionally a separate, typically
erasure-coded, DATA pool for object/part blobs); bucket index object
`.bucket.<name>` whose omap maps object key -> JSON {size, etag};
object data in `<bucket>/<key>`. Multi-op semantics match S3's
read-after-write for new objects.

Multipart uploads (src/rgw/rgw_op.cc RGWInitMultipart/
RGWPutObj part path/RGWCompleteMultipart): POST /b/k?uploads initiates
and returns an UploadId; PUT /b/k?partNumber=N&uploadId=U stores parts
as `.mp.<id>.<n>` objects; POST /b/k?uploadId=U concatenates the parts
in part-number order into the final object and deletes them; DELETE
with uploadId aborts and reclaims parts.

Idiomatic divergences: no auth sigv4 (cephx-lite guards the RADOS
plane; HTTP is trusted-localhost like a behind-proxy deployment), XML
only where S3 clients require it.
"""
from __future__ import annotations

import asyncio
import json
import secrets
import time
from urllib.parse import parse_qs, unquote, urlsplit
from xml.sax.saxutils import escape

from ceph_tpu_torch.mgr.mgr_client import MgrClient
from ceph_tpu_torch.rados.client import IoCtx, ObjectNotFound
from ceph_tpu_torch.utils.dout import dout
from ceph_tpu_torch.utils.perf_counters import TYPE_AVG, PerfCountersCollection


def _index_oid(bucket: str) -> str:
    return f".bucket.{bucket}"


def _data_oid(bucket: str, key: str) -> str:
    return f"{bucket}/{key}"


class RGWGateway:
    """HTTP/1.0 S3-subset frontend bound to one RADOS pool; object
    DATA may live in a separate (typically erasure-coded) pool while
    bucket indexes stay in the replicated index pool — the reference's
    placement-target data_pool split (rgw zone placement pools)."""

    def __init__(self, ioctx: IoCtx, host: str = "127.0.0.1",
                 port: int = 0, data_ioctx: IoCtx | None = None,
                 name: str = "rgw.0"):
        self.io = ioctx
        self.data_io = data_ioctx if data_ioctx is not None else ioctx
        self.host, self.port = host, port
        self.name = name
        self._server: asyncio.Server | None = None
        self.addr: tuple[str, int] | None = None
        # per-daemon perf counters (src/rgw/rgw_perf_counters.cc: req,
        # op breakdown, byte counters), shipped to the mgr over the
        # backing RADOS client's messenger
        coll = PerfCountersCollection.instance()
        coll.remove(name)               # a restarted gateway re-registers
        self.perf = coll.create(name)
        self.perf.add("req", description="http requests processed")
        self.perf.add("op_get", description="object GET/HEAD ops")
        self.perf.add("op_put", description="object PUT ops")
        self.perf.add("op_del", description="object/bucket DELETE ops")
        self.perf.add("bytes_received",
                      description="request body bytes received")
        self.perf.add("bytes_sent", description="response bytes sent")
        self.perf.add("req_latency", type=TYPE_AVG,
                      description="request latency (seconds)")
        self.mgr_client = MgrClient(
            ioctx.client.messenger, name, "rgw",
            resolve=lambda: (ioctx.client.monc.mgrmap
                             or {}).get("active_addr"),
            status_cb=lambda: {
                "index_pool": self.io.pool_name,
                "data_pool": self.data_io.pool_name,
                "addr": list(self.addr) if self.addr else None})

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.addr = self._server.sockets[0].getsockname()[:2]
        self.io.client.monc.subscribe("mgrmap", 1)
        self.mgr_client.start()
        dout("rgw", 1, f"rgw-lite on {self.addr}")
        return self.addr

    async def stop(self) -> None:
        await self.mgr_client.stop()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # -- request plumbing ----------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request = await asyncio.wait_for(reader.readline(), 30.0)
            parts = request.decode(errors="replace").split()
            if len(parts) < 2:
                return
            url = urlsplit(parts[1])
            method, path = parts[0].upper(), unquote(url.path)
            query = {k: v[0] for k, v in parse_qs(
                url.query, keep_blank_values=True).items()}
            headers_in: dict[str, str] = {}
            while True:
                line = await asyncio.wait_for(reader.readline(), 30.0)
                if line in (b"\r\n", b"\n", b""):
                    break
                name, _, value = line.decode(errors="replace").partition(":")
                headers_in[name.strip().lower()] = value.strip()
            try:
                length = int(headers_in.get("content-length", 0))
            except ValueError:
                length = -1
            if length < 0:
                code, headers, out = 400, {}, b"InvalidArgument"
                body = b""
            else:
                body = await reader.readexactly(length) if length else b""
                code, headers, out = await self._process_metered(
                    method, path, body, query, headers_in)
        except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                OSError):
            writer.close()
            return
        except Exception as e:
            dout("rgw", 1, f"request failed: {type(e).__name__} {e}")
            code, headers, out = 500, {}, b"InternalError"
        try:
            hdr = "".join(f"{k}: {v}\r\n" for k, v in headers.items())
            if "Content-Length" not in headers:
                hdr += f"Content-Length: {len(out)}\r\n"
            writer.write(
                f"HTTP/1.0 {code} {_REASON.get(code, '')}\r\n{hdr}"
                f"\r\n".encode() + out)
            await writer.drain()
        except OSError:
            pass
        finally:
            writer.close()

    async def _process_metered(self, method: str, path: str, body: bytes,
                               query: dict | None = None,
                               headers_in: dict | None = None
                               ) -> tuple[int, dict, bytes]:
        """_process with per-request perf accounting (request/op/byte
        counters + latency), so the gateway shows up in the aggregated
        cluster metrics like every other daemon."""
        t0 = time.monotonic()
        self.perf.inc("req")
        if body:
            self.perf.inc("bytes_received", len(body))
        try:
            code, headers, out = await self._process(
                method, path, body, query, headers_in)
        finally:
            self.perf.avg_add("req_latency", time.monotonic() - t0)
        if method in ("GET", "HEAD"):
            self.perf.inc("op_get")
        elif method == "PUT":
            self.perf.inc("op_put")
        elif method == "DELETE":
            self.perf.inc("op_del")
        if out:
            self.perf.inc("bytes_sent", len(out))
        return code, headers, out

    # -- S3 semantics --------------------------------------------------------

    async def _process(self, method: str, path: str, body: bytes,
                       query: dict | None = None,
                       headers_in: dict | None = None
                       ) -> tuple[int, dict, bytes]:
        query = query or {}
        headers_in = headers_in or {}
        parts = [p for p in path.split("/") if p]
        if not parts:
            if method == "GET":
                return await self._list_buckets()
            return 405, {}, b"MethodNotAllowed"
        bucket, key = parts[0], "/".join(parts[1:])
        if not key:
            if method == "PUT":
                return await self._create_bucket(bucket)
            if method == "GET":
                return await self._list_objects(bucket, query)
            if method == "DELETE":
                return await self._delete_bucket(bucket)
            return 405, {}, b"MethodNotAllowed"
        if method == "POST" and "uploads" in query:
            return await self._initiate_multipart(bucket, key)
        if method == "POST" and "uploadId" in query:
            return await self._complete_multipart(bucket, key,
                                                  query["uploadId"])
        if method == "PUT" and "uploadId" in query:
            return await self._put_part(bucket, key, query, body)
        if method == "DELETE" and "uploadId" in query:
            return await self._abort_multipart(bucket, key,
                                               query["uploadId"])
        if method == "PUT":
            return await self._put_object(bucket, key, body)
        if method == "GET":
            return await self._get_object(bucket, key,
                                          headers_in.get("range"))
        if method == "HEAD":
            return await self._head_object(bucket, key)
        if method == "DELETE":
            return await self._delete_object(bucket, key)
        return 405, {}, b"MethodNotAllowed"

    async def _bucket_exists(self, bucket: str) -> bool:
        try:
            await self.io.stat(_index_oid(bucket))
            return True
        except ObjectNotFound:
            return False

    async def _list_buckets(self) -> tuple[int, dict, bytes]:
        names = sorted(o[len(".bucket."):]
                       for o in await self.io.list_objects()
                       if o.startswith(".bucket."))
        inner = "".join(f"<Bucket><Name>{escape(n)}</Name></Bucket>"
                        for n in names)
        xml = (f"<ListAllMyBucketsResult><Buckets>{inner}</Buckets>"
               f"</ListAllMyBucketsResult>")
        return 200, {"Content-Type": "application/xml"}, xml.encode()

    async def _create_bucket(self, bucket: str) -> tuple[int, dict, bytes]:
        if not await self._bucket_exists(bucket):
            # a re-PUT of an existing bucket must NOT touch the index:
            # write_full here would wipe its omap (S3 bucket PUT is
            # idempotent)
            await self.io.write_full(_index_oid(bucket), b"")
        return 200, {}, b""

    async def _delete_bucket(self, bucket: str) -> tuple[int, dict, bytes]:
        if not await self._bucket_exists(bucket):
            return 404, {}, b"NoSuchBucket"
        if await self.io.omap_get(_index_oid(bucket)):
            return 409, {}, b"BucketNotEmpty"
        await self.io.remove(_index_oid(bucket))
        return 204, {}, b""

    async def _list_objects(self, bucket: str,
                            query: dict | None = None
                            ) -> tuple[int, dict, bytes]:
        """ListObjects with the prefix/delimiter folding S3 clients use
        for directory-style browsing (RGWListBucket)."""
        if not await self._bucket_exists(bucket):
            return 404, {}, b"NoSuchBucket"
        query = query or {}
        prefix = query.get("prefix", "")
        delim = query.get("delimiter", "")
        index = await self.io.omap_get(_index_oid(bucket))
        items = []
        common: set[str] = set()
        for k in sorted(index):
            if not k.startswith(prefix):
                continue
            if delim:
                rest = k[len(prefix):]
                if delim in rest:
                    common.add(prefix + rest.split(delim, 1)[0] + delim)
                    continue
            meta = json.loads(index[k])
            items.append(f"<Contents><Key>{escape(k)}</Key>"
                         f"<Size>{meta['size']}</Size>"
                         f"<ETag>&quot;{meta['etag']}&quot;</ETag>"
                         f"</Contents>")
        prefixes = "".join(
            f"<CommonPrefixes><Prefix>{escape(p_)}</Prefix>"
            f"</CommonPrefixes>" for p_ in sorted(common))
        xml = (f"<ListBucketResult><Name>{escape(bucket)}</Name>"
               f"<Prefix>{escape(prefix)}</Prefix>"
               f"{''.join(items)}{prefixes}</ListBucketResult>")
        return 200, {"Content-Type": "application/xml"}, xml.encode()

    async def _put_object(self, bucket: str, key: str,
                          body: bytes) -> tuple[int, dict, bytes]:
        if not await self._bucket_exists(bucket):
            return 404, {}, b"NoSuchBucket"
        from ceph_tpu_torch.native import ec_native
        etag = f"{ec_native.crc32c(body):08x}"
        await self.data_io.write_full(_data_oid(bucket, key), body)
        # bucket index update AFTER the data lands (the reference's
        # cls_rgw index transaction orders prepare/complete likewise)
        await self.io.omap_set(_index_oid(bucket), {
            key: json.dumps({"size": len(body), "etag": etag}).encode()})
        return 200, {"ETag": f'"{etag}"'}, b""

    async def _get_object(self, bucket: str, key: str,
                          range_hdr: str | None = None
                          ) -> tuple[int, dict, bytes]:
        """GET, honoring `Range: bytes=a-b` with a 206 + Content-Range
        (S3 ranged GET; drives the OSD's ranged read path)."""
        oid = _data_oid(bucket, key)
        rng = None
        if range_hdr and range_hdr.startswith("bytes="):
            spec = range_hdr[len("bytes="):]
            start_s, _, end_s = spec.partition("-")
            if start_s.isdigit():
                rng = (int(start_s),
                       int(end_s) if end_s.isdigit() else None)
            elif end_s.isdigit():
                rng = (None, int(end_s))      # suffix: last N bytes
        try:
            if rng is not None:
                st = await self.data_io.stat(oid)
                total = st["size"]
                start, end = rng
                if start is None:
                    # bytes=-N (footer probes): the last N bytes
                    if end == 0:
                        return 416, {"Content-Range": f"bytes */{total}"
                                     }, b"InvalidRange"
                    start, end = max(0, total - end), total - 1
                else:
                    end = total - 1 if end is None else min(end, total - 1)
                if start >= total or start > end:
                    return 416, {"Content-Range": f"bytes */{total}"
                                 }, b"InvalidRange"
                data = await self.data_io.read(oid, offset=start,
                                          length=end - start + 1)
                return 206, {
                    "Content-Range": f"bytes {start}-{end}/{total}",
                    "Content-Type": "application/octet-stream"}, data
            data = await self.data_io.read(oid)
        except ObjectNotFound:
            return 404, {}, b"NoSuchKey"
        from ceph_tpu_torch.native import ec_native
        return 200, {"ETag": f'"{ec_native.crc32c(data):08x}"',
                     "Content-Type": "application/octet-stream"}, data

    async def _head_object(self, bucket: str,
                           key: str) -> tuple[int, dict, bytes]:
        try:
            st = await self.data_io.stat(_data_oid(bucket, key))
        except ObjectNotFound:
            return 404, {}, b""
        # HEAD: the real object size IS the Content-Length (no body)
        return 200, {"Content-Length": str(st["size"])}, b""

    async def _delete_object(self, bucket: str,
                             key: str) -> tuple[int, dict, bytes]:
        try:
            await self.data_io.remove(_data_oid(bucket, key))
        except ObjectNotFound:
            return 404, {}, b"NoSuchKey"
        await self.io.omap_rm(_index_oid(bucket), [key])
        return 204, {}, b""


    # -- multipart (RGWInitMultipart / part put / RGWCompleteMultipart) ------

    @staticmethod
    def _part_oid(upload_id: str, n: int) -> str:
        return f".mp.{upload_id}.{n:05d}"

    @staticmethod
    def _upload_meta_oid(upload_id: str) -> str:
        return f".mp.{upload_id}.meta"

    async def _initiate_multipart(self, bucket: str,
                                  key: str) -> tuple[int, dict, bytes]:
        if not await self._bucket_exists(bucket):
            return 404, {}, b"NoSuchBucket"
        upload_id = secrets.token_hex(12)
        await self.io.write_full(
            self._upload_meta_oid(upload_id),
            json.dumps({"bucket": bucket, "key": key}).encode())
        xml = (f"<InitiateMultipartUploadResult>"
               f"<Bucket>{escape(bucket)}</Bucket>"
               f"<Key>{escape(key)}</Key>"
               f"<UploadId>{upload_id}</UploadId>"
               f"</InitiateMultipartUploadResult>")
        return 200, {"Content-Type": "application/xml"}, xml.encode()

    async def _load_upload(self, upload_id: str) -> dict | None:
        try:
            return json.loads(
                await self.io.read(self._upload_meta_oid(upload_id)))
        except (ObjectNotFound, ValueError):
            return None

    async def _put_part(self, bucket: str, key: str, query: dict,
                        body: bytes) -> tuple[int, dict, bytes]:
        upload_id = query["uploadId"]
        meta = await self._load_upload(upload_id)
        if meta is None or (meta["bucket"], meta["key"]) != (bucket, key):
            return 404, {}, b"NoSuchUpload"
        try:
            n = int(query.get("partNumber", "0"))
        except ValueError:
            n = 0
        if not 1 <= n <= 10000:
            return 400, {}, b"InvalidPartNumber"
        from ceph_tpu_torch.native import ec_native
        etag = f"{ec_native.crc32c(body):08x}"
        await self.data_io.write_full(self._part_oid(upload_id, n), body)
        return 200, {"ETag": f'"{etag}"'}, b""

    async def _upload_parts(self, upload_id: str) -> list[str]:
        prefix = f".mp.{upload_id}."
        return sorted(o for o in await self.data_io.list_objects()
                      if o.startswith(prefix)
                      and not o.endswith(".meta"))

    async def _complete_multipart(self, bucket: str, key: str,
                                  upload_id: str
                                  ) -> tuple[int, dict, bytes]:
        meta = await self._load_upload(upload_id)
        if meta is None or (meta["bucket"], meta["key"]) != (bucket, key):
            return 404, {}, b"NoSuchUpload"
        if not await self._bucket_exists(bucket):
            # the bucket died while the upload was in flight: completing
            # must not resurrect it through the index omap_set
            return 404, {}, b"NoSuchBucket"
        parts = await self._upload_parts(upload_id)
        if not parts:
            return 400, {}, b"InvalidRequest: no parts"
        # concatenate in part order via ranged appends: the final
        # object replaces any previous content. The rolling crc starts
        # at crc32c's default seed so the multipart ETag prefix matches
        # what GET recomputes over the same bytes
        from ceph_tpu_torch.native import ec_native
        total = 0
        crc = 0xFFFFFFFF
        dst = _data_oid(bucket, key)
        for i, oid in enumerate(parts):
            blob = await self.data_io.read(oid)
            if i == 0:
                await self.data_io.write_full(dst, blob)
            else:
                await self.data_io.write(dst, blob, offset=total)
            crc = ec_native.crc32c(blob, crc)
            total += len(blob)
        etag = f"{crc:08x}-{len(parts)}"
        await self.io.omap_set(_index_oid(bucket), {
            key: json.dumps({"size": total, "etag": etag}).encode()})
        for oid in parts:
            try:
                await self.data_io.remove(oid)
            except ObjectNotFound:
                pass
        await self.io.remove(self._upload_meta_oid(upload_id))
        xml = (f"<CompleteMultipartUploadResult>"
               f"<Bucket>{escape(bucket)}</Bucket>"
               f"<Key>{escape(key)}</Key>"
               f"<ETag>&quot;{etag}&quot;</ETag>"
               f"</CompleteMultipartUploadResult>")
        return 200, {"Content-Type": "application/xml"}, xml.encode()

    async def _abort_multipart(self, bucket: str, key: str,
                               upload_id: str) -> tuple[int, dict, bytes]:
        meta = await self._load_upload(upload_id)
        if meta is None or (meta["bucket"], meta["key"]) != (bucket, key):
            return 404, {}, b"NoSuchUpload"
        for oid in await self._upload_parts(upload_id):
            try:
                await self.data_io.remove(oid)
            except ObjectNotFound:
                pass
        await self.io.remove(self._upload_meta_oid(upload_id))
        return 204, {}, b""


_REASON = {200: "OK", 204: "No Content", 206: "Partial Content",
           400: "Bad Request", 404: "Not Found",
           405: "Method Not Allowed", 409: "Conflict",
           416: "Range Not Satisfiable", 500: "Internal Server Error"}
