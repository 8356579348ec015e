"""Sharding of the erasure-code pipeline over a grid of devices.

Port of ceph_tpu/parallel/mesh.py. Ceph's parallelism axes map onto a 2D
(stripe, shard) grid of devices as in the reference:

  axis "stripe" — data parallelism over concurrent stripes (independent
      RMW pipelines, the PG/ShardedThreadPool analog);
  axis "shard"  — each device owns a slice of the *parity rows* (the
      coding matrix, zero-padded to whole chunks, is row-sharded) and
      applies it to its stripe row's whole batch.

One process drives every device. The reference runs one `shard_map`
program from one controller, and the offload service calls the mesh from
its executor threads inside one process, so the port does the same: each
stripe slice of the batch is copied to every device of its stripe row,
K3 (`rs_codec.encode_local`, parity rows plus checksum partial in one
pass) runs there on that device's current stream, the parity row blocks
are gathered back in (stripe, shard) order, and the reference's `psum` is
the sum of the devices' checksum partials mod 2^32. No process group and
no collective library are involved.

A mesh may name one device several times (`[cuda:0] * 4`, or `["cpu"] *
8` in the tests, the counterpart of the reference tests' 8 virtual CPU
devices): the partition logic is then exercised on one device.
"""
from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch import device as _device
from ceph_tpu_torch.ec import gf256
from ceph_tpu_torch.ops import rs_codec


class Mesh:
    """A (stripe, shard) grid of torch devices."""

    def __init__(self, devices: list[torch.device], stripe: int, shard: int):
        if len(devices) != stripe * shard:
            raise ValueError(f"{len(devices)} devices for a "
                             f"{stripe}x{shard} mesh")
        #: devices[i][j]: stripe row i, shard column j
        self.devices = [list(devices[i * shard:(i + 1) * shard])
                        for i in range(stripe)]
        self.shape = {"stripe": stripe, "shard": shard}

    @property
    def first(self) -> torch.device:
        """Where gathered results and the checksum land."""
        return self.devices[0][0]


def make_mesh(n_devices: int | None = None, stripe: int | None = None,
              shard_max: int = 3, devices=None) -> Mesh:
    """Build a (stripe, shard) mesh over the first n devices.

    `devices` defaults to every visible card and raises DeviceUnavailable
    without one; an explicit list (each entry resolved like any entry
    point's `device`, repeats allowed) builds a mesh larger than the
    machine. The shape rule is the reference's: the shard axis splits
    parity rows, so its extent is capped at `shard_max` (callers pass
    their m; the default is the flagship m=3) and the rest of the
    devices go to stripe parallelism; an explicit `stripe` must divide
    n."""
    devs = _device.resolve_all(devices)
    devs = devs[: n_devices or len(devs)]
    n = len(devs)
    if n == 0:
        raise ValueError("make_mesh: no devices")
    if stripe is None:
        shard = max(d for d in range(1, n + 1)
                    if n % d == 0 and d <= max(1, shard_max))
        stripe = n // shard
    else:
        if n % stripe:
            raise ValueError(f"stripe={stripe} does not divide {n} devices")
        shard = n // stripe
    return Mesh(devs, stripe, shard)


def _to_tensor(arr) -> torch.Tensor:
    """A (B, k, C) host array or tensor as a contiguous uint8 tensor."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype != torch.uint8:
            raise TypeError("batch must be torch.uint8")
        return arr.contiguous()
    return _device.host_tensor(arr)


def shard_batch(mesh: Mesh, arr) -> tuple[torch.Tensor, int]:
    """Pad a (B, k, C) batch with zero stripes to a multiple of the
    mesh's 'stripe' extent; returns (padded tensor, original B). The
    padded stripes are encoded like any other (and add 0 to the
    checksum). Shared by the storage impl below and the offload
    service's oversized-batch path; the encode places each stripe slice
    on its stripe row's devices."""
    t = _to_tensor(arr)
    se = mesh.shape["stripe"]
    n = t.shape[0]
    pad = (-n) % se
    if pad:
        padded = torch.zeros((n + pad,) + tuple(t.shape[1:]),
                             dtype=torch.uint8, device=t.device,
                             pin_memory=t.is_pinned())
        padded[:n].copy_(t)
        t = padded
    return t, n


def shard_operands(M: np.ndarray, n_shard: int,
                   device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """K3's operands for each of n_shard columns, on `device`: the (r, k)
    matrix M zero-padded to m_pad = n_shard * ceil(r / n_shard) rows (a
    whole number of output chunks per column), column j's row slice as
    (packed (m_pad/n_shard, k, 8), bitmatrix (8 m_pad/n_shard, 8k))."""
    r, k = M.shape
    m_pad = n_shard * -(-r // n_shard)
    rows = m_pad // n_shard
    padded = np.zeros((m_pad, k), dtype=np.uint8)
    padded[:r] = M
    packed = rs_codec.packed_bitmatrix(padded)                 # (m_pad, k, 8)
    bitmatrix = gf256.matrix_to_bitmatrix(padded)              # (8m_pad, 8k)
    return [(torch.from_numpy(np.ascontiguousarray(
                 packed[j * rows:(j + 1) * rows])).to(device),
             torch.from_numpy(np.ascontiguousarray(
                 bitmatrix[j * rows * 8:(j + 1) * rows * 8])).to(device))
            for j in range(n_shard)]


def sharded_encode_fn(mesh: Mesh, k: int, m: int,
                      coding: np.ndarray | None = None):
    """Returns fn(data (B, k, N) uint8 tensor) -> (parity (B, m, N) on
    the mesh's first device, checksum 0-d int64 there).

    B must be a multiple of the 'stripe' extent (`shard_batch` pads).
    Stripe slices go to their stripe row; parity rows, zero-padded to
    m_pad = a whole number of chunks per shard device, are split over
    'shard'. The checksum is sum(parity_padded * 2654435761) mod 2^32
    over every device's output, padding rows and padded stripes
    included (they are zero)."""
    if coding is None:
        coding = gf256.reed_sol_van_matrix(k, m)
    coding = np.ascontiguousarray(coding, dtype=np.uint8)
    if coding.shape != (m, k):
        raise ValueError(f"coding matrix {coding.shape} is not ({m}, {k})")
    n_stripe, n_shard = mesh.shape["stripe"], mesh.shape["shard"]
    # every shard column's row slice, once per distinct device
    operands = {dev: shard_operands(coding, n_shard, dev)
                for row in mesh.devices for dev in row}
    out_dev = mesh.first

    def encode(data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        data = _to_tensor(data)
        b, kd, n = data.shape
        if kd != k:
            raise ValueError(f"expected {k} data chunks, got {kd}")
        if b % n_stripe:
            raise ValueError(f"batch {b} not a multiple of the mesh's "
                             f"stripe extent {n_stripe}")
        bl = b // n_stripe
        blocks, partials = [], []
        for i, row in enumerate(mesh.devices):
            local = data[i * bl:(i + 1) * bl]
            for j, dev in enumerate(row):
                # the stripe slice is replicated over its row's devices
                src = local.to(dev, non_blocking=True)
                parity, csum = rs_codec.encode_local(*operands[dev][j], src)
                blocks.append(parity)
                partials.append(csum)
        # (stripe, shard) order: row blocks of one stripe slice side by
        # side, stripe slices one after another
        per_row = [torch.cat([blk.to(out_dev, non_blocking=True)
                              for blk in blocks[i * n_shard:(i + 1) * n_shard]],
                             dim=1) for i in range(n_stripe)]
        parity_padded = torch.cat(per_row, dim=0)          # (B, m_pad, N)
        csum = sum(p.to(out_dev) for p in partials) & 0xFFFFFFFF
        return parity_padded[:, :m], csum

    return encode


def sharded_pipeline_step_fn(mesh: Mesh, k: int, m: int,
                             erased: tuple[int, ...] | None = None):
    """The dry-run's full step: encode sharded stripes, erase the
    `erased` chunks (any mix of data and parity ids; default the first
    m), reconstruct them from k survivors over the mesh, and count the
    bytes that differ. Returns step(data) -> (errs, checksum), both 0-d
    int64 tensors on the mesh's first device."""
    coding = gf256.reed_sol_van_matrix(k, m)
    encode = sharded_encode_fn(mesh, k, m, coding)
    want = tuple(sorted(set(erased))) if erased is not None else tuple(range(m))
    if erased is not None and len(want) != len(tuple(erased)):
        raise ValueError(f"duplicate chunk ids in erased={erased}")
    if any(not 0 <= w < k + m for w in want):
        raise ValueError(f"erased ids {want} out of range 0..{k + m - 1}")
    if len(want) > m:
        raise ValueError(f"cannot erase {len(want)} > m={m} chunks")
    avail = tuple(i for i in range(k + m) if i not in want)[:k]
    R = rs_codec.recovery_matrix(coding, avail, want)
    recov = sharded_encode_fn(mesh, k, len(want), R)

    def step(data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        data = _to_tensor(data).to(mesh.first)
        parity, csum = encode(data)
        full = torch.cat([data, parity], dim=1)             # (B, k+m, N)
        rec, _ = recov(full[:, list(avail)])
        errs = (rec != full[:, list(want)]).sum()
        return errs, csum

    return step


def sharded_apply_fn(mesh: Mesh, M: np.ndarray):
    """Host-to-host sharded GF(2^8) matrix apply over `mesh`: returns
    fn((B, k, C) uint8 array or CPU tensor) -> (B, r, C) numpy uint8 for
    the (r, k) matrix `M`.

    The dispatch shape the offload service fans oversized batches
    through: the stripe batch is data-parallel over 'stripe', output
    rows split over 'shard'; encode passes the coding matrix,
    reconstruction a recovery matrix. Bit-identical to the single-device
    codec: same field, same matrices, exact arithmetic."""
    M = np.ascontiguousarray(M, dtype=np.uint8)
    r, k = M.shape
    enc = sharded_encode_fn(mesh, k, r, M)

    def apply(batch) -> np.ndarray:
        padded, n = shard_batch(mesh, batch)
        out, _ = enc(padded)
        return out[:n].cpu().numpy()

    return apply


def mesh_storage_impl(mesh: Mesh, k: int, m: int,
                      technique: str = "reed_sol_van"):
    """An ErasureCodeInterface impl whose batched stripe APIs run sharded
    over `mesh`: it plugs into the OSD storage driver (ec_util.encode /
    decode_shards / decode_concat), so the multi-device consumer is the
    storage path. A subclass of the `cuda` plugin on the mesh's first
    device (so without a card it needs a mesh built over "cpu"); encode
    and reconstruction both go through sharded_encode_fn, recovery
    encoders cached per erasure pattern. numpy in gives numpy out; a
    tensor in gives a tensor on the mesh's first device."""
    from ceph_tpu_torch.ec.plugin_cuda import ErasureCodeCuda

    class _MeshCuda(ErasureCodeCuda):
        _mesh: Mesh = None
        _enc = None

        def _sharded(self, fn, data):
            padded, n = shard_batch(self._mesh, data)
            out, _ = fn(padded)
            out = out[:n]
            return out if isinstance(data, torch.Tensor) \
                else out.cpu().numpy()

        def encode_stripes(self, data):
            if self._enc is None:
                self._enc = sharded_encode_fn(self._mesh, self.k, self.m,
                                              self.coding_matrix)
            return self._sharded(self._enc, data)

        def decode_stripes(self, avail_ids, want_ids, chunks):
            key = (tuple(avail_ids), tuple(want_ids))
            fn = self._dec_cache.get(key)
            if fn is None:
                R = rs_codec.recovery_matrix(self.coding_matrix,
                                             tuple(avail_ids),
                                             tuple(want_ids))
                fn = sharded_encode_fn(self._mesh, self.k,
                                       len(tuple(want_ids)), R)
                self._dec_cache[key] = fn
            return self._sharded(fn, chunks)

    impl = _MeshCuda()
    impl.init({"k": str(k), "m": str(m), "technique": technique,
               "device": str(mesh.first)})
    impl._mesh = mesh
    impl._dec_cache = {}
    return impl
