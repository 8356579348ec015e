"""ceph_tpu_torch — the PyTorch/CUDA port of ceph_tpu's device data path.

A second package beside the JAX package `ceph_tpu`, which stays the
reference: each module here is held byte for byte against the module of
the same path there. The port imports `torch` and never `jax`, and nothing
of `ceph_tpu`; what it needs from the reference's jax-free modules it keeps
as its own copy.

Every entry point takes a `device` (default "cuda") and raises when no
card is present unless the caller asks for the CPU, where each kernel's
wrapper runs the kernel's plain PyTorch version instead.

Subpackages (same layout as ceph_tpu):
  ec      erasure-code plugin layer: interface, registry, every plugin
          of the reference (jerasure with its matrix and bitmatrix
          techniques, isa, shec, lrc, clay) and `cuda`, the counterpart
          of its `tpu` plugin
  ops     device kernels: GF(2^8) bit-matrix apply (K1), crc32c over
          fixed-size blocks (K2), the sharded encode's per-device step
          with its checksum (K3), all hand-written CUDA for sm_90a
  osd     ECUtil stripe codec (encode / decode_concat / decode_shards,
          and their offload-service paths)
  offload the process-wide offload service (batching, per-card breakers,
          mesh fan-out)
  parallel the (stripe, shard) device mesh and the sharded encode
  utils   Checksummer (BlueStore per-block checksums); copies of dout,
          perf counters, the Throttle, the config schema and the
          observability modules: tracer (spans, sampling, dispatch
          profiling), critpath, flight (the event ring) and copytrack
          (the copy ledger)
  kv      the KeyValueDB contract, MemDB and the LSM store (WAL + SST
          files byte-equal to the reference's)
  objectstore  the ObjectStore contract and transactions, MemStore,
          FileStore and BlueStore (block file + KV metadata, per-AU
          crc32c on the host); a store written by either package mounts
          in the other
  crush   CRUSH (straw2, firstn / indep rules) and the OSDMap with its
          pools, PGs and incrementals
  msg     the msgr2-subset wire: frames (native or Python codec), typed
          messages with the EC sub-ops, the asyncio Messenger
  native  ctypes loader for the repo's host C++ codec, crc32c and msgr2
          frame codec
  mon     the monitor (Paxos, OSDMonitor) and the MonClient
  mgr     the mgr daemon (report fan-in with each OSD's per-card
          offload rows, health digest, modules), its prometheus
          exporter and metrics history, and the daemons' MgrClient
  rados   librados: RadosClient, IoCtx, aio completions
  tools   ec_benchmark, bench_driver (its cpu, probe, device,
          mesh_scaling, cluster_tpu and attribution stages),
          cluster_boot (ephemeral clusters, thread- or process-sharded),
          rados_bench, ec_tool, ec_non_regression (the corpus check),
          gen_bitmatrix_tables

The OSD, its PGs and EC backend are in `osd`; the daemon runtime
(thread- and process-backed reactor shards, the worker that hosts OSDs
in a process of its own, admin sockets) in `utils`.
"""

__version__ = "0.1.0"
