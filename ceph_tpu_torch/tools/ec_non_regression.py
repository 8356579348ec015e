"""EC chunk-stability non-regression harness.

Port of ceph_tpu/tools/ec_non_regression.py, a re-creation of the
reference's `ceph_erasure_code_non_regression`
(src/test/erasure-code/ceph_erasure_code_non_regression.cc) + the
`ceph-erasure-code-corpus` workflow: `--create` encodes a fixed payload
for a (plugin, profile) into a corpus directory; `--check` re-encodes the
archived payload and fails if any chunk byte differs from the archived
chunks — guarding on-disk encoding stability across versions.

Corpus layout (one dir per profile):
  <corpus>/<version>/<signature>/{payload,<chunk_id>}
where signature = plugin + sorted profile items.

The port reads the same corpus as the JAX package: a profile archived
under a reference plugin name (`tpu`) runs the port's plugin of that
role (`cuda`, convert.port_profile). `--device` (default cuda) picks
where the plugins run; it is not part of a signature.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ceph_tpu_torch import convert
from ceph_tpu_torch import device as _device
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

VERSION = "v1"


def signature(plugin: str, profile: dict) -> str:
    items = sorted((k, v) for k, v in profile.items() if k != "plugin")
    raw = plugin + "_" + "_".join(f"{k}={v}" for k, v in items)
    # one corpus entry = one directory: keep path separators and other
    # filesystem-hostile characters out of the name (values like
    # directory=/path would otherwise nest directories check_all can't find)
    return "".join(c if c.isalnum() or c in "=_-." else "-" for c in raw)


def _payload(size: int, seed: int = 42) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def _encode_all(plugin: str, profile: dict, payload: bytes,
                device: str) -> dict[int, bytes]:
    profile = convert.port_profile({**profile, "plugin": plugin})
    profile.setdefault("device", device)
    code = ErasureCodePluginRegistry.instance().factory(profile["plugin"],
                                                        profile)
    return code.encode(set(range(code.get_chunk_count())), payload)


def create(corpus: str, plugin: str, profile: dict, size: int,
           device: str = _device.DEFAULT_DEVICE) -> str:
    import json

    payload = _payload(size)
    chunks = _encode_all(plugin, profile, payload, device)
    d = os.path.join(corpus, VERSION, signature(plugin, profile))
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "profile.json"), "w") as f:
        json.dump({"plugin": plugin, **profile}, f, sort_keys=True)
    with open(os.path.join(d, "payload"), "wb") as f:
        f.write(payload)
    for cid, buf in chunks.items():
        with open(os.path.join(d, str(cid)), "wb") as f:
            f.write(buf)
    return d


def check(corpus: str, plugin: str, profile: dict,
          device: str = _device.DEFAULT_DEVICE) -> list[str]:
    """Returns a list of mismatch descriptions (empty = stable)."""
    d = os.path.join(corpus, VERSION, signature(plugin, profile))
    if not os.path.isdir(d):
        return [f"no archived corpus at {d}"]
    try:
        with open(os.path.join(d, "payload"), "rb") as f:
            payload = f.read()
    except OSError as e:
        return [f"unreadable payload in {d}: {e}"]
    try:
        chunks = _encode_all(plugin, profile, payload, device)
    except _device.DeviceUnavailable:
        raise                # the run's device is missing: not a finding
    except Exception as e:  # a broken plugin is a finding, not an abort
        return [f"re-encode failed: {type(e).__name__}: {e}"]
    errors = []
    # archived chunks the current encoder no longer produces are format
    # breaks too (dropped/renumbered shards)
    archived_ids = {name for name in os.listdir(d) if name.isdigit()}
    orphans = archived_ids - {str(cid) for cid in chunks}
    for cid in sorted(orphans, key=int):
        errors.append(f"chunk {cid}: archived but no longer produced")
    for cid, buf in chunks.items():
        path = os.path.join(d, str(cid))
        if not os.path.exists(path):
            errors.append(f"chunk {cid}: missing from corpus")
            continue
        with open(path, "rb") as f:
            archived = f.read()
        if archived != buf:
            first = next(i for i, (a, b) in enumerate(zip(archived, buf))
                         if a != b) if len(archived) == len(buf) else -1
            errors.append(
                f"chunk {cid}: differs from archive "
                f"(len {len(archived)} vs {len(buf)}, first diff @{first})")
    return errors


def check_all(corpus: str,
              device: str = _device.DEFAULT_DEVICE) -> list[str]:
    """--check over every archived profile in the corpus."""
    import json

    root = os.path.join(corpus, VERSION)
    if not os.path.isdir(root):
        return [f"no corpus at {root}"]
    errors = []
    for sig in sorted(os.listdir(root)):
        manifest = os.path.join(root, sig, "profile.json")
        if not os.path.exists(manifest):
            errors.append(f"{sig}: missing profile.json manifest")
            continue
        with open(manifest) as f:
            profile = json.load(f)
        plugin = profile["plugin"]
        errors += [f"{sig}: {e}"
                   for e in check(corpus, plugin, profile, device)]
    return errors


def main(argv=None) -> int:
    from ceph_tpu_torch.tools.ec_tool import parse_profile

    p = argparse.ArgumentParser()
    p.add_argument("--corpus", default="ceph-erasure-code-corpus")
    p.add_argument("--create", action="store_true")
    p.add_argument("--check", action="store_true")
    p.add_argument("--all", action="store_true",
                   help="check every archived profile")
    p.add_argument("--profile", help="plugin,k=v,... (as ec_tool)")
    p.add_argument("--size", type=int, default=4096)
    p.add_argument("--device", default=_device.DEFAULT_DEVICE,
                   help="cuda (default), cuda:N or cpu")
    args = p.parse_args(argv)

    if args.all:
        if args.create or not args.check:
            p.error("--all only combines with --check")
        errors = check_all(args.corpus, args.device)
        for e in errors:
            print(e, file=sys.stderr)
        print("FAILED" if errors else "ok")
        return 1 if errors else 0

    if not args.create and not args.check:
        p.error("one of --create/--check required")
    if not args.profile:
        p.error("--profile is required (or use --check --all)")
    plugin, profile = parse_profile(args.profile)
    if args.create:
        d = create(args.corpus, plugin, profile, args.size, args.device)
        print(f"created {d}")
    errors = []
    if args.check:
        errors = check(args.corpus, plugin, profile, args.device)
        for e in errors:
            print(e, file=sys.stderr)
        print("FAILED" if errors else "ok")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
