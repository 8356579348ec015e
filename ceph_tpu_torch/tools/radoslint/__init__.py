"""radoslint — AST-based asyncio/lockdep sanitizer suite.

The static half of the reference's race tooling (src/common/lockdep.cc,
ceph-dencoder's registry cross-checks): the asyncio/lockdep checkers,
the interlock zero-copy lifetime + cross-shard dataflow rules
(lifetimes.py), a per-file finding model with inline suppressions, and
a committed baseline so the tier-1 gate only ever ratchets toward zero.

    from ceph_tpu_torch.tools.radoslint import run_lint
    findings = run_lint(["ceph_tpu_torch"], root=repo_root)

The port's copy of the reference's linter: it holds no kernel and
touches no device, so no entry point of it takes `device`. With no
arguments it lints `ceph_tpu_torch/` against the port's own baseline
(`ceph_tpu_torch/.radoslint-baseline.json`).
"""
from ceph_tpu_torch.tools.radoslint.core import (Finding, RULES, find_baseline,
                                           load_baseline, run_lint,
                                           write_baseline)
from ceph_tpu_torch.tools.radoslint import (checkers, lifetimes,  # noqa: F401
                                      lockorder, project)

__all__ = ["Finding", "RULES", "run_lint", "find_baseline",
           "load_baseline", "write_baseline"]
