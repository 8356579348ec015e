"""QA harness: deterministic fault injection (`faultinject`) and the
seed-deterministic schedule-interleaving explorer (`interleave`).

The port's copy of ceph_tpu/qa/__init__.py without its lazy export of
the model checker (`ModelRunner`, `Thrasher`), which needs the client
stack the port does not have yet. Importing `ceph_tpu_torch.qa.
faultinject` stays cheap: the injector is consulted from hot paths.
"""

__all__: list[str] = []
