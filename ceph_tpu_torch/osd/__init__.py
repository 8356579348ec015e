"""OSD data plane: daemon (daemon.py), PG + peering (pg.py), backends
(backend.py replicated, ec_backend.py erasure), PGLog (pglog.py), EC
stripe driver (ec_util.py), scrub (scrub.py), snapshots (snaps.py) and
the op scheduler (scheduler/)."""
