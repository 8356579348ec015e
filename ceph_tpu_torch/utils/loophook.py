"""Composable `loop.call_soon` wrapper chains.

Two instruments wrap `call_soon` on the same loop — the sanitizer's
foreign-thread recorder and the qa interleaving explorer's
bounded-shuffler — and their install/uninstall order is NOT guaranteed
to nest (a `config set sanitizer_enabled false` can land mid-explore).
The composition protocol lives here ONCE so both layers stay in sync:

  * `wrap(loop, key, make_wrapper)` saves the current callable under
    `_<key>_orig`, installs `make_wrapper(orig)`, and is a no-op when
    that key's wrapper is already in the chain (the wrapper is REUSED —
    it must consult its own armed state at call time);
  * `unwrap(loop, key)` restores the saved callable only when this
    key's wrapper is the TOP of the chain. A buried wrapper (someone
    wrapped on top since) stays installed as a pass-through — popping
    it would strip everything above it — and the saved attrs remain so
    a later `wrap()` reuses it instead of double-wrapping.

The port's copy of ceph_tpu/utils/loophook.py (jax-free; the
port imports nothing of the JAX package).
"""
from __future__ import annotations

from typing import Callable


def wrap(loop, key: str, make_wrapper: Callable) -> None:
    """Install (or reuse) a call_soon wrapper under `key`.
    `make_wrapper(orig)` builds the wrapper; it MUST degrade to a
    pass-through when its owner is disarmed, because it can outlive
    an `unwrap()` (see module doc)."""
    if getattr(loop, f"_{key}_orig", None) is not None:
        return                          # in-chain wrapper reused
    orig = loop.call_soon
    wrapper = make_wrapper(orig)
    setattr(loop, f"_{key}_orig", orig)
    setattr(loop, f"_{key}_wrapper", wrapper)
    loop.call_soon = wrapper


def unwrap(loop, key: str) -> None:
    """Pop this key's wrapper IFF it is the top of the chain; a buried
    wrapper stays (as a pass-through) so wrappers above it survive."""
    orig = getattr(loop, f"_{key}_orig", None)
    if orig is None:
        return
    if loop.__dict__.get("call_soon") is \
            getattr(loop, f"_{key}_wrapper", None):
        loop.call_soon = orig
        setattr(loop, f"_{key}_orig", None)
        setattr(loop, f"_{key}_wrapper", None)
