"""Erasure-code plugin layer: interface, registry, the jerasure matrix
techniques and the `cuda` plugin."""
