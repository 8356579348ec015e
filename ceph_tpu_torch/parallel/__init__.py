"""Sharding of the EC pipeline over a (stripe, shard) grid of devices."""
