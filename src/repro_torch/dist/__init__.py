"""Distributed-training substrate of the port: sharding rules, the
shardability oracle, compressed collectives and fault tolerance. Pure
Python spec logic: importing this package builds no device mesh (the
mesh of real devices, and `repro`'s `to_shardings` on it, are not ported)."""
from repro_torch.dist import collectives, fault, oracle, sharding  # noqa: F401
