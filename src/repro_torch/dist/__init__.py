"""Distributed-training substrate of the port: compressed collectives and
fault tolerance (`repro.dist` but its mesh sharding rules, ROADMAP item 13)."""
from repro_torch.dist import collectives, fault  # noqa: F401
