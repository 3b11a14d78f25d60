"""Sharded execution over torch.distributed: the group, the collectives, the pieces."""
