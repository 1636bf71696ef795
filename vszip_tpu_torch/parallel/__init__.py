"""Frame sharding over several devices (``mesh.py``)."""

from .mesh import FRAMES_AXIS, Mesh, frames_mesh, replicate_clip, run_sharded, shard_clip

__all__ = ["FRAMES_AXIS", "Mesh", "frames_mesh", "shard_clip", "replicate_clip", "run_sharded"]
