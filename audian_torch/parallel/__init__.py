"""Multi-device execution: device meshes, the halo exchange, the
sequence/channel-sharded pipeline, sequence-sharded batch detection, and
file-level batch data parallelism.  One process drives every device of a
mesh; a device may stand in a mesh more than once."""

from .batch import map_files
from .detect import sharded_band_env
from .mesh import Mesh, local_devices, make_mesh
from .pipeline import ShardedPipeline
from .shard import ChannelShards, channel_shards, halo_exchange, halo_window

__all__ = ["ChannelShards", "Mesh", "ShardedPipeline", "channel_shards",
           "halo_exchange", "halo_window", "local_devices", "make_mesh",
           "map_files", "sharded_band_env"]
