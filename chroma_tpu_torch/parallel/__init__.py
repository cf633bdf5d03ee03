"""chroma_tpu_torch.parallel: photon sharding over the ranks of a
torch.distributed process group (counterpart of chroma_tpu.parallel), and
run_ranks to start such a group from one process."""
from chroma_tpu_torch.parallel.sharding import (  # noqa: F401
    PhotonMesh, photon_mesh, shard_seed, propagate_sharded,
    propagate_and_daq_sharded, photon_channels_sharded, pad_to_mesh,
    reduce_channel_arrays)
from chroma_tpu_torch.parallel.launch import run_ranks  # noqa: F401
