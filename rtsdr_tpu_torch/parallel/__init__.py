"""Parallel receivers over a (channel, time) mesh.

``channel`` (data parallel): many FM stations, each channel shard's rows on
its own device with no communication.  ``time`` (sequence parallel): one
station's block split into chunks; FIR overlap-save tails become halo
exchanges and the PLL state pipelines (or is extrapolated) chunk to chunk.
The time shards of one channel shard stack on its device, or, on a grid
of ``n_ch x n_t`` devices, each steps on its own device and stream
(``parallel/mesh.py``).
"""

from rtsdr_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from rtsdr_tpu_torch.parallel.channels import (  # noqa: F401
    make_channel_sharded_receiver,
)
