"""Multi-device decode: the device mesh and the data-parallel batch decode
(``mesh.py``), the blocked decode of one long capture on one device or
sharded over a mesh (``stream.py``), its OFDM counterpart
(``ofdm_stream.py``) and the multi-process bring-up (``multihost.py``)."""

from trackmaker_tpu_torch.parallel.mesh import batch_sharded_decode, make_mesh
from trackmaker_tpu_torch.parallel.ofdm_stream import decode_ofdm_blocked_sharded
from trackmaker_tpu_torch.parallel.stream import decode_blocked_sharded

__all__ = ["make_mesh", "batch_sharded_decode", "decode_blocked_sharded",
           "decode_ofdm_blocked_sharded"]
