"""Link layer (counterpart of ``trackmaker_tpu/link``): a simulated shared
acoustic medium, the MAC (CSMA/CA with stop-and-wait, Go-Back-N and
Selective-Repeat ARQ), the streaming receive path and ``AcousticInterface``,
which carries the network layer's IP packets over sound (fragmented at the
MTU, CSMA-sent, reassembled).

The medium is a discrete-time simulation (sample-accurate, chunk driven)
and every node a deterministic tick-based state machine: DIFS, slot and
ACK timeout count samples, not wall time, so a transfer's decisions do not
depend on how fast the card or the host runs.  Each node's PHY encode and
decode run on the card unless the caller asks for another device.
"""

from trackmaker_tpu_torch.link.audio import AppState, AudioEndpoint
from trackmaker_tpu_torch.link.bus import SimulatedBus
from trackmaker_tpu_torch.link.csma import CsmaSender, CsmaReceiver, is_channel_busy
from trackmaker_tpu_torch.link.interface import AcousticInterface

__all__ = [
    "AppState", "AudioEndpoint", "SimulatedBus",
    "CsmaSender", "CsmaReceiver", "is_channel_busy", "AcousticInterface",
]
