"""trackmaker_tpu_torch — the PyTorch and CUDA port of trackmaker_tpu.

It mirrors the JAX package's layout, so each module's counterpart sits at
the same path under ``trackmaker_tpu/``.  The batch decode of the
Manchester and 4B5B line codes, the MMSE equalizer in front of it (and its
decision-directed refit), the clock-offset recovery around it and the
ASK/chirp modem's receiver run on an NVIDIA Hopper card through
hand-written CUDA kernel sources (``csrc/``, thirteen with the tools'),
built with ``nvcc`` at first use; on CPU tensors every kernel wrapper runs
its plain PyTorch version.  One long recording decodes in blocks of time
through ``decode_blocked_single_chip``, or sharded over a device mesh
through ``parallel.decode_blocked_sharded`` (``parallel`` also holds the
data-parallel batch decode, the sharded OFDM decode and the multi-process
bring-up); live capture decodes through
``PhyDecoder`` (the chunked feed the MAC polls) and the energy-gated
``link.stream.StreamingDecodePipeline``, and the link layer moves files
between simulated nodes with CSMA/stop-and-wait, Go-Back-N or
Selective-Repeat ARQ over the port's PHY.  Above it, the network layer
carries IP over sound: ``link.interface.AcousticInterface`` fragments,
CSMA-sends and reassembles IPv4 packets, and ``net`` holds the IPv4/ICMP,
fragmentation, ARP, NAT, Ethernet, DNS and conntrack codecs and tables,
the router with its ports, the TUN bridge and the ping and IP-host tools
(``net.tools.run_ping_simulation``, a full PHY+MAC+NET round trip).  The
OFDM modems (``phy.ofdm`` v1, ``phy.ofdm_v2`` with Schmidl-Cox timing and
pilot tracking, ``phy.ofdm_adaptive`` with per-bin bit-loading, a
rate-1/2 code decoded by the Viterbi kernel, the probe, handshake and
retrain) and the single-carrier modems (``phy.fsk``, ``phy.psk``, their
stream PHYs in ``phy.stream_sc``) sync on the normalized correlation
kernel and plug under the same MAC and network layer as stream PHYs.
``python -m trackmaker_tpu_torch.cli`` is the command line, the JAX
package's thirteen subcommands on the card (``--cpu`` for the CPU); its
``decode`` takes many WAV or FLAC recordings and decodes each length
bucket as one batch.  Importing the package touches no device and builds
nothing, the host runtime's C++ included.

On the CPU, ``tests/test_torch_*.py`` hold each module against the JAX
package (``tests/test_torch_channel_timing.py`` and
``tests/test_torch_equalizer_dd.py`` this package's robustness modules,
``tests/test_torch_phy_decoder_stream.py`` and ``tests/test_torch_link.py``
its streaming receive path and link layer, ``tests/test_torch_net.py``,
``tests/test_torch_ping.py`` and ``tests/test_torch_router.py`` its network
layer, ``tests/test_torch_ofdm.py`` and ``tests/test_torch_ofdm_v2.py`` its
OFDM modems, ``tests/test_torch_ofdm_adaptive.py``,
``tests/test_torch_ofdm_adaptive_mac.py`` and ``tests/test_torch_fsk_psk.py``
adaptive OFDM and the single-carrier modems, ``tests/test_torch_io.py``,
``tests/test_torch_cli.py`` and ``tests/test_torch_bench_viz.py`` the audio
files, the host runtime, the command line and the dashboards,
``tests/test_torch_parallel.py``, ``tests/test_torch_parallel_ofdm.py``,
``tests/test_torch_multihost.py`` and ``tests/test_torch_optimistic.py`` the
multi-device decode and the optimistic 4B5B mode); on a card, ``python3
chip_smoke.py`` runs every path, its ``phase 2 (clock_search)``,
``(timing_gate)``, ``(timing_gate, flagship gaps)``, ``(decode_dd)`` and
``(sweeps)`` lines the robustness ones, ``phase 2 (stream_latency)`` and
the ``phase 2 (csma_transfer ...)``, ``(gbn_transfer ...)`` and
``(sr_transfer ...)`` lines the streaming path and the MAC, the ``phase 2
(ping ...)`` and ``(router)`` lines the network layer, ``phase 2
(ofdm_v2_b32)`` the OFDM modems, ``phase 2 (ofdm_adaptive_b8)``,
``(retrain)`` and ``(fsk modem)`` adaptive OFDM and the single-carrier
modems, ``phase 2 (cli ...)`` the command line on WAV and FLAC files,
``phase 2 (mesh ...)`` the multi-device decode over meshes of the card.

    trackmaker_tpu_torch.core   PhyConfig, MacConfig, NetConfig, bit ops, CRC8, frame codec
                                (host and batched),
                                first-set queries, Hamming(7,4) and the interleaver
    trackmaker_tpu_torch.dsp    carrier and chirp synthesis, EMA power, the channel
                                models (noise, gain, clock offset, delay, echo, mix),
                                the preamble-trained MMSE equalizer and its
                                decision-directed decode, the clock-offset search
                                and the per-frame timing gate
    trackmaker_tpu_torch.sync   correlation sync, the correlation, normalized-
                                correlation, row-stats and sliding-dot kernels
    trackmaker_tpu_torch.phy    line code, encoder, exact (and optimistic 4B5B) and
                                speculative decode,
                                the streaming PhyDecoder; the ASK modem and its
                                speculative receiver; the OFDM modems v1, v2 and
                                adaptive; the FSK and PSK modems
    trackmaker_tpu_torch.link   the streaming decode pipeline, the simulated
                                bus and endpoints, the CSMA, Go-Back-N and
                                Selective-Repeat nodes and transfers, the
                                acoustic packet interface
    trackmaker_tpu_torch.net    IPv4, ICMP, fragmentation, ARP, NAT, Ethernet,
                                DNS, conntrack, the router and its ports, the
                                TUN bridge, the ping and IP-host tools, the
                                router demo
    trackmaker_tpu_torch.utils  logging setup (``TM_LOG``), progress bars, the
                                text / bit-string converter
    trackmaker_tpu_torch.parallel  device meshes, the data-parallel batch decode, the
                                blocked decode of one long capture on one device
                                or sharded over a mesh (line-coded and OFDM), the
                                multi-process bring-up over torch.distributed
    trackmaker_tpu_torch.bench  frame loss against noise and clock offset, the
                                contended MAC/PHY parameter sweep, the PNG
                                (matplotlib) and self-contained HTML dashboards
    trackmaker_tpu_torch.cli    the command line: test, tx, ping, decode, encode,
                                ask-test, ofdm-test, ofdm-adapt, ber, sweep,
                                viz, router and tun
    trackmaker_tpu_torch.io     16-bit WAV, JSON dumps, FLAC through the runtime
    trackmaker_tpu_torch.runtime  the native host runtime (C++ built with g++
                                at first use): the FLAC decoder, CRC8, the
                                frame codec, the energy detector, the sample
                                ring, the segmenter, audio duplex
    trackmaker_tpu_torch.tools  the window health probe, the flagship stage
                                profiler, the two-stream correlation
                                experiment and the multi-process dry run; each
                                runs as ``python -m trackmaker_tpu_torch.tools.<name>``
"""

__version__ = "0.1.0"

from trackmaker_tpu_torch.core.config import PhyConfig  # noqa: F401
from trackmaker_tpu_torch.parallel.stream import (  # noqa: F401
    decode_blocked_exact,
    decode_blocked_single_chip,
    decode_blocked_spec,
)
