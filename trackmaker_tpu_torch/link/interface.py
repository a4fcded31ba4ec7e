"""Acoustic packet interface: IP datagrams over the sound link
(reference src/mac/acoustic_interface.rs; counterpart of
``trackmaker_tpu/link/interface.py``).

``send_packet`` fragments at the acoustic MTU and CSMA-sends each
fragment *without* waiting for ACKs (the reference's Transmitting arm
returns directly, acoustic_interface.rs:222-266 — reliability is left to
upper layers for packet traffic); ``recv_packet`` yields reassembled IP
packets with the carrying frame type and source MAC.  The PHY encodes and
decodes on `device`, the card unless the caller asks for another; every
deadline counts samples of the simulated bus.
"""

from __future__ import annotations

import enum
import random
from collections import deque

import torch

from trackmaker_tpu_torch.core.config import (
    FRAME_TYPE_ACK, FRAME_TYPE_DATA, MacConfig, NetConfig, PhyConfig)
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.link.audio import AppState, AudioEndpoint
from trackmaker_tpu_torch.link.csma import is_channel_busy
from trackmaker_tpu_torch.net.fragmentation import IpFragmenter, IpReassembler
from trackmaker_tpu_torch.phy.decoder import PhyDecoder
from trackmaker_tpu_torch.phy.encoder import PhyEncoder


class TxState(enum.Enum):
    IDLE = 0
    SENSING = 1
    WAITING_FOR_DIFS = 2
    BACKOFF = 3
    BACKOFF_PAUSED = 4
    WAITING_FOR_PLAYBACK = 5


class AcousticInterface:
    def __init__(self, endpoint: AudioEndpoint, cfg: PhyConfig,
                 mac_cfg: MacConfig, net_cfg: NetConfig, local_mac: int,
                 sample_rate: int = 48_000, seed: int = 0,
                 max_frames_per_decode: int = 8, phy=None,
                 device: torch.device | str = "cuda"):
        self.ep = endpoint
        self.cfg = cfg
        self.mac = mac_cfg
        self.local_mac = local_mac
        self.sr = sample_rate
        self.rng = random.Random(seed)
        # `phy` (optional): stream-PHY duck type — the packet
        # interface is modem-agnostic like the CSMA/ARQ nodes
        self.encoder = phy or PhyEncoder(cfg, device=device)
        self.decoder = phy or PhyDecoder(cfg, local_mac,
                                         max_frames_per_decode, device=device)
        self.fragmenter = IpFragmenter(net_cfg.mtu)
        self.reassembler = IpReassembler()

        self._tx_queue: deque[tuple[bytes, int, int]] = deque()
        self._rx_packets: deque[tuple[bytes, int, int]] = deque()
        self._tx_state = TxState.IDLE
        self._current: Frame | None = None
        self._backoff = 0
        self._stage = 0
        self._deadline = 0
        self._next_poll = 0
        self.ep.set_state(AppState.RECORDING)

    # -- public API (mirrors send_packet/receive_packet) -------------------

    def send_packet(self, data: bytes, dest_mac: int,
                    frame_type: int = FRAME_TYPE_DATA) -> None:
        for frag in self.fragmenter.fragment_packet(bytes(data)):
            self._tx_queue.append((frag, dest_mac, frame_type))

    def recv_packet(self) -> tuple[bytes, int, int] | None:
        """-> (ip_packet, frame_type, src_mac) or None."""
        if self._rx_packets:
            return self._rx_packets.popleft()
        return None

    @property
    def tx_idle(self) -> bool:
        return self._tx_state == TxState.IDLE and not self._tx_queue

    def _ms(self, ms: float) -> int:
        return int(ms * self.sr / 1000)

    # -- tick ---------------------------------------------------------------

    def on_tick(self, now: int) -> None:
        if self._tx_state != TxState.IDLE:
            self._tx_tick(now)
            return
        if self._tx_queue:
            frag, dst, ftype = self._tx_queue.popleft()
            # seq is always 0 on this path (acoustic_interface.rs:78-82)
            self._current = (Frame.new_ack(0, self.local_mac, dst, frag)
                             if ftype == FRAME_TYPE_ACK
                             else Frame.new_data(0, self.local_mac, dst, frag))
            self._stage = 0
            self._tx_state = TxState.SENSING
            self.ep.set_state(AppState.RECORDING)
            self._deadline = now + self.mac.energy_detection_samples
            return
        self._rx_tick(now)

    def _tx_tick(self, now: int) -> None:
        if now < self._deadline:
            return
        st = self._tx_state
        if st == TxState.SENSING:
            busy = is_channel_busy(self.ep.peek_record(), self.mac)
            if busy is None:
                self._deadline = now + self.mac.energy_detection_samples
                return
            self.ep.clear_record()
            if busy:
                self._deadline = now + self.mac.energy_detection_samples
            else:
                self._tx_state = TxState.WAITING_FOR_DIFS
                self._deadline = now + self._ms(self.mac.difs_duration_ms)
        elif st == TxState.WAITING_FOR_DIFS:
            busy = is_channel_busy(self.ep.peek_record(), self.mac)
            if busy is None:
                self._deadline = now + self.mac.energy_detection_samples
                return
            self.ep.clear_record()
            if busy:
                self._tx_state = TxState.SENSING
            else:
                cw = min(self.mac.cw_min * 2 * self._stage, self.mac.cw_max)
                self._backoff = self.rng.randint(0, cw)
                self._tx_state = TxState.BACKOFF
        elif st == TxState.BACKOFF:
            if self._backoff == 0:
                track = self.encoder.encode_frames([self._current])
                self.ep.set_playback(track)
                self.ep.clear_record()
                self.ep.set_state(AppState.PLAYING)
                self._tx_state = TxState.WAITING_FOR_PLAYBACK
                return
            busy = is_channel_busy(self.ep.peek_record(), self.mac)
            if busy is True:
                self._tx_state = TxState.BACKOFF_PAUSED
                self._deadline = now + self._ms(self.mac.difs_duration_ms)
            elif busy is False:
                self.ep.clear_record()
                self._backoff -= 1
                self._deadline = now + self._ms(self.mac.slot_time_ms)
        elif st == TxState.BACKOFF_PAUSED:
            busy = is_channel_busy(self.ep.peek_record(), self.mac)
            if busy is None:
                return
            self.ep.clear_record()
            if busy:
                self._deadline = now + self._ms(self.mac.difs_duration_ms)
            else:
                self._tx_state = TxState.BACKOFF
                self._deadline = now + self._ms(self.mac.slot_time_ms)
        elif st == TxState.WAITING_FOR_PLAYBACK:
            if self.ep.state == AppState.IDLE:
                # transmit complete; no ACK wait on the packet path
                self.ep.set_state(AppState.RECORDING)
                self.decoder.reset()
                self._current = None
                self._tx_state = TxState.IDLE

    def _rx_tick(self, now: int) -> None:
        if now < self._next_poll:
            return
        self._next_poll = now + self._ms(10)
        if self.ep.record_len() <= 50:
            return
        new = self.ep.take_record()
        for f in self.decoder.process_samples(new):
            if f.frame_type not in (FRAME_TYPE_DATA, FRAME_TYPE_ACK):
                continue
            packet = self.reassembler.process_fragment(f.data)
            if packet is not None:
                self._rx_packets.append((packet, f.frame_type, f.src))
