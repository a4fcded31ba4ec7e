"""CSMA/CA + Stop-and-Wait ARQ node FSMs (counterpart of ``trackmaker_tpu/link/csma.py``).

Each node encodes and decodes on `device` (the card unless the caller asks
for another) and hands the endpoint a host copy of every waveform it plays.
Tick-driven translations of the reference's thread-and-sleep state
machines: every wall-clock sleep becomes a sample-count deadline on the
simulated bus, so behavior is deterministic and can run far faster than
real time.  States and transitions mirror csma.rs:

sender  (csma.rs:60-403):  SENSING -> WAITING_FOR_DIFS -> BACKOFF /
        BACKOFF_PAUSED -> TRANSMITTING -> WAITING_FOR_ACK
        with contention window cw = min(CW_MIN*2*stage, CW_MAX)
        (csma.rs:225-230, *not* binary-exponential — faithful quirk),
        200 ms ACK timeout + retransmit (csma.rs:322-336).
receiver (csma.rs:405-615): poll every 25 ms, dedup by sequence set,
        always-ACK data frames (csma.rs:470-528).
"""

from __future__ import annotations

import enum
import random
from collections import deque

import numpy as np
import torch

from trackmaker_tpu_torch.core.config import (
    FRAME_TYPE_ACK, FRAME_TYPE_DATA, MacConfig, PhyConfig)
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.link.audio import AppState, AudioEndpoint
from trackmaker_tpu_torch.phy.decoder import PhyDecoder
from trackmaker_tpu_torch.phy.encoder import PhyEncoder


def is_channel_busy(samples: np.ndarray, mac_cfg: MacConfig) -> bool | None:
    """Energy detector (src/mac/mod.rs:18-27): None if fewer than the
    minimum samples, else any |s| above threshold."""
    if len(samples) < mac_cfg.energy_detection_samples:
        return None
    return bool(np.any(np.abs(samples) > mac_cfg.energy_threshold))


class SenderState(enum.Enum):
    IDLE = 0
    SENSING = 1
    WAITING_FOR_DIFS = 2
    BACKOFF = 3
    BACKOFF_PAUSED = 4
    TRANSMITTING = 5
    WAITING_FOR_PLAYBACK = 6
    WAITING_FOR_ACK = 7
    DONE = 8


class CsmaSender:
    """Sends queued payload chunks as data frames with CSMA + ARQ."""

    def __init__(self, endpoint: AudioEndpoint, cfg: PhyConfig,
                 mac_cfg: MacConfig, local_addr: int, remote_addr: int,
                 sample_rate: int = 48_000, seed: int = 0,
                 max_frames_per_decode: int = 8, phy=None,
                 device: torch.device | str = "cuda"):
        self.ep = endpoint
        self.cfg = cfg
        self.mac = mac_cfg
        self.local = local_addr
        self.remote = remote_addr
        self.sr = sample_rate
        self.rng = random.Random(seed)
        # `phy` (optional) provides both encode_frames and
        # process_samples/reset — e.g. an OfdmStreamPhy — so the MAC is
        # modem-agnostic; default is the line-coded PHY on `device`
        self.encoder = phy or PhyEncoder(cfg, device=device)
        self.decoder = phy or PhyDecoder(cfg, local_addr,
                                         max_frames_per_decode, device=device)

        self.queue: deque[bytes] = deque()
        self.seq = 0
        self.stage = 0
        self.state = SenderState.IDLE
        self.current: Frame | None = None
        self.backoff_counter = 0
        self._deadline = 0
        self._ack_deadline = 0
        self._next_poll = 0
        self.acked = 0
        self.retransmissions = 0

    def send(self, payload: bytes) -> None:
        self.queue.append(bytes(payload))

    @property
    def finished(self) -> bool:
        return self.state in (SenderState.IDLE, SenderState.DONE) \
            and not self.queue

    def _ms(self, ms: float) -> int:
        return int(ms * self.sr / 1000)

    def _begin_frame(self) -> None:
        payload = self.queue.popleft()
        self.current = Frame.new_data(self.seq, self.local, self.remote,
                                      payload)
        self.seq = (self.seq + 1) & 0xFF
        self.stage = 0
        self.state = SenderState.SENSING
        self.ep.set_state(AppState.RECORDING)
        self._deadline = 0

    def _pick_backoff(self) -> None:
        cw = min(self.mac.cw_min * 2 * self.stage, self.mac.cw_max)
        self.backoff_counter = self.rng.randint(0, cw)
        self.state = SenderState.BACKOFF

    def on_tick(self, now: int) -> None:
        if self.state == SenderState.IDLE:
            if self.queue:
                self._begin_frame()
            return
        if self.state == SenderState.DONE:
            return
        if now < self._deadline:
            return

        st = self.state
        if st == SenderState.SENSING:
            # sleep(ENERGY_DETECTION_SAMPLES worth) then sense (csma.rs:83-119)
            busy = is_channel_busy(self.ep.peek_record(), self.mac)
            if busy is None:
                self._deadline = now + self.mac.energy_detection_samples
                return
            self.ep.clear_record()
            if busy:
                self._deadline = now + self.mac.energy_detection_samples
            else:
                self.state = SenderState.WAITING_FOR_DIFS
                self._deadline = now + self._ms(self.mac.difs_duration_ms)

        elif st == SenderState.WAITING_FOR_DIFS:
            busy = is_channel_busy(self.ep.peek_record(), self.mac)
            if busy is None:
                self._deadline = now + self.mac.energy_detection_samples
                return
            self.ep.clear_record()
            if busy:
                self.state = SenderState.SENSING
                self._deadline = now + self.mac.energy_detection_samples
            else:
                self._pick_backoff()

        elif st == SenderState.BACKOFF:
            if self.backoff_counter == 0:
                self._transmit(now)
                return
            busy = is_channel_busy(self.ep.peek_record(), self.mac)
            if busy is True:
                self.state = SenderState.BACKOFF_PAUSED
                self._deadline = now + self._ms(self.mac.difs_duration_ms)
            elif busy is False:
                self.ep.clear_record()
                self.backoff_counter -= 1
                self._deadline = now + self._ms(self.mac.slot_time_ms)

        elif st == SenderState.BACKOFF_PAUSED:
            busy = is_channel_busy(self.ep.peek_record(), self.mac)
            if busy is None:
                return
            self.ep.clear_record()
            if busy:
                self._deadline = now + self._ms(self.mac.difs_duration_ms)
            else:
                self.state = SenderState.BACKOFF
                self._deadline = now + self._ms(self.mac.slot_time_ms)

        elif st == SenderState.WAITING_FOR_PLAYBACK:
            if self.ep.state == AppState.IDLE:
                self.ep.set_state(AppState.RECORDING)
                self.decoder.reset()
                self.state = SenderState.WAITING_FOR_ACK
                self._ack_deadline = now + self._ms(self.mac.ack_timeout_ms)
                self._next_poll = now + self._ms(10)

        elif st == SenderState.WAITING_FOR_ACK:
            if now >= self._ack_deadline:
                # timeout -> grow stage, backoff, retransmit (csma.rs:322-336)
                self.stage = min(self.stage + 1, 20)
                self.retransmissions += 1
                self._pick_backoff()
                self._deadline = now + self._ms(self.mac.slot_time_ms)
                return
            if now < self._next_poll:
                return
            self._next_poll = now + self._ms(10)
            new = self.ep.take_record()
            if len(new):
                for f in self.decoder.process_samples(new):
                    if (f.frame_type == FRAME_TYPE_ACK
                            and f.sequence == self.current.sequence):
                        self.acked += 1
                        self.state = SenderState.IDLE
                        return

    def _transmit(self, now: int) -> None:
        track = self.encoder.encode_frames([self.current])
        self.ep.set_playback(track)
        self.ep.clear_record()
        self.ep.set_state(AppState.PLAYING)
        self.state = SenderState.WAITING_FOR_PLAYBACK


class CsmaReceiver:
    """Receive loop: dedup by sequence, always ACK (csma.rs:405-615)."""

    def __init__(self, endpoint: AudioEndpoint, cfg: PhyConfig,
                 mac_cfg: MacConfig, local_addr: int, remote_addr: int,
                 sample_rate: int = 48_000,
                 max_frames_per_decode: int = 8, phy=None,
                 device: torch.device | str = "cuda"):
        self.ep = endpoint
        self.cfg = cfg
        self.mac = mac_cfg
        self.local = local_addr
        self.remote = remote_addr
        self.sr = sample_rate
        self.encoder = phy or PhyEncoder(cfg, device=device)
        self.decoder = phy or PhyDecoder(cfg, local_addr,
                                         max_frames_per_decode, device=device)
        self.received: list[bytes] = []
        self.seen: set[int] = set()
        self.duplicates = 0
        self._next_poll = 0
        self._pending_acks: deque[int] = deque()
        self.ep.set_state(AppState.RECORDING)

    def _ms(self, ms: float) -> int:
        return int(ms * self.sr / 1000)

    def on_tick(self, now: int) -> None:
        # finish pending ACK playback before returning to recording
        if self._pending_acks and self.ep.state == AppState.IDLE:
            self._pending_acks.popleft()
            if self._pending_acks:
                self._play_ack(self._pending_acks[0])
            else:
                self.ep.clear_record()
                self.ep.set_state(AppState.RECORDING)
            return
        if self.ep.state != AppState.RECORDING:
            return
        if now < self._next_poll:
            return
        self._next_poll = now + self._ms(25)
        if self.ep.record_len() <= 50:
            return
        new = self.ep.take_record()
        frames = self.decoder.process_samples(new)
        for f in frames:
            if f.frame_type != FRAME_TYPE_DATA:
                continue
            if f.sequence not in self.seen:
                self.seen.add(f.sequence)
                self.received.append(f.data)
            else:
                self.duplicates += 1
            self._pending_acks.append(f.sequence)
        if self._pending_acks:
            self._play_ack(self._pending_acks[0])

    def _play_ack(self, seq: int) -> None:
        ack = Frame.new_ack(seq, self.local, self.remote)
        track = self.encoder.encode_frames([ack], gap_samples=0)
        self.ep.set_playback(track)
        self.ep.set_state(AppState.PLAYING)
