"""Go-Back-N sliding-window ARQ (counterpart of ``trackmaker_tpu/link/gbn.py``).

The reference's Stop-and-Wait (one frame in flight, 200 ms ACK timeout)
is the stated bottleneck of its whole system ("CSMA backoff and
Stop-and-Wait timeout dominate latency, not PHY throughput",
docs/proj/report.md:535).  Go-Back-N keeps a window of frames in flight
with cumulative ACKs, reusing the same PHY framing: ACK frames carry the
next-expected sequence number (cumulative), so the wire format stays
compatible with the reference's frame codec.

Same tick-driven structure as :mod:`trackmaker_tpu_torch.link.csma`; the
window transmit burst is encoded as ONE batched waveform (frames +
inter-frame gaps) so the PHY cost per burst is one batched encode.
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
from trackmaker_tpu_torch.link.bus import SimulatedBus
from trackmaker_tpu_torch.link.csma import is_channel_busy
from trackmaker_tpu_torch.link.transfer import chunk_payload
from trackmaker_tpu_torch.phy.decoder import PhyDecoder
from trackmaker_tpu_torch.phy.encoder import PhyEncoder

SEQ_MOD = 256


class GbnState(enum.Enum):
    IDLE = 0
    SENSING = 1
    TRANSMITTING = 2
    WAITING = 3


class GbnSender:
    def __init__(self, endpoint: AudioEndpoint, cfg: PhyConfig,
                 mac_cfg: MacConfig, local_addr: int, remote_addr: int,
                 window: int = 8, sample_rate: int = 48_000,
                 seed: int = 0, phy=None,
                 device: torch.device | str = "cuda"):
        assert window < SEQ_MOD // 2
        self.ep = endpoint
        self.cfg = cfg
        self.mac = mac_cfg
        self.local = local_addr
        self.remote = remote_addr
        self.window = window
        self.sr = sample_rate
        # `phy` (optional): stream-PHY duck type — swaps the waveform
        # under the window ARQ exactly like the CSMA nodes
        self.encoder = phy or PhyEncoder(cfg, device=device)
        self.decoder = phy or PhyDecoder(cfg, local_addr, 8, device=device)
        self.queue: deque[bytes] = deque()
        self.base = 0          # oldest unacked seq
        self.next_seq = 0      # next seq to assign
        self.unacked: deque[Frame] = deque()
        self.state = GbnState.IDLE
        self._deadline = 0
        self._ack_deadline = 0
        self._next_poll = 0
        # the receiver defers its cumulative ACK one max-frame airtime
        # past its last decode (see the receiver class); wait that much
        # beyond the reference 200 ms before declaring the burst lost
        max_air = (phy.frame_samples(cfg.max_frame_data_size)
                   if phy is not None else
                   cfg.preamble_len + cfg.samples_for_bits(
                       8 * (7 + cfg.max_frame_data_size)))
        self._rx_ack_lag = max_air \
            + cfg.inter_frame_gap_samples + self._ms(10)
        # contention backoff (multi-node): consecutive ACK timeouts
        # grow the window like the CSMA sender's cw quirk
        self._rng = random.Random(seed)
        self._stage = 0
        self.delivered = 0
        self.retransmit_bursts = 0

    def send(self, payload: bytes) -> None:
        self.queue.append(bytes(payload))

    @property
    def finished(self) -> bool:
        return not self.queue and not self.unacked \
            and self.state in (GbnState.IDLE,)

    def _ms(self, ms: float) -> int:
        return int(ms * self.sr / 1000)

    def _fill_window(self) -> None:
        while len(self.unacked) < self.window and self.queue:
            f = Frame.new_data(self.next_seq, self.local, self.remote,
                               self.queue.popleft())
            self.unacked.append(f)
            self.next_seq = (self.next_seq + 1) % SEQ_MOD

    def on_tick(self, now: int) -> None:
        if self.state == GbnState.IDLE:
            self._fill_window()
            if self.unacked:
                self.state = GbnState.SENSING
                self.ep.set_state(AppState.RECORDING)
                self._deadline = 0
            return
        if now < self._deadline:
            return

        if self.state == GbnState.SENSING:
            busy = is_channel_busy(self.ep.peek_record(), self.mac)
            if busy is None:
                self._deadline = now + self.mac.energy_detection_samples
                return
            self.ep.clear_record()
            if busy:
                # re-sense after ENERGY_DETECTION_SAMPLES like the CSMA
                # sender (csma.rs:83-119): waiting a full DIFS here lets
                # ~1000 samples accumulate, and `any |s| > thr` over that
                # long a window reads persistently busy at moderate noise
                self._deadline = now + self.mac.energy_detection_samples
                return
            # transmit the whole window as one burst
            track = self.encoder.encode_frames(list(self.unacked))
            self.ep.set_playback(track)
            self.ep.clear_record()
            self.ep.set_state(AppState.PLAYING)
            self.state = GbnState.TRANSMITTING

        elif self.state == GbnState.TRANSMITTING:
            if self.ep.state == AppState.IDLE:
                self.ep.set_state(AppState.RECORDING)
                self.decoder.reset()
                self.state = GbnState.WAITING
                self._ack_deadline = now + self._ms(
                    self.mac.ack_timeout_ms) + self._rx_ack_lag
                self._next_poll = now + self._ms(5)

        elif self.state == GbnState.WAITING:
            if now >= self._ack_deadline:
                # go back N: retransmit the whole remaining window
                self.retransmit_bursts += 1
                self._stage += 1
                cw = min(self.mac.cw_min * 2 * self._stage, self.mac.cw_max)
                self._deadline = now + self._rng.randint(0, cw) * self._ms(
                    self.mac.slot_time_ms)
                self.state = GbnState.SENSING
                return
            if now < self._next_poll:
                return
            self._next_poll = now + self._ms(5)
            new = self.ep.take_record()
            if not len(new):
                return
            for f in self.decoder.process_samples(new):
                if f.frame_type != FRAME_TYPE_ACK:
                    continue
                # cumulative: seq = next expected by the receiver
                acked = (f.sequence - self.base) % SEQ_MOD
                if 0 < acked <= len(self.unacked):
                    for _ in range(acked):
                        self.unacked.popleft()
                        self.delivered += 1
                    self.base = (self.base + acked) % SEQ_MOD
                    self._stage = 0
                    self._ack_deadline = now + self._ms(
                        self.mac.ack_timeout_ms) + self._rx_ack_lag
            if not self.unacked:
                self.state = GbnState.IDLE


class GbnReceiver:
    """In-order receiver: delivers sequential frames, ACKs cumulatively
    with the next-expected sequence number."""

    def __init__(self, endpoint: AudioEndpoint, cfg: PhyConfig,
                 mac_cfg: MacConfig, local_addr: int, remote_addr: int,
                 sample_rate: int = 48_000, phy=None,
                 device: torch.device | str = "cuda"):
        self.ep = endpoint
        self.cfg = cfg
        self.mac = mac_cfg
        self.local = local_addr
        self.remote = remote_addr
        self.sr = sample_rate
        self.encoder = phy or PhyEncoder(cfg, device=device)
        self.decoder = phy or PhyDecoder(cfg, local_addr, 16, device=device)
        self.expected = 0
        self.received: list[bytes] = []
        self._next_poll = 0
        self._ack_playing = False
        self._ack_due = -1     # sample time to ACK (after burst quiesces)
        self._floor = float('inf')   # leaky-min noise floor
        self.ep.set_state(AppState.RECORDING)

    def _ms(self, ms: float) -> int:
        return int(ms * self.sr / 1000)

    def on_tick(self, now: int) -> None:
        # ACKing mid-burst would go deaf (half duplex) for the rest of
        # the window, so the cumulative ACK waits for a quiet gap.
        if self.ep.state == AppState.PLAYING:
            return
        if self._ack_playing and self.ep.state == AppState.IDLE:
            self._ack_playing = False
            self.ep.clear_record()
            self.ep.set_state(AppState.RECORDING)
            return
        if now < self._next_poll:
            return
        self._next_poll = now + self._ms(5)
        if self.ep.record_len() > 50:
            chunk = self.ep.take_record()
            got_any = False
            for f in self.decoder.process_samples(chunk):
                if f.frame_type != FRAME_TYPE_DATA:
                    continue
                got_any = True
                if f.sequence == self.expected:
                    self.received.append(f.data)
                    self.expected = (self.expected + 1) % SEQ_MOD
                # out-of-order frames dropped; cumulative ACK re-syncs
            if got_any:
                self._ack_due = now + self._ms(25)
            # adaptive burst-activity detection: ACKing mid-burst goes
            # deaf half-duplex (measured livelock when a noisy-channel
            # test raises energy_threshold past the signal amplitude:
            # the fixed |s|>thr check goes blind, the receiver ACKs
            # between burst frames, and the sender never hears it).
            # Track the noise floor as a leaky minimum of chunk RMS and
            # call the medium active while RMS > max(2*floor, 0.05) —
            # on a clean channel this degenerates to the old behavior.
            rms = float(np.sqrt(np.mean(chunk.astype(np.float64) ** 2)))
            # leaky minimum: snap down to quiet-chunk RMS instantly,
            # drift up 0.1%/chunk (never past the current RMS) so a
            # burst of bounded length cannot capture the floor
            self._floor = rms if rms < self._floor else min(
                rms, self._floor * 1.001 + 1e-6)
            active = rms > max(2.0 * self._floor, 0.05)
            if self._ack_due >= 0 and (
                    active or bool(np.any(np.abs(chunk)
                                          > self.mac.energy_threshold))):
                self._ack_due = max(self._ack_due, now + self._ms(25))
        if self._ack_due >= 0 and now >= self._ack_due:
            self._ack_due = -1
            ack = Frame.new_ack(self.expected, self.local, self.remote)
            self.ep.set_playback(self.encoder.encode_frames([ack]))
            self.ep.set_state(AppState.PLAYING)
            self._ack_playing = True


def gbn_transfer(data: bytes, cfg: PhyConfig | None = None,
                 mac_cfg: MacConfig | None = None, window: int = 8,
                 noise_std: float = 0.0, max_duration_s: float = 120.0,
                 seed: int = 0, phy_factory=None,
                 device: torch.device | str = "cuda") -> tuple[bytes, dict]:
    """One-directional Go-Back-N transfer over the simulated bus."""
    cfg = cfg or PhyConfig()
    mac_cfg = mac_cfg or MacConfig()
    bus = SimulatedBus(noise_std=noise_std, seed=seed)
    ep_tx, ep_rx = AudioEndpoint("gbn-tx"), AudioEndpoint("gbn-rx")
    sender = GbnSender(ep_tx, cfg, mac_cfg, 1, 2, window=window,
                          phy=phy_factory(1) if phy_factory else None,
                          device=device)
    receiver = GbnReceiver(ep_rx, cfg, mac_cfg, 2, 1,
                              phy=phy_factory(2) if phy_factory else None,
                              device=device)
    bus.attach(ep_tx, sender)
    bus.attach(ep_rx, receiver)
    chunks = chunk_payload(data, cfg.max_frame_data_size)
    for c in chunks:
        sender.send(c)
    bus.run(int(max_duration_s * bus.sample_rate),
            until=lambda: sender.finished
            and len(receiver.received) >= len(chunks))
    received = b"".join(receiver.received)
    return received, {
        "airtime_s": bus.now / bus.sample_rate,
        "throughput_bps": len(received) * 8 / max(
            bus.now / bus.sample_rate, 1e-9),
        "retransmit_bursts": sender.retransmit_bursts,
        "window": window,
    }
