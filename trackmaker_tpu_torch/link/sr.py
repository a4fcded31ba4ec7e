"""Selective-Repeat sliding-window ARQ (counterpart of ``trackmaker_tpu/link/sr.py``).

Go-Back-N (:mod:`trackmaker_tpu_torch.link.gbn`) retransmits the whole
remaining window when anything is lost; on a channel whose losses are
independent per frame (the measured regime: AWGN frame loss with a CRC
gate, docs/BENCHMARKS.md "PHY robustness") that wastes airtime linear
in the window size.  Selective repeat retransmits ONLY the frames the
receiver is missing.

Wire format stays inside the reference frame codec
(src/phy/frame.rs:33-41): a SACK is an ACK frame whose ``sequence`` is
the cumulative next-expected number (so a plain Go-Back-N sender could
interoperate) and whose *data* bytes are a bitmap of out-of-order
frames already held beyond it (bit k of byte k//8, MSB-first, marks
``sequence + 1 + k``).

Same tick-driven half-duplex discipline as gbn.py: window bursts are
encoded as one batched waveform, the receiver ACKs in quiet gaps, and
the retransmit burst carries only the un-SACKed frames.
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
SACK_BYTES = 8          # bitmap covers 64 frames past the cumulative ACK


def encode_sack(expected: int, have: set[int], local: int,
                remote: int) -> Frame:
    """Cumulative next-expected + bitmap of buffered out-of-order seqs."""
    bitmap = bytearray(SACK_BYTES)
    for s in have:
        k = (s - expected - 1) % SEQ_MOD
        if k < SACK_BYTES * 8:
            bitmap[k // 8] |= 0x80 >> (k % 8)
    return Frame.new_ack(expected, local, remote, bytes(bitmap))


def decode_sack(f: Frame) -> tuple[int, set[int]]:
    """-> (next expected, set of seqs held beyond it)."""
    have = set()
    for i, byte in enumerate(f.data[:SACK_BYTES]):
        for b in range(8):
            if byte & (0x80 >> b):
                have.add((f.sequence + 1 + i * 8 + b) % SEQ_MOD)
    return f.sequence, have


class SrState(enum.Enum):
    IDLE = 0
    SENSING = 1
    TRANSMITTING = 2
    WAITING = 3


class SrSender:
    """Window sender retransmitting only un-SACKed frames."""

    def __init__(self, endpoint: AudioEndpoint, cfg: PhyConfig,
                 mac_cfg: MacConfig, local_addr: int, remote_addr: int,
                 window: int = 8, sample_rate: int = 48_000,
                 seed: int = 0, phy=None,
                 device: torch.device | str = "cuda"):
        assert window < SEQ_MOD // 2 and window <= SACK_BYTES * 8
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
        self.base = 0                       # oldest unacked seq
        self.next_seq = 0
        self.unacked: dict[int, Frame] = {}  # seq -> frame
        self.acked: set[int] = set()         # SACKed inside the window
        self.state = SrState.IDLE
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
        self.frames_retransmitted = 0

    def send(self, payload: bytes) -> None:
        self.queue.append(bytes(payload))

    @property
    def finished(self) -> bool:
        return not self.queue and not self.unacked \
            and self.state in (SrState.IDLE,)

    def _ms(self, ms: float) -> int:
        return int(ms * self.sr / 1000)

    def _fill_window(self) -> None:
        while len(self.unacked) < self.window and self.queue:
            f = Frame.new_data(self.next_seq, self.local, self.remote,
                               self.queue.popleft())
            self.unacked[self.next_seq] = f
            self.next_seq = (self.next_seq + 1) % SEQ_MOD

    def _pending_burst(self) -> list[Frame]:
        """Un-SACKed window frames in sequence order from base."""
        out = []
        s = self.base
        for _ in range(self.window):
            if s in self.unacked and s not in self.acked:
                out.append(self.unacked[s])
            s = (s + 1) % SEQ_MOD
        return out

    def on_tick(self, now: int) -> None:
        if self.state == SrState.IDLE:
            self._fill_window()
            if self.unacked:
                self.state = SrState.SENSING
                self.ep.set_state(AppState.RECORDING)
                self._deadline = 0
            return
        if now < self._deadline:
            return

        if self.state == SrState.SENSING:
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
            burst = self._pending_burst()
            if not burst:
                self.state = SrState.IDLE
                return
            track = self.encoder.encode_frames(burst)
            self.ep.set_playback(track)
            self.ep.clear_record()
            self.ep.set_state(AppState.PLAYING)
            self.state = SrState.TRANSMITTING

        elif self.state == SrState.TRANSMITTING:
            if self.ep.state == AppState.IDLE:
                self.ep.set_state(AppState.RECORDING)
                self.decoder.reset()
                self.state = SrState.WAITING
                self._ack_deadline = now + self._ms(
                    self.mac.ack_timeout_ms) + self._rx_ack_lag
                self._next_poll = now + self._ms(5)

        elif self.state == SrState.WAITING:
            if now >= self._ack_deadline:
                self.retransmit_bursts += 1
                self._stage += 1
                cw = min(self.mac.cw_min * 2 * self._stage, self.mac.cw_max)
                self._deadline = now + self._rng.randint(0, cw) * self._ms(
                    self.mac.slot_time_ms)
                self.frames_retransmitted += len(self._pending_burst())
                self.state = SrState.SENSING
                return
            if now < self._next_poll:
                return
            self._next_poll = now + self._ms(5)
            new = self.ep.take_record()
            if not len(new):
                return
            got_ack = False
            for f in self.decoder.process_samples(new):
                if f.frame_type != FRAME_TYPE_ACK:
                    continue
                expected, have = decode_sack(f)
                adv = (expected - self.base) % SEQ_MOD
                if adv > len(self.unacked):
                    continue            # stale/garbled ACK
                got_ack = True
                self._stage = 0
                for _ in range(adv):
                    self.unacked.pop(self.base, None)
                    self.acked.discard(self.base)
                    self.base = (self.base + 1) % SEQ_MOD
                    self.delivered += 1
                for s in have:
                    if s in self.unacked:
                        self.acked.add(s)
                self._ack_deadline = now + self._ms(
                    self.mac.ack_timeout_ms) + self._rx_ack_lag
            if not self.unacked:
                self.state = SrState.IDLE
            elif got_ack:
                # receiver reported holes: retransmit just those (the
                # hole count, before the window refills with new frames)
                holes = self._pending_burst()
                if holes:
                    self.frames_retransmitted += len(holes)
                    self.retransmit_bursts += 1
                    self._fill_window()
                    self.state = SrState.SENSING


class SrReceiver:
    """Buffers out-of-order frames inside the window; delivers in order;
    SACKs cumulatively + bitmap after the burst quiesces."""

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
        self.buffer: dict[int, bytes] = {}
        self.received: list[bytes] = []
        self._next_poll = 0
        self._ack_playing = False
        self._ack_due = -1
        self._floor = float('inf')   # leaky-min noise floor
        self.ep.set_state(AppState.RECORDING)

    def _ms(self, ms: float) -> int:
        return int(ms * self.sr / 1000)

    def _in_window(self, seq: int) -> bool:
        return (seq - self.expected) % SEQ_MOD < SACK_BYTES * 8 + 1

    def on_tick(self, now: int) -> None:
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
                    while self.expected in self.buffer:
                        self.received.append(self.buffer.pop(self.expected))
                        self.expected = (self.expected + 1) % SEQ_MOD
                elif self._in_window(f.sequence):
                    self.buffer.setdefault(f.sequence, f.data)
                # frames behind `expected` are duplicates: SACK re-syncs
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
            ack = encode_sack(self.expected, set(self.buffer),
                              self.local, self.remote)
            self.ep.set_playback(self.encoder.encode_frames([ack]))
            self.ep.set_state(AppState.PLAYING)
            self._ack_playing = True


def sr_transfer(data: bytes, cfg: PhyConfig | None = None,
                mac_cfg: MacConfig | None = None, window: int = 8,
                noise_std: float = 0.0, max_duration_s: float = 120.0,
                seed: int = 0, phy_factory=None,
                device: torch.device | str = "cuda") -> tuple[bytes, dict]:
    """One-directional Selective-Repeat transfer over the simulated bus."""
    cfg = cfg or PhyConfig()
    mac_cfg = mac_cfg or MacConfig()
    bus = SimulatedBus(noise_std=noise_std, seed=seed)
    ep_tx, ep_rx = AudioEndpoint("sr-tx"), AudioEndpoint("sr-rx")
    sender = SrSender(ep_tx, cfg, mac_cfg, 1, 2, window=window,
                          phy=phy_factory(1) if phy_factory else None,
                          device=device)
    receiver = SrReceiver(ep_rx, cfg, mac_cfg, 2, 1,
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
        "frames_retransmitted": sender.frames_retransmitted,
        "window": window,
    }
