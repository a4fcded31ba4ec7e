"""The MAC's stream PHYs over the single-carrier modems (counterpart of
``trackmaker_tpu/phy/stream_sc.py``): FSK and PSK expose the duck type of
``phy.ofdm.OfdmStreamPhy`` (``encode_frames`` / ``process_samples`` /
``reset`` / ``frame_samples``), so CSMA, Go-Back-N, Selective-Repeat and
the network layer run over them unchanged.

``process_samples`` keeps its buffer on the host.  Each call that holds
more than a preamble copies the buffer, zero-padded to a power-of-two
bucket, to the PHY's device once (the card unless the caller asks for
another), finds the chirps there (``decode_calls`` counts the buckets),
demodulates a largest frame at each start and keeps exactly (7 + len)·8
bits of it.
"""

from __future__ import annotations

import numpy as np
import torch

from trackmaker_tpu_torch.core.config import PHY_HEADER_BYTES
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.phy import fsk, psk
from trackmaker_tpu_torch.phy.ofdm import _bucket, _join, find_preambles

_MAX_BUF_S = 10  # seconds of quiet buffer before trimming


class _SingleCarrierStreamPhy:
    """The streaming skeleton over a waveform's modulator and demodulator."""

    def __init__(self, cfg, max_frame_bytes: int = 263, local_addr: int | None = None,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.max_frame_bytes = max_frame_bytes
        self.local_addr = local_addr
        self.preamble_len = cfg.preamble_len
        self.device = torch.device(device)
        self._buf = np.zeros(0, np.float32)
        self.decode_calls = 0

    # -- waveform hooks (subclass) -----------------------------------------------------

    def _modulate(self, bits: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _demodulate_at(self, pj: torch.Tensor, n_bits: int, start: torch.Tensor) -> np.ndarray:
        raise NotImplementedError

    def _samples_for_bits(self, n_bits: int) -> int:
        """Body samples for n_bits (preamble and guard excluded)."""
        raise NotImplementedError

    # -- encoder side ------------------------------------------------------------------

    def frame_samples(self, n_payload: int) -> int:
        n_bits = (PHY_HEADER_BYTES + n_payload) * 8
        return self.cfg.preamble_len + self.cfg.guard_samples + self._samples_for_bits(n_bits)

    def encode_frame(self, frame: Frame) -> np.ndarray:
        bits = torch.from_numpy(frame.to_bits()).to(self.device)
        return self._modulate(bits[None])[0].cpu().numpy()

    def encode_frames(self, frames: list[Frame], gap_samples: int = 256) -> np.ndarray:
        return _join([self.encode_frame(f) for f in frames], gap_samples)

    # -- streaming decoder side --------------------------------------------------------

    def reset(self) -> None:
        self._buf = np.zeros(0, np.float32)

    def _starts(self, pj: torch.Tensor) -> torch.Tensor:
        """The chirp starts int32[16] (-1 padded) of a padded bucket on the
        device."""
        self.decode_calls += 1
        return find_preambles(fsk.sync_config(self.cfg), pj, 16)

    def process_samples(self, samples: np.ndarray) -> list[Frame]:
        self._buf = np.concatenate([self._buf, np.asarray(samples, np.float32)])
        cfg = self.cfg
        if len(self._buf) < cfg.preamble_len + 1:
            return []
        out: list[Frame] = []
        consumed = 0
        padded = np.zeros(_bucket(len(self._buf)), np.float32)
        padded[: len(self._buf)] = self._buf
        pj = torch.from_numpy(padded).to(self.device)
        starts_dev = self._starts(pj)
        starts = starts_dev.cpu().numpy()
        max_bits = self.max_frame_bytes * 8
        body_off = cfg.preamble_len + cfg.guard_samples
        for i in np.flatnonzero(starts >= 0):
            s = int(starts[i])
            if s < consumed:
                continue
            if s + body_off + self._samples_for_bits(56) > len(self._buf):
                break  # header still arriving
            bits = self._demodulate_at(pj, max_bits, starts_dev[i:i + 1])
            hdr = np.packbits(bits[:56])
            data_len = (int(hdr[0]) << 8) | int(hdr[1])
            if data_len > self.max_frame_bytes - PHY_HEADER_BYTES:
                consumed = s + cfg.preamble_len
                continue
            total_bits = (PHY_HEADER_BYTES + data_len) * 8
            frame_end = s + body_off + self._samples_for_bits(total_bits)
            if frame_end > len(self._buf):
                break  # wait for the rest of this frame
            f = Frame.from_bits(bits[:total_bits])
            consumed = frame_end
            if f is None:
                continue
            if self.local_addr is not None and f.dst != self.local_addr:
                continue
            out.append(f)
        if consumed:
            keep = max(consumed - (cfg.preamble_len - 1), 0)
            self._buf = self._buf[keep:]
        elif len(self._buf) > _MAX_BUF_S * cfg.sample_rate:
            self._buf = self._buf[-cfg.preamble_len:]
        return out


class FskStreamPhy(_SingleCarrierStreamPhy):
    """Noncoherent binary-FSK stream PHY (``phy/fsk.py``'s waveform)."""

    def __init__(self, cfg: fsk.FskConfig | None = None, max_frame_bytes: int = 263,
                 local_addr: int | None = None, device: torch.device | str = "cuda"):
        super().__init__(cfg or fsk.FskConfig(), max_frame_bytes, local_addr, device)

    def _modulate(self, bits):
        return fsk.modulate_bits(self.cfg, bits)

    def _demodulate_at(self, pj, n_bits, start):
        return fsk.demodulate_at(self.cfg, pj, n_bits, start)[0].cpu().numpy()

    def _samples_for_bits(self, n_bits):
        return n_bits * self.cfg.samples_per_bit


class PskStreamPhy(_SingleCarrierStreamPhy):
    """Pilot-aided coherent BPSK/QPSK stream PHY (``phy/psk.py``'s waveform)."""

    def __init__(self, cfg: psk.PskConfig | None = None, max_frame_bytes: int = 263,
                 local_addr: int | None = None, device: torch.device | str = "cuda"):
        super().__init__(cfg or psk.PskConfig(), max_frame_bytes, local_addr, device)

    def _modulate(self, bits):
        return psk.modulate_bits(self.cfg, bits, bits.shape[-1])

    def _demodulate_at(self, pj, n_bits, start):
        return psk.demodulate_at(self.cfg, pj, n_bits, start)[0].cpu().numpy()

    def _samples_for_bits(self, n_bits):
        n_sym = self.cfg.pilot_symbols + -(-n_bits // self.cfg.bits_per_symbol)
        return n_sym * self.cfg.samples_per_symbol
