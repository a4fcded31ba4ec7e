"""Shared-medium discrete-time simulator (counterpart of ``trackmaker_tpu/link/bus.py``).

A host NumPy copy of the JAX package's module, noise generator included
(``np.random.default_rng(seed)``), so the nodes hear the same samples.
The medium is explicit: every chunk
(default 128 samples ~ a JACK period), each endpoint's playback output is
mixed into what every *other* endpoint records (half-duplex, like the
reference's record/playback states), optionally through per-link gain and
AWGN.  Node state machines are ticked after audio delivery with a
sample-accurate clock.
"""

from __future__ import annotations

import numpy as np


class SimulatedBus:
    def __init__(self, sample_rate: int = 48_000, chunk: int = 128,
                 noise_std: float = 0.0, seed: int = 0,
                 self_hearing: bool = False):
        self.sample_rate = sample_rate
        self.chunk = chunk
        self.noise_std = noise_std
        self.self_hearing = self_hearing
        self.rng = np.random.default_rng(seed)
        self.now = 0  # samples
        self._endpoints = []
        self._nodes = []
        self._gains: dict[tuple[int, int], float] = {}

    def attach(self, endpoint, node=None) -> int:
        self._endpoints.append(endpoint)
        self._nodes.append(node)
        return len(self._endpoints) - 1

    def set_gain(self, src_idx: int, dst_idx: int, gain: float) -> None:
        self._gains[(src_idx, dst_idx)] = gain

    def _gain(self, i: int, j: int) -> float:
        return self._gains.get((i, j), 1.0)

    def step(self) -> None:
        outs = [ep.pull_playback(self.chunk) for ep in self._endpoints]
        for j, ep in enumerate(self._endpoints):
            mix = np.zeros(self.chunk, np.float32)
            for i, out in enumerate(outs):
                if i == j and not self.self_hearing:
                    continue
                g = self._gain(i, j)
                if g != 0.0:
                    mix += g * out
            if self.noise_std > 0.0:
                mix += self.rng.normal(
                    0, self.noise_std, self.chunk).astype(np.float32)
            ep.push_record(mix)
        self.now += self.chunk
        for node in self._nodes:
            if node is not None:
                node.on_tick(self.now)

    def run(self, duration_samples: int,
            until=None) -> None:
        end = self.now + duration_samples
        while self.now < end:
            self.step()
            if until is not None and until():
                return

    def ms(self, milliseconds: float) -> int:
        return int(milliseconds * self.sample_rate / 1000)
