"""Moving state between the JAX package and the port.

The system has no weights: its state is the ``PhyConfig`` of the line-coded
PHY, the ``MacConfig`` of the link layer, the ``NetConfig`` of the network
layer, the ``AskConfig`` of the ASK modem, the ``OfdmConfig``,
``OfdmV2Config`` and ``OfdmAdaptiveConfig`` of the OFDM modems (an
adaptive config carries its loading and gains) and the ``FskConfig`` and
``PskConfig`` of the single-carrier modems (the pattern and pilot tables
follow from them).  These helpers take plain Python and numpy values, so neither
side imports the other.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np

from trackmaker_tpu_torch.core.config import MacConfig, NetConfig, PhyConfig
from trackmaker_tpu_torch.phy.ask import AskConfig
from trackmaker_tpu_torch.phy.decoder import DecodedFrames
from trackmaker_tpu_torch.phy.fsk import FskConfig
from trackmaker_tpu_torch.phy.ofdm import OfdmConfig
from trackmaker_tpu_torch.phy.ofdm_adaptive import OfdmAdaptiveConfig
from trackmaker_tpu_torch.phy.ofdm_v2 import OfdmV2Config
from trackmaker_tpu_torch.phy.psk import PskConfig


def _config_from_fields(cls, fields: Mapping):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(fields) - names
    if unknown:
        raise KeyError(f"{cls.__name__} has no fields {sorted(unknown)}")
    return cls(**dict(fields))


def phy_config_from_fields(fields: Mapping) -> PhyConfig:
    """The port's PhyConfig from ``dataclasses.asdict`` of the JAX one, or
    any mapping of the same fields; a field the port lacks raises."""
    return _config_from_fields(PhyConfig, fields)


def mac_config_from_fields(fields: Mapping) -> MacConfig:
    """The port's MacConfig from ``dataclasses.asdict`` of the JAX one, or
    any mapping of the same fields; a field the port lacks raises."""
    return _config_from_fields(MacConfig, fields)


def net_config_from_fields(fields: Mapping) -> NetConfig:
    """The port's NetConfig from ``dataclasses.asdict`` of the JAX one, or
    any mapping of the same fields; a field the port lacks raises."""
    return _config_from_fields(NetConfig, fields)


def ask_config_from_fields(fields: Mapping) -> AskConfig:
    """The port's AskConfig from ``dataclasses.asdict`` of the JAX one, or
    any mapping of the same fields; a field the port lacks raises."""
    return _config_from_fields(AskConfig, fields)


def ofdm_config_from_fields(fields: Mapping) -> OfdmConfig:
    """The port's OfdmConfig from ``dataclasses.asdict`` of the JAX one, or
    any mapping of the same fields; a field the port lacks raises."""
    return _config_from_fields(OfdmConfig, fields)


def ofdm_v2_config_from_fields(fields: Mapping) -> OfdmV2Config:
    """The port's OfdmV2Config from ``dataclasses.asdict`` of the JAX one,
    or any mapping of the same fields; a field the port lacks raises."""
    return _config_from_fields(OfdmV2Config, fields)


def ofdm_adaptive_config_from_fields(fields: Mapping) -> OfdmAdaptiveConfig:
    """The port's OfdmAdaptiveConfig from ``dataclasses.asdict`` of the JAX
    one, or any mapping of the same fields, its loading and gains as tuples
    (the config stays hashable); a field the port lacks raises."""
    fields = dict(fields)
    for name in ("loading", "gains"):
        if name in fields:
            fields[name] = tuple(fields[name])
    return _config_from_fields(OfdmAdaptiveConfig, fields)


def fsk_config_from_fields(fields: Mapping) -> FskConfig:
    """The port's FskConfig from ``dataclasses.asdict`` of the JAX one, or
    any mapping of the same fields; a field the port lacks raises."""
    return _config_from_fields(FskConfig, fields)


def psk_config_from_fields(fields: Mapping) -> PskConfig:
    """The port's PskConfig from ``dataclasses.asdict`` of the JAX one, or
    any mapping of the same fields; a field the port lacks raises."""
    return _config_from_fields(PskConfig, fields)


def frames_to_numpy(frames: DecodedFrames) -> dict[str, np.ndarray]:
    """Every field of `frames` as a numpy array, keyed by field name."""
    return {name: value.detach().cpu().numpy()
            for name, value in frames._asdict().items()}
