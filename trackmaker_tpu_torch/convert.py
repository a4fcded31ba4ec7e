"""Moving state between the JAX package and the port.

The system has no weights: its state is the ``PhyConfig`` of the line-coded
PHY, the ``MacConfig`` of the link layer, the ``NetConfig`` of the network
layer, the ``AskConfig`` of the ASK modem and the ``OfdmConfig`` and
``OfdmV2Config`` of the OFDM modems (the pattern and pilot tables follow
from them).  These helpers take plain Python and numpy values, so neither
side imports the other.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np

from trackmaker_tpu_torch.core.config import MacConfig, NetConfig, PhyConfig
from trackmaker_tpu_torch.phy.ask import AskConfig
from trackmaker_tpu_torch.phy.decoder import DecodedFrames
from trackmaker_tpu_torch.phy.ofdm import OfdmConfig
from trackmaker_tpu_torch.phy.ofdm_v2 import OfdmV2Config


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


def frames_to_numpy(frames: DecodedFrames) -> dict[str, np.ndarray]:
    """Every field of `frames` as a numpy array, keyed by field name."""
    return {name: value.detach().cpu().numpy()
            for name, value in frames._asdict().items()}
