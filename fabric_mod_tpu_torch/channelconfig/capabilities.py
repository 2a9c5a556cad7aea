"""Capability levels: feature gating from channel config.

The port's copy of fabric_mod_tpu/channelconfig/capabilities.py
(reference: common/capabilities — application.go:163 /channel.go:
typed accessors over the Capabilities config values, deciding which
protocol features a channel may use.)
"""
from __future__ import annotations

from typing import Sequence

V2_0 = "V2_0"
V2_5 = "V2_5"


class ApplicationCapabilities:
    """(reference: capabilities/application.go)"""

    def __init__(self, names: Sequence[str]):
        self._names = set(names)

    _ORDER = (V2_0, V2_5)

    def _at_least(self, level: str) -> bool:
        return any(n in self._names
                   for n in self._ORDER[self._ORDER.index(level):])

    def key_level_endorsement(self) -> bool:
        return self._at_least(V2_0)

    def lifecycle_v20(self) -> bool:
        return self._at_least(V2_0)

    def storage_pvtdata(self) -> bool:
        return self._at_least(V2_0)

    def supported(self) -> bool:
        """Are all declared capabilities ones we implement?
        (reference: the Supported() gate rejecting unknown levels)"""
        return self._names.issubset({V2_0, V2_5})


class ChannelCapabilities:
    def __init__(self, names: Sequence[str]):
        self._names = set(names)

    def supported(self) -> bool:
        return self._names.issubset({V2_0, V2_5})
