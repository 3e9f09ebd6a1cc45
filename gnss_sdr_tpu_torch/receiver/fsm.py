"""Per-channel state machine.

Mirrors ``ChannelFsm``'s three states and events
(gnss-sdr/src/algorithms/channel/libs/channel_fsm.cc:44-217):
0 standby, 1 acquisition, 2 tracking; events valid_acquisition,
failed_acquisition, loss_of_lock (failed_tracking), stop.

Copied from ``gnss_sdr_tpu/receiver/fsm.py``; only the import paths differ.
"""

from __future__ import annotations

import enum


class ChannelState(enum.Enum):
    STANDBY = 0
    ACQUISITION = 1
    TRACKING = 2


class ChannelFsm:
    """Tiny explicit FSM; transitions return True when accepted."""

    def __init__(self, channel_id: int):
        self.channel_id = channel_id
        self.state = ChannelState.STANDBY
        self.prn = 0

    def start_acquisition(self, prn: int) -> bool:
        if self.state is ChannelState.TRACKING:
            return False
        self.prn = prn
        self.state = ChannelState.ACQUISITION
        return True

    def valid_acquisition(self) -> bool:
        if self.state is not ChannelState.ACQUISITION:
            return False
        self.state = ChannelState.TRACKING
        return True

    def failed_acquisition(self) -> None:
        # stay in ACQUISITION; the manager may swap the satellite
        self.prn = 0 if self.state is ChannelState.ACQUISITION else self.prn

    def loss_of_lock(self) -> int:
        """Tracking failure; returns the released PRN."""
        prn = self.prn
        self.state = ChannelState.ACQUISITION
        self.prn = 0
        return prn

    def stop(self) -> int:
        prn = self.prn
        self.state = ChannelState.STANDBY
        self.prn = 0
        return prn
