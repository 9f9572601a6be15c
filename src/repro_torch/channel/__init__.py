"""Wireless channel (Sec. II-C): Rayleigh block fading, SNR-threshold
decoding, FDMA uplink / multicast downlink, latency and outage — plus the
link pipeline every device<->server transfer routes through.  The
protocol layer reaches the channel through ``channel.pipeline`` only."""
from .model import ChannelConfig  # noqa: F401
from .pipeline import (LinkPlan, downlink_gout,  # noqa: F401
                       downlink_params, make_uplink_stage)
