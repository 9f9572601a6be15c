"""Wireless channel (Sec. II-C): Rayleigh block fading, SNR-threshold
decoding, FDMA uplink / multicast downlink, latency and outage — plus the
link pipeline every device<->server transfer routes through.  The
protocol layer reaches the channel through ``channel.pipeline`` only."""
from .model import (ChannelConfig, compute_outcomes,  # noqa: F401
                    link_outcomes, round_trip, round_trip_traced,
                    simulate_link, slots_needed, slowest_ok_time)
from .payload import (CODECS, CodecSpec, RoundPayload,  # noqa: F401
                      parse_codec, payload_bits, round_payload_bits,
                      round_slot_plan)
from .pipeline import (LinkPlan, channel_stage, downlink_gout,  # noqa: F401
                       downlink_params, make_uplink_stage, uplink_stage)
