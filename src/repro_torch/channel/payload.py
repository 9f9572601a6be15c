"""Per-protocol payload accounting (Sec. II-C / III-A), identity codec.

FL : B_up = B_dn = b_mod * N_mod
FD : B_up = B_dn = b_out * N_L^2
FLD-family: B_up = b_out * N_L^2 (+ b_s * N_s on the first round),
            B_dn = b_mod * N_mod

The quantize / delta / dp_gaussian codecs wait for a later slice.
"""
from __future__ import annotations

from typing import NamedTuple

from ..registry import FLD_FAMILY, canonical_protocol

B_MOD = 32  # bits per weight
B_OUT = 32  # bits per output element

def check_codec(codec) -> str:
    """Only the identity codec is ported; others raise."""
    if codec == "identity":
        return codec
    raise NotImplementedError(
        f"codec {codec!r} is not ported yet (ROADMAP A10); the port runs "
        "the identity codec")


class RoundPayload(NamedTuple):
    """Per-device payload bits: first-round uplink, steady uplink,
    downlink."""
    up_first: float
    up_steady: float
    dn: float


def round_payload_bits(protocol: str, *, n_mod: int, n_labels: int,
                       sample_bits: int = 0, n_seed: int = 0,
                       codec="identity") -> RoundPayload:
    proto = canonical_protocol(protocol)
    check_codec(codec)
    out_bits = B_OUT * n_labels * n_labels
    mod_bits = B_MOD * n_mod
    if proto == "fl":
        return RoundPayload(mod_bits, mod_bits, mod_bits)
    if proto == "fd":
        return RoundPayload(out_bits, out_bits, out_bits)
    assert proto in FLD_FAMILY
    # round-1 seed samples ride along with the first soft-label upload
    return RoundPayload(out_bits + sample_bits * n_seed, out_bits,
                        mod_bits)


def round_slot_plan(protocol: str, cfg, *, n_mod: int, n_labels: int,
                    sample_bits: int = 0, n_seed: int = 0,
                    codec="identity") -> dict:
    """Per-slot success probabilities, decode-slot requirements and the
    payload bits they came from, for one (protocol, channel) point."""
    from .model import slots_needed

    p_up, bits_up = cfg.link_budget(True)
    p_dn, bits_dn = cfg.link_budget(False)
    pay = round_payload_bits(protocol, n_mod=n_mod, n_labels=n_labels,
                             sample_bits=sample_bits, n_seed=n_seed,
                             codec=codec)
    return {"p_up": p_up, "p_dn": p_dn,
            "up_slots_first": slots_needed(pay.up_first, bits_up),
            "up_slots": slots_needed(pay.up_steady, bits_up),
            "dn_slots": slots_needed(pay.dn, bits_dn),
            "up_bits_first": pay.up_first, "up_bits": pay.up_steady,
            "dn_bits": pay.dn}
