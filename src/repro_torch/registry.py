"""The protocol name registry (counterpart of ``repro/registry.py``).

``canonical_protocol`` is the single gate for protocol names: every
registered spelling works, unknown names raise one shared ValueError.
The model and task registries wait for later slices of the port.
"""
from __future__ import annotations

#: Canonical protocol names, in the paper's presentation order.
PROTOCOLS = ("fl", "fd", "fld", "mixfld", "mix2fld")

#: Alternate spellings -> canonical name ("mix2fd" is the one-way-Mixup
#: FLD variant, "mixfld" in the paper's tables).
PROTOCOL_ALIASES = {"mix2fd": "mixfld"}

#: Protocols that upload (mixed) seed samples on the first round and run
#: the eq. (5) output-to-model conversion server-side.
FLD_FAMILY = ("fld", "mixfld", "mix2fld")


def canonical_protocol(name: str) -> str:
    """Resolve ``name`` (canonical or alias) to its canonical protocol
    name; unknown names raise the shared ValueError."""
    if name in PROTOCOLS:
        return name
    alias = PROTOCOL_ALIASES.get(name)
    if alias is not None:
        return alias
    raise ValueError(
        f"unknown protocol {name!r}; one of {PROTOCOLS} "
        f"(aliases: {PROTOCOL_ALIASES})")
