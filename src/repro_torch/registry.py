"""The name registries (counterpart of ``repro/registry.py``): one source
of truth for protocol, model and task names.

``canonical_protocol``, ``canonical_model`` and ``canonical_task`` are the
single gates for their names: every registered spelling works, unknown
names raise one shared ValueError listing the registered set.
Construction lives in ``models/registry.py`` and ``data/pipeline.py``.
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

#: Canonical single-architecture model names; composite specs join them
#: with "+" (``models/registry.py::parse_model``).
MODELS = ("cnn", "mlp", "transformer")

MODEL_ALIASES = {"conv": "cnn", "paper_cnn": "cnn", "tf": "transformer"}

#: Canonical task names: synthetic workloads with a real dataset's
#: shape, class count and payload width (28x28x1 digits, 32x32x3
#: CIFAR-shaped images, 32x40 speech-commands-shaped log-mel grams).
TASKS = ("digits", "cifar", "speech")

TASK_ALIASES = {"mnist": "digits", "cifar10": "cifar",
                "speech_commands": "speech"}


def _canonical(kind: str, name: str, names: tuple, aliases: dict) -> str:
    if name in names:
        return name
    alias = aliases.get(name)
    if alias is not None:
        return alias
    raise ValueError(f"unknown {kind} {name!r}; one of {names} "
                     f"(aliases: {aliases})")


def canonical_protocol(name: str) -> str:
    """Resolve ``name`` (canonical or alias) to its canonical protocol
    name; unknown names raise the shared ValueError."""
    return _canonical("protocol", name, PROTOCOLS, PROTOCOL_ALIASES)


def canonical_model(name: str) -> str:
    """Resolve one architecture name (canonical or alias); composite
    "+"-joined specs go through ``models/registry.py::parse_model``."""
    return _canonical("model", name, MODELS, MODEL_ALIASES)


def canonical_task(name: str) -> str:
    """Resolve a task name (canonical or alias)."""
    return _canonical("task", name, TASKS, TASK_ALIASES)
