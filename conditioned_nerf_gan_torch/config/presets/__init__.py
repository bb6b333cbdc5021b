"""Preset curriculum packages (`--config_base <name>` resolves here)."""

ALIASES = {
    # Renamed siren classes still referenced by experiment configs
    # (reference configs/thousand/direct_volume/dg.py:8,51,55 vs the actual
    # classes at siren.py:491/583/744) — resolved deliberately per SURVEY §2.3.
    "TALLSIREN_dg": "TALLSIREN_FG",
    "SHORTSIREN_dg": "SHORTSIREN_FG",
    "DoubleSIREN_dg": "DOUBLESIREN_FG",
}


def resolve_siren_alias(name: str) -> str:
    return ALIASES.get(name, name)
