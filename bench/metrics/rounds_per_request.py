"""Conflict rounds (`LocalBackend.round`, `core/conflict.py`): rounds
after the first (`ColoringResult.rounds`), mean over the traced window."""


def read(record):
    rounds = record.get("rounds")
    return sum(rounds) / len(rounds) if rounds else None
