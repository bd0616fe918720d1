"""One registration surface for the runtime's pluggable axes.

The runtime grew three parallel plugin registries — local-compute
backends (``register_backend``), ghost-exchange strategies
(``register_exchange``) and reduction class orders (``register_order``)
— with drifting signatures and export points, and the ROADMAP plans a
fourth (``register_ordering`` for vertex orders).  :class:`Registry`
gives them one behavior:

* plain-``dict`` compatibility (``REGISTRY[name]``, ``sorted(REGISTRY)``,
  ``del REGISTRY[name]``) so existing call sites and tests keep working;
* uniform :meth:`register` validation and :meth:`names` introspection —
  the CLI builds its ``--backend`` / ``--exchange`` / ``--reduce-order``
  choices from ``list_*()`` wrappers over :meth:`names` instead of
  hardcoded lists;
* one :meth:`resolve` path covering the name / instance / ``None``
  (default) resolution every ``get_*`` helper previously reimplemented,
  with the same ``ValueError`` texts tests pin.
"""
from __future__ import annotations

from collections.abc import MutableMapping

__all__ = ["Registry"]


class Registry(MutableMapping):
    """A named plugin table: ``name -> entry`` with uniform resolution.

    kind: human label used in error messages ("backend", "exchange", ...).
    entries: initial ``{name: entry}`` mapping.
    instance_of: optional base class — :meth:`resolve` passes instances of
        it straight through (a caller-configured strategy object).
    instantiate: when true, entries are classes and :meth:`resolve` calls
        the looked-up entry to produce a fresh instance; otherwise entries
        are returned as-is (e.g. score functions).
    default: optional name substituted when ``resolve(None)`` is asked.
    """

    def __init__(self, kind: str, entries=None, *, instance_of=None,
                 instantiate: bool = False, default: str | None = None):
        self.kind = kind
        self._entries: dict = dict(entries or {})
        self._instance_of = instance_of
        self._instantiate = instantiate
        self._default = default

    # -- plugin surface ----------------------------------------------------

    def register(self, name: str, entry) -> None:
        """Register ``entry`` under ``name`` (replacing any previous one)."""
        if not isinstance(name, str) or not name:
            raise TypeError(
                f"{self.kind} name must be a non-empty str, got {name!r}")
        if entry is None:
            raise TypeError(f"cannot register None as a {self.kind}")
        self._entries[name] = entry

    def names(self) -> list[str]:
        """Sorted registered names (the CLI-choices introspection surface)."""
        return sorted(self._entries)

    def resolve(self, value):
        """Resolve a name / instance / ``None`` to a usable entry.

        ``None`` resolves to the registry default (when one exists);
        instances of ``instance_of`` pass through untouched; anything
        else is looked up by name — unknown names raise the pinned
        ``ValueError("unknown <kind> ...; registered: [...]")``.
        """
        if value is None and self._default is not None:
            value = self._default
        if self._instance_of is not None and isinstance(value, self._instance_of):
            return value
        try:
            entry = self._entries[value]
        except (KeyError, TypeError):
            raise ValueError(
                f"unknown {self.kind} {value!r}; registered: {self.names()}"
            ) from None
        return entry() if self._instantiate else entry

    # -- MutableMapping (dict compatibility) -------------------------------

    def __getitem__(self, name):
        return self._entries[name]

    def __setitem__(self, name, entry):
        self.register(name, entry)

    def __delitem__(self, name):
        del self._entries[name]

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)

    def __repr__(self):
        return f"Registry({self.kind!r}, {self.names()})"
