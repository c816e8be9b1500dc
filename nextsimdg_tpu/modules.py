"""Runtime-selectable module registry.

Re-design of the reference ``ModuleLoader`` singleton
(``core/src/ModuleLoader.cpp:23-61``, ``core/src/include/ModuleLoader.hpp``)
and its Python code generator (``core/src/modules/moduleloader_builder.py``).

Instead of build-time codegen producing static C++ instances, implementations
register themselves with a decorator at import time. The registry keeps the
reference's observable contract:

* interfaces and implementations are addressed by *string* names — the same
  names as the reference (``Nextsim::IIceAlbedo`` → ``Nextsim::CCSMIceAlbedo``
  …) so existing config files keep working;
* the default implementation is the first one registered
  (``ModuleLoader.cpp:56-61``);
* ``get_implementation`` returns a per-interface "static" (cached) instance of
  the selected implementation; ``get_instance`` returns a fresh one
  (``ModuleLoader.hpp:49-84``);
* selecting an unknown implementation raises (``std::domain_error`` in the
  reference, ``ModuleError`` here).

Because the selected implementations are resolved *before* tracing, the
physics step seen by ``jax.jit`` is a static call graph: changing a module
selection produces a different traced program (and a re-jit), never a
data-dependent branch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List


class ModuleError(ValueError):
    """Unknown module interface or implementation (cf. std::domain_error)."""


class ModuleRegistry:
    """Singleton registry of interface -> {implementation name -> factory}."""

    _instance: "ModuleRegistry" = None

    def __init__(self) -> None:
        self._factories: Dict[str, Dict[str, Callable[[], Any]]] = {}
        self._order: Dict[str, List[str]] = {}
        self._selected: Dict[str, str] = {}
        self._static_instances: Dict[str, Any] = {}

    @classmethod
    def get_loader(cls) -> "ModuleRegistry":
        if cls._instance is None:
            cls._instance = ModuleRegistry()
        return cls._instance

    # -- registration --------------------------------------------------------
    def register(self, interface: str, name: str, factory: Callable[[], Any]) -> None:
        impls = self._factories.setdefault(interface, {})
        if name not in impls:
            self._order.setdefault(interface, []).append(name)
        impls[name] = factory

    # -- introspection -------------------------------------------------------
    def list_modules(self) -> List[str]:
        return list(self._factories)

    def list_implementations(self, interface: str) -> List[str]:
        if interface not in self._factories:
            raise ModuleError(f"unknown module interface: {interface}")
        return list(self._order[interface])

    def selected_name(self, interface: str) -> str:
        if interface not in self._selected:
            self.set_default(interface)
        return self._selected[interface]

    # -- selection -----------------------------------------------------------
    def set_implementation(self, interface: str, name: str) -> None:
        if interface not in self._factories:
            raise ModuleError(f"unknown module interface: {interface}")
        if name not in self._factories[interface]:
            raise ModuleError(
                f"{name} is not an implementation of the module {interface}"
            )
        self._selected[interface] = name
        self._static_instances.pop(interface, None)

    def set_default(self, interface: str) -> None:
        """Select the first-registered implementation (the default)."""
        first = self._order[interface][0]
        self.set_implementation(interface, first)

    def set_all_defaults(self) -> None:
        for interface in self._factories:
            self.set_default(interface)

    # -- retrieval -----------------------------------------------------------
    def get_implementation(self, interface: str) -> Any:
        """Return the cached ("static") instance of the selected impl."""
        if interface not in self._factories:
            raise ModuleError(f"unknown module interface: {interface}")
        if interface not in self._selected:
            self.set_default(interface)
        if interface not in self._static_instances:
            name = self._selected[interface]
            self._static_instances[interface] = self._factories[interface][name]()
        return self._static_instances[interface]

    def get_instance(self, interface: str) -> Any:
        """Return a fresh instance of the selected implementation."""
        if interface not in self._factories:
            raise ModuleError(f"unknown module interface: {interface}")
        if interface not in self._selected:
            self.set_default(interface)
        name = self._selected[interface]
        return self._factories[interface][name]()

    # -- test helpers --------------------------------------------------------
    def reset(self) -> None:
        """Drop all selections and cached instances (not registrations)."""
        self._selected = {}
        self._static_instances = {}


def register_implementation(interface: str, name: str):
    """Class/function decorator registering an implementation factory.

    The decorated object is used as the factory: a class is instantiated,
    anything else is returned as-is.
    """

    def wrap(factory):
        loader = ModuleRegistry.get_loader()
        if isinstance(factory, type):
            loader.register(interface, name, factory)
        else:
            loader.register(interface, name, lambda: factory)
        return factory

    return wrap


def get_loader() -> ModuleRegistry:
    """Convenience accessor mirroring ``ModuleLoader::getLoader()``."""
    return ModuleRegistry.get_loader()
