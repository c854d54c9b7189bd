"""Dataset and metadata catalogs (d2 ``DatasetCatalog`` / ``MetadataCatalog``
equivalents): lazy registries of name -> loader function and name ->
metadata dict.  This package's own copy of ``ttdg_mgm_tpu/data/catalog.py``."""

from __future__ import annotations

from typing import Callable


class _DatasetCatalog:
    def __init__(self):
        self._registry: dict[str, Callable] = {}

    def register(self, name: str, fn: Callable):
        if name in self._registry:
            raise KeyError(f"dataset '{name}' already registered")
        self._registry[name] = fn

    def get(self, name: str):
        if name not in self._registry:
            raise KeyError(
                f"dataset '{name}' not registered; available: {sorted(self._registry)}")
        return self._registry[name]()

    def list(self):
        return sorted(self._registry)

    def remove(self, name: str):
        self._registry.pop(name, None)


class _MetadataCatalog:
    def __init__(self):
        self._meta: dict[str, dict] = {}

    def get(self, name: str) -> dict:
        return self._meta.setdefault(name, {"name": name})


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
