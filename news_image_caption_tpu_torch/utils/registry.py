"""String-keyed registries for pluggable components.

A copy of `news_image_caption_tpu/utils/registry.py` (the reference's
stand-in for AllenNLP's `Registrable`): every pluggable piece registers
under a string name so that a YAML config selects it by `type`.
`config.py::build_model` resolves `model.type` and `decoder.type`
through `MODELS` and `DECODERS`, `build_dataset` resolves `dataset.type`
through `DATASETS`; the port's models, decoders and datasets register
under the reference's names where they are defined. A builder takes the
port's keywords `device`, `dtype` and `generator` beside its config
keys (see `build_model`). `tests/test_torch_profiling_loaders.py` holds
the copy equal to the reference's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Generic, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    """A named registry mapping string keys to factories/classes."""

    _registries: Dict[str, "Registry"] = {}

    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, T] = {}
        Registry._registries[name] = self

    @classmethod
    def get_registry(cls, name: str) -> "Registry":
        if name not in cls._registries:
            Registry(name)
        return cls._registries[name]

    def register(self, key: str, overwrite: bool = False) -> Callable[[T], T]:
        def deco(obj: T) -> T:
            if key in self._entries and not overwrite:
                raise KeyError(f"{key!r} already registered in {self.name!r}")
            self._entries[key] = obj
            return obj

        return deco

    def get(self, key: str) -> T:
        if key not in self._entries:
            raise KeyError(
                f"{key!r} not found in registry {self.name!r}. "
                f"Available: {sorted(self._entries)}"
            )
        return self._entries[key]

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def keys(self):
        return sorted(self._entries)

    def build(self, key: str, *args: Any, **kwargs: Any) -> Any:
        """Instantiate the registered class/factory with the given args."""
        return self.get(key)(*args, **kwargs)


# Canonical registries used across the framework.
MODELS: Registry = Registry("models")
DECODERS: Registry = Registry("decoders")
CRITERIA: Registry = Registry("criteria")
TOKENIZERS: Registry = Registry("tokenizers")
DATASETS: Registry = Registry("datasets")
EMBEDDERS: Registry = Registry("embedders")
TRAINERS: Registry = Registry("trainers")
