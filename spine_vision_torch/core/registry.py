"""Model, trainer and metrics registries with registration decorators.

Counterpart of ``spine_vision_tpu/core/registry.py``: string-keyed class
registries with ``create``/``get``/``names``, a trainer registry carrying
each trainer's config class, and ``create_trainer_from_config`` dispatching
on ``config.task``. The port's classes register under the JAX package's
names when their modules are imported: the models ``classifier``,
``coordinate_regressor`` (``models/classifier.py``), ``text_detection`` and
``text_recognition``; the trainers ``localization`` and ``classification``
with their configs; the metrics ``localization``, ``classification`` and
``classifier`` (``metrics/__init__.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Generic, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    """A string-keyed class registry."""

    def __init__(self, kind: str) -> None:
        self.kind = kind
        self._entries: dict[str, type[T]] = {}
        self._extras: dict[str, dict[str, Any]] = {}

    def register(self, name: str, **extra: Any) -> Callable[[type[T]], type[T]]:
        """Class decorator: ``@REGISTRY.register("name")``."""

        def decorator(entry_cls: type[T]) -> type[T]:
            self._entries[name] = entry_cls
            if extra:
                self._extras[name] = extra
            return entry_cls

        return decorator

    def get(self, name: str) -> type[T]:
        if name not in self._entries:
            available = ", ".join(sorted(self._entries)) or "<none>"
            raise KeyError(f"{self.kind} '{name}' not found. Available: {available}")
        return self._entries[name]

    def create(self, name: str, **kwargs: Any) -> T:
        return self.get(name)(**kwargs)

    def extra(self, name: str, key: str) -> Any:
        return self._extras.get(name, {}).get(key)

    def names(self) -> list[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries


MODEL_REGISTRY: Registry[Any] = Registry("model")
TRAINER_REGISTRY: Registry[Any] = Registry("trainer")
METRICS_REGISTRY: Registry[Any] = Registry("metrics")


def register_model(name: str) -> Callable[[type[T]], type[T]]:
    return MODEL_REGISTRY.register(name)


def register_trainer(name: str, *, config_cls: type | None = None) -> Callable[[type[T]], type[T]]:
    return TRAINER_REGISTRY.register(name, config_cls=config_cls)


def register_metrics(name: str) -> Callable[[type[T]], type[T]]:
    return METRICS_REGISTRY.register(name)


def get_trainer_config_class(name: str) -> type | None:
    """The config class registered with a trainer (may be None)."""
    return TRAINER_REGISTRY.extra(name, "config_cls")


def create_trainer_from_config(config: Any, **kwargs: Any) -> Any:
    """Instantiate the trainer registered under ``config.task``."""
    return TRAINER_REGISTRY.get(config.task)(config, **kwargs)
