"""Typed config-model base: dataclasses with deprecated-key aliases
(``ALIASES = {old_key: new_key}``, warns on use) and strict unknown-key
detection, the same surface as the JAX package's ``DeepSpeedConfigModel``."""

import dataclasses
from typing import Any, Dict

from ..utils.logging import logger


class ConfigError(ValueError):
    pass


@dataclasses.dataclass
class DeepSpeedConfigModel:
    """Base for all per-subsystem config models.

    ``from_dict`` maps JSON keys to fields, honouring the class's
    ``ALIASES`` and rejecting unknown keys unless the class sets
    ``_ALLOW_EXTRA = True``; then it runs ``validate``.
    """

    _ALIASES: Dict[str, str] = dataclasses.field(default_factory=dict,
                                                  repr=False)
    _ALLOW_EXTRA = False

    @classmethod
    def from_dict(cls, data: Dict[str, Any] = None, **overrides):
        data = dict(data or {})
        data.update(overrides)
        aliases = getattr(cls, "ALIASES", {})
        field_names = {f.name for f in dataclasses.fields(cls)
                       if f.name != "_ALIASES"}
        kwargs = {}
        extra = {}
        for key, value in data.items():
            if key in aliases:
                new_key = aliases[key]
                logger.warning(f"Config parameter {key} is deprecated, use "
                               f"{new_key} instead")
                key = new_key
            if key in field_names:
                kwargs[key] = value
            else:
                extra[key] = value
        if extra and not getattr(cls, "_ALLOW_EXTRA", False):
            raise ConfigError(
                f"{cls.__name__}: unknown config key(s): {sorted(extra)}")
        obj = cls(**kwargs)
        if extra:
            obj.__dict__["extra_fields"] = extra
        obj.validate()
        return obj

    def validate(self):
        """Override for cross-field validation; raise ConfigError on
        failure."""

    def to_dict(self):
        out = {}
        for f in dataclasses.fields(self):
            if f.name == "_ALIASES":
                continue
            v = getattr(self, f.name)
            if isinstance(v, DeepSpeedConfigModel):
                v = v.to_dict()
            out[f.name] = v
        return out
