"""Rule configuration types (the schema only: the port has no YAML
loader yet)."""

from .schema import Action, ConfigError, ListConfig, ListType, RuleConfig

__all__ = ["Action", "ConfigError", "ListConfig", "ListType", "RuleConfig"]
