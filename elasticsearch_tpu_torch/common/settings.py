"""Typed, scoped settings registry.

Re-design of the reference settings system
(``server/.../common/settings/Setting.java``, ``Settings.java``,
``AbstractScopedSettings.java``): typed ``Setting`` objects with a scope
(node / index / cluster), a default, an optional validator, and a ``dynamic``
flag for runtime updates. Values live in plain dicts (flattened dotted keys),
like the reference's ``Settings`` map.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Generic, Optional, TypeVar

from .errors import IllegalArgumentError

T = TypeVar("T")

NODE_SCOPE = "node"
INDEX_SCOPE = "index"
CLUSTER_SCOPE = "cluster"

_TIME_RE = re.compile(r"^(-?\d+(?:\.\d+)?)(d|h|m|s|ms|micros|nanos)$")
_BYTES_RE = re.compile(r"^(-?\d+(?:\.\d+)?)(pb|tb|gb|mb|kb|b)?$", re.IGNORECASE)

_TIME_MILLIS = {"d": 86400_000, "h": 3600_000, "m": 60_000, "s": 1000,
                "ms": 1, "micros": 1e-3, "nanos": 1e-6}
_BYTE_UNITS = {"pb": 1 << 50, "tb": 1 << 40, "gb": 1 << 30, "mb": 1 << 20,
               "kb": 1 << 10, "b": 1, None: 1}


def parse_time_millis(value: Any) -> float:
    """Parse ``30s`` / ``5m`` / ``100ms`` style time values into milliseconds."""
    if isinstance(value, (int, float)):
        return float(value)
    m = _TIME_RE.match(str(value).strip())
    if not m:
        raise IllegalArgumentError(f"failed to parse time value [{value}]")
    return float(m.group(1)) * _TIME_MILLIS[m.group(2)]


def parse_bytes(value: Any) -> int:
    """Parse ``512mb`` style byte sizes."""
    if isinstance(value, (int, float)):
        return int(value)
    m = _BYTES_RE.match(str(value).strip())
    if not m:
        raise IllegalArgumentError(f"failed to parse byte size [{value}]")
    return int(float(m.group(1)) * _BYTE_UNITS[(m.group(2) or "b").lower()])


class Setting(Generic[T]):
    def __init__(self, key: str, default: T, parser: Callable[[Any], T],
                 scope: str = NODE_SCOPE, dynamic: bool = False,
                 validator: Optional[Callable[[T], None]] = None):
        self.key = key
        self.default = default
        self.parser = parser
        self.scope = scope
        self.dynamic = dynamic
        self.validator = validator

    def get(self, settings: "Settings") -> T:
        raw = settings.get(self.key)
        if raw is None:
            return self.default
        value = self.parser(raw)
        if self.validator:
            self.validator(value)
        return value

    @staticmethod
    def int_setting(key, default, scope=NODE_SCOPE, dynamic=False,
                    min_value=None, max_value=None) -> "Setting[int]":
        def validate(v):
            if min_value is not None and v < min_value:
                raise IllegalArgumentError(
                    f"failed to parse value [{v}] for setting [{key}] must be >= {min_value}")
            if max_value is not None and v > max_value:
                raise IllegalArgumentError(
                    f"failed to parse value [{v}] for setting [{key}] must be <= {max_value}")
        return Setting(key, default, int, scope, dynamic, validate)

    @staticmethod
    def bool_setting(key, default, scope=NODE_SCOPE, dynamic=False) -> "Setting[bool]":
        def parse(v):
            if isinstance(v, bool):
                return v
            s = str(v).lower()
            if s in ("true", "1"):
                return True
            if s in ("false", "0"):
                return False
            raise IllegalArgumentError(f"failed to parse boolean [{v}] for setting [{key}]")
        return Setting(key, default, parse, scope, dynamic)

    @staticmethod
    def str_setting(key, default, scope=NODE_SCOPE, dynamic=False) -> "Setting[str]":
        return Setting(key, default, str, scope, dynamic)

    @staticmethod
    def float_setting(key, default, scope=NODE_SCOPE, dynamic=False) -> "Setting[float]":
        return Setting(key, default, float, scope, dynamic)

    @staticmethod
    def time_setting(key, default_millis, scope=NODE_SCOPE, dynamic=False) -> "Setting[float]":
        return Setting(key, default_millis, parse_time_millis, scope, dynamic)


def _flatten(prefix: str, obj: Any, out: Dict[str, Any]) -> None:
    if isinstance(obj, dict) and obj:
        for k, v in obj.items():
            _flatten(f"{prefix}{k}.", v, out)
    else:
        out[prefix.rstrip(".")] = obj


class Settings:
    """Immutable flattened key→value map (dotted keys), like the reference's
    ``Settings``. Accepts nested dicts on construction."""

    EMPTY: "Settings"

    def __init__(self, values: Optional[Dict[str, Any]] = None):
        flat: Dict[str, Any] = {}
        _flatten("", values or {}, flat)
        flat.pop("", None)
        self._values = flat

    def get(self, key: str, default: Any = None) -> Any:
        return self._values.get(key, default)

    def keys(self):
        return self._values.keys()

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._values)

    def with_updates(self, updates: Dict[str, Any]) -> "Settings":
        merged = dict(self._values)
        s = Settings(updates)
        for k, v in s._values.items():
            if v is None:
                merged.pop(k, None)
            else:
                merged[k] = v
        out = Settings()
        out._values = merged
        return out

    def filtered(self, prefix: str) -> "Settings":
        out = Settings()
        out._values = {k: v for k, v in self._values.items() if k.startswith(prefix)}
        return out

    def __eq__(self, other):
        return isinstance(other, Settings) and self._values == other._values

    def __repr__(self):
        return f"Settings({self._values})"


Settings.EMPTY = Settings()


class ScopedSettingsRegistry:
    """Registry of known settings per scope with dynamic-update validation
    (reference: ``AbstractScopedSettings.java``)."""

    def __init__(self, scope: str):
        self.scope = scope
        self._settings: Dict[str, Setting] = {}

    def register(self, setting: Setting) -> Setting:
        self._settings[setting.key] = setting
        return setting

    def lookup(self, key: str) -> Optional[Setting]:
        return self._settings.get(key)

    def validate_update(self, updates: Dict[str, Any], allow_static: bool = False) -> None:
        flat = Settings(updates)
        for key in flat.keys():
            if flat.get(key) is None:
                continue
            setting = self._settings.get(key)
            if setting is None:
                # Unknown keys are allowed for archived/custom settings in the
                # reference only in specific paths; be strict by default.
                raise IllegalArgumentError(f"unknown setting [{key}]")
            if not setting.dynamic and not allow_static:
                raise IllegalArgumentError(
                    f"final {self.scope} setting [{key}], not updateable")
            setting.parser(flat.get(key))


# Core index-scoped settings (reference: ``IndexMetadata.java`` /
# ``IndexScopedSettings.java``).
INDEX_SETTINGS = ScopedSettingsRegistry(INDEX_SCOPE)
SETTING_NUMBER_OF_SHARDS = INDEX_SETTINGS.register(
    Setting.int_setting("index.number_of_shards", 1, INDEX_SCOPE, min_value=1, max_value=1024))
SETTING_NUMBER_OF_REPLICAS = INDEX_SETTINGS.register(
    Setting.int_setting("index.number_of_replicas", 1, INDEX_SCOPE, dynamic=True, min_value=0))
SETTING_REFRESH_INTERVAL = INDEX_SETTINGS.register(
    Setting.time_setting("index.refresh_interval", 1000.0, INDEX_SCOPE, dynamic=True))
SETTING_MAX_RESULT_WINDOW = INDEX_SETTINGS.register(
    Setting.int_setting("index.max_result_window", 10000, INDEX_SCOPE, dynamic=True, min_value=1))

CLUSTER_SETTINGS = ScopedSettingsRegistry(CLUSTER_SCOPE)
