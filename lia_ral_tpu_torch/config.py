"""Config system: flat key→value files, CLI overrides, per-tool schemas.

A copy of ``lia_ral_tpu/config.py`` (numpy only): the port may not
import the JAX package, whose ``__init__`` imports jax.

Capability parity with the ALIZE ``Config``/``ConfigChecker``/``CmdLine``
trio used by every reference tool (see reference
``LIA_SpkDet/TrainWorld/TrainWorldMain.cpp:61-113`` for the canonical usage
pattern: build schema → parse CLI → load ``--config FILE`` → CLI wins).

File format (reference fixture ``LIA_SpkDet/TrainWorld/test/TrainWorld.cfg``):
one ``key <whitespace> value`` pair per line, ``***`` comment lines.

The key vocabulary is kept identical to the reference so that reference
config files drive this framework unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping, Sequence


class ConfigError(KeyError):
    """Raised for missing/invalid config parameters."""


_TRUE = {"true", "1", "yes", "on"}
_FALSE = {"false", "0", "no", "off"}


def _parse_bool(value: str) -> bool:
    v = value.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise ConfigError(f"not a boolean: {value!r}")


@dataclasses.dataclass
class Param:
    """One schema entry (ALIZE ConfigChecker row)."""

    name: str
    kind: str = "string"  # string | integer | float | boolean
    mandatory: bool = False
    help: str = ""


class ConfigChecker:
    """Schema: collection of Params, validates a Config.

    Mirrors the reference pattern of ``addStringParam``/``addIntegerParam``/
    ``addFloatParam``/``addBooleanParam`` (``TrainWorldMain.cpp:61-87``).
    """

    def __init__(self) -> None:
        self.params: dict[str, Param] = {}

    def add_string(self, name: str, mandatory: bool = False, help: str = "") -> "ConfigChecker":
        self.params[name] = Param(name, "string", mandatory, help)
        return self

    def add_integer(self, name: str, mandatory: bool = False, help: str = "") -> "ConfigChecker":
        self.params[name] = Param(name, "integer", mandatory, help)
        return self

    def add_float(self, name: str, mandatory: bool = False, help: str = "") -> "ConfigChecker":
        self.params[name] = Param(name, "float", mandatory, help)
        return self

    def add_boolean(self, name: str, mandatory: bool = False, help: str = "") -> "ConfigChecker":
        self.params[name] = Param(name, "boolean", mandatory, help)
        return self

    def check(self, config: "Config") -> None:
        for p in self.params.values():
            if p.mandatory and p.name not in config:
                raise ConfigError(f"mandatory parameter missing: {p.name}")
            if p.name in config:
                raw = config.get_str(p.name)
                try:
                    if p.kind == "integer":
                        int(raw)
                    elif p.kind == "float":
                        float(raw)
                    elif p.kind == "boolean":
                        _parse_bool(raw)
                except (ValueError, ConfigError) as e:
                    raise ConfigError(
                        f"parameter {p.name}={raw!r} is not a {p.kind}"
                    ) from e

    def help_text(self) -> str:
        lines = []
        for p in sorted(self.params.values(), key=lambda q: q.name):
            req = "required" if p.mandatory else "optional"
            lines.append(f"  --{p.name} <{p.kind}> ({req}) {p.help}")
        return "\n".join(lines)


class Config:
    """Flat string-keyed config with typed accessors.

    Reads the reference file format verbatim; lookup precedence is
    insertion order with later ``update``s winning (so CLI overrides a
    loaded file, as in ``CmdLine::copyIntoConfig``).
    """

    def __init__(self, mapping: Mapping[str, Any] | None = None) -> None:
        self._kv: dict[str, str] = {}
        if mapping:
            for k, v in mapping.items():
                self[k] = v

    # -- mapping protocol ---------------------------------------------------
    def __contains__(self, key: str) -> bool:
        return key in self._kv

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, bool):
            value = "true" if value else "false"
        self._kv[key] = str(value)

    def __getitem__(self, key: str) -> str:
        return self.get_str(key)

    def keys(self) -> Iterable[str]:
        return self._kv.keys()

    def items(self) -> Iterable[tuple[str, str]]:
        return self._kv.items()

    def update(self, other: Mapping[str, Any] | "Config") -> "Config":
        items = other.items() if not isinstance(other, Config) else other._kv.items()
        for k, v in items:
            self[k] = v
        return self

    def copy(self) -> "Config":
        c = Config()
        c._kv = dict(self._kv)
        return c

    # -- typed accessors (ALIZE getParam_* equivalents) ---------------------
    def exists(self, key: str) -> bool:
        return key in self._kv

    def get_str(self, key: str, default: str | None = None) -> str:
        if key not in self._kv:
            if default is not None:
                return default
            raise ConfigError(f"missing config parameter: {key}")
        return self._kv[key]

    def get_int(self, key: str, default: int | None = None) -> int:
        if key not in self._kv:
            if default is not None:
                return default
            raise ConfigError(f"missing config parameter: {key}")
        return int(self._kv[key])

    def get_float(self, key: str, default: float | None = None) -> float:
        if key not in self._kv:
            if default is not None:
                return default
            raise ConfigError(f"missing config parameter: {key}")
        return float(self._kv[key])

    def get_bool(self, key: str, default: bool | None = None) -> bool:
        if key not in self._kv:
            if default is not None:
                return default
            raise ConfigError(f"missing config parameter: {key}")
        return _parse_bool(self._kv[key])

    # -- file / CLI ---------------------------------------------------------
    @classmethod
    def load(cls, path: str) -> "Config":
        c = cls()
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("***") or line.startswith("#"):
                    continue
                parts = line.split(None, 1)
                if len(parts) == 1:
                    c[parts[0]] = ""
                else:
                    c[parts[0]] = parts[1].strip()
        return c

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write("*** saved by lia_ral_tpu\n")
            for k, v in sorted(self._kv.items()):
                f.write(f"{k}\t{v}\n")

    @classmethod
    def from_cli(
        cls,
        argv: Sequence[str],
        checker: ConfigChecker | None = None,
    ) -> "Config":
        """Parse ``--key value`` args; ``--config FILE`` loads FILE first,
        then remaining CLI args override it (reference precedence,
        ``TrainWorldMain.cpp:99-103``)."""
        cli = cls()
        i = 0
        argv = list(argv)
        while i < len(argv):
            a = argv[i]
            if not a.startswith("--"):
                raise ConfigError(f"unexpected CLI token: {a!r}")
            key = a[2:]
            if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                cli[key] = argv[i + 1]
                i += 2
            else:  # valueless flag → boolean true
                cli[key] = "true"
                i += 1
        merged = cls()
        if "config" in cli:
            merged.update(cls.load(cli.get_str("config")))
        merged.update(cli)
        if checker is not None:
            checker.check(merged)
        return merged


# Common schema fragments shared by many tools -------------------------------

def add_feature_io_params(ck: ConfigChecker) -> ConfigChecker:
    ck.add_string("loadFeatureFileFormat", help="SPRO3|SPRO4|RAW|HTK")
    ck.add_string("loadFeatureFileExtension")
    ck.add_string("saveFeatureFileFormat")
    ck.add_string("saveFeatureFileExtension")
    ck.add_string("featureFilesPath")
    ck.add_string("featureServerMask", help="e.g. 0-15,17-32")
    ck.add_integer("loadFeatureFileVectSize")
    ck.add_boolean("bigEndian")
    ck.add_string("featureServerBufferSize")
    ck.add_float("frameLength", help="seconds per frame (default 0.01)")
    return ck


def add_label_params(ck: ConfigChecker) -> ConfigChecker:
    ck.add_string("labelFilesPath")
    ck.add_string("labelSelectedFrames")
    ck.add_boolean("addDefaultLabel")
    ck.add_string("defaultLabel")
    ck.add_string("saveLabelFileExtension")
    ck.add_string("loadLabelFileExtension")
    return ck


def add_mixture_io_params(ck: ConfigChecker) -> ConfigChecker:
    ck.add_string("loadMixtureFileFormat", help="RAW|XML")
    ck.add_string("saveMixtureFileFormat")
    ck.add_string("loadMixtureFileExtension")
    ck.add_string("saveMixtureFileExtension")
    ck.add_string("mixtureFilesPath")
    ck.add_string("distribType", help="GD (diagonal) only")
    ck.add_integer("mixtureDistribCount")
    ck.add_float("maxLLK")
    ck.add_float("minLLK")
    return ck
