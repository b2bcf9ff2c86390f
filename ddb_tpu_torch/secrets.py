"""Secret manager: typed named credentials with scope matching.

TPU-native analog of the reference's SecretManager
(src/main/secret/secret_manager.hpp:88, secret_manager.cpp): secrets are
(type, provider, name, scope-prefixes, key/value payload) entries used by
remote filesystems and extensions.  Persistent secrets serialize to a
JSON file under `secret_directory`; redacted listing via
duckdb_secrets().
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# payload keys whose values are never shown in listings (reference:
# redact_keys per secret type, e.g. s3 secret/session_token)
_REDACTED = {"secret", "session_token", "password", "token", "key"}


@dataclass
class Secret:
    name: str
    type: str
    provider: str = "config"
    scope: List[str] = field(default_factory=list)
    values: Dict[str, str] = field(default_factory=dict)
    persistent: bool = False

    def redacted(self) -> str:
        parts = []
        for k, v in sorted(self.values.items()):
            shown = "redacted" if k.lower() in _REDACTED else str(v)
            parts.append(f"{k}={shown}")
        return ";".join(parts)


# default scope prefixes per secret type (reference:
# secret types register default scopes, e.g. s3:// for S3 secrets)
_DEFAULT_SCOPES = {
    "s3": ["s3://", "s3n://", "s3a://"],
    "r2": ["r2://"],
    "gcs": ["gcs://", "gs://"],
    "azure": ["azure://", "az://"],
    "http": ["http://", "https://"],
    "huggingface": ["hf://"],
}


class SecretManager:
    def __init__(self, directory: Optional[str] = None):
        self._secrets: Dict[str, Secret] = {}
        self.directory = directory
        if directory:
            self._load()

    # ---- CRUD ------------------------------------------------------------
    def create(self, name: Optional[str], pairs: Dict[str, str],
               persistent: bool = False, or_replace: bool = False,
               if_not_exists: bool = False) -> Secret:
        pairs = {k.lower(): v for k, v in pairs.items()}
        stype = str(pairs.pop("type", "generic")).lower()
        provider = str(pairs.pop("provider", "config")).lower()
        scope = pairs.pop("scope", None)
        scopes = [s.strip() for s in str(scope).split(",")] \
            if scope is not None else list(_DEFAULT_SCOPES.get(stype, []))
        if name is None:
            name = f"__default_{stype}"
        key = name.lower()
        if key in self._secrets:
            if if_not_exists:
                return self._secrets[key]
            if not or_replace:
                raise ValueError(
                    f"secret '{name}' already exists "
                    "(use CREATE OR REPLACE or IF NOT EXISTS)")
        s = Secret(name, stype, provider, scopes, pairs, persistent)
        self._secrets[key] = s
        if persistent:
            self._save()
        return s

    def drop(self, name: str, if_exists: bool = False) -> None:
        key = name.lower()
        if key not in self._secrets:
            if if_exists:
                return
            raise ValueError(f"unknown secret '{name}'")
        was_persistent = self._secrets[key].persistent
        del self._secrets[key]
        if was_persistent:
            self._save()

    def get(self, name: str) -> Optional[Secret]:
        return self._secrets.get(name.lower())

    def list(self) -> List[Secret]:
        return sorted(self._secrets.values(), key=lambda s: s.name)

    # ---- scope resolution ------------------------------------------------
    def find_for_path(self, path: str,
                      type_: Optional[str] = None) -> Optional[Secret]:
        """Longest-matching-scope secret for a path (reference:
        SecretManager::LookupSecret scoring)."""
        best, best_len = None, -1
        for s in self._secrets.values():
            if type_ is not None and s.type != type_.lower():
                continue
            for sc in s.scope:
                if path.startswith(sc) and len(sc) > best_len:
                    best, best_len = s, len(sc)
        return best

    # ---- persistence -----------------------------------------------------
    def _save(self):
        if not self.directory:
            return
        os.makedirs(self.directory, exist_ok=True)
        data = [s.__dict__ for s in self._secrets.values() if s.persistent]
        with open(os.path.join(self.directory, "secrets.json"), "w") as f:
            json.dump(data, f)

    def _load(self):
        p = os.path.join(self.directory, "secrets.json")
        if not os.path.exists(p):
            return
        try:
            with open(p) as f:
                for d in json.load(f):
                    s = Secret(**d)
                    self._secrets[s.name.lower()] = s
        except (json.JSONDecodeError, TypeError, OSError):
            pass
