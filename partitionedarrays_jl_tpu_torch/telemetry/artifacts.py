"""The one schema-versioned writer of measurement artifacts
(telemetry/artifacts.py of the JAX package).

`stamp` adds the provenance envelope (``schema_version``, the generating
tool, the device platform and the telemetry config) without overwriting
anything the tool already recorded; `write` serializes with one canonical
format (indent=1, sorted keys) and honours a ``dry_run``.
"""
from __future__ import annotations

import json
from typing import Optional

from .config import config_snapshot

__all__ = ["ARTIFACT_SCHEMA_VERSION", "stamp", "write"]

ARTIFACT_SCHEMA_VERSION = 1


def _platform() -> str:
    """``"gpu"`` where a CUDA device is visible, else ``"cpu"``."""
    try:
        import torch

        return "gpu" if torch.cuda.is_available() else "cpu"
    except Exception:
        return "unknown"


def stamp(rec: dict, tool: Optional[str] = None) -> dict:
    """Add the provenance envelope to a record, in place and returned
    (``setdefault`` throughout: a tool's own ``platform`` is kept)."""
    rec.setdefault("schema_version", ARTIFACT_SCHEMA_VERSION)
    if tool:
        rec.setdefault("generated_by", tool)
    if "platform" not in rec:
        rec["platform"] = _platform()
    rec.setdefault("telemetry_config", config_snapshot())
    return rec


def write(path: str, rec: dict, tool: Optional[str] = None,
          dry_run: bool = False, echo: bool = True) -> dict:
    """Stamp and serialize one artifact. ``dry_run`` prints the record
    without touching ``path``."""
    rec = stamp(rec, tool=tool)
    out = json.dumps(rec, indent=1, sort_keys=True)
    if dry_run:
        if echo:
            print(out)
        return rec
    with open(path, "w", encoding="utf-8") as f:
        f.write(out + "\n")
    if echo:
        print(f"wrote {path} (schema_version={rec['schema_version']})")
    return rec
