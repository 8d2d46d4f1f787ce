"""The benchmark's files found by name: JSON data, and modules loaded from
their own file (entries, laws, metric readers), so that any name works and
a copy of the tree finds its own files."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"cardbench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
