"""Typed CSV reader and segmentation-map loader, PyTorch-port counterpart of
``depth_completion_tpu.io.csvio``."""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Any


def load_csv(path: Path, columns: dict[str, type]) -> list[dict[str, Any]]:
    """Read selected, type-converted columns; raises on missing columns."""
    with open(path, "r", newline="") as f:
        data = list(csv.reader(f))
    header = data[0]
    rows = [r for r in data[1:] if r and any(cell.strip() for cell in r)]
    missing = [c for c in columns if c not in header]
    if missing:
        raise ValueError(f"Missing required columns in CSV file: {', '.join(missing)}")
    idx = {c: header.index(c) for c in columns}
    out: list[dict[str, Any]] = []
    for row in rows:
        item: dict[str, Any] = {}
        for col, i in idx.items():
            if i < len(row):
                item[col] = columns[col](row[i])
        out.append(item)
    return out


def load_segmap(csv_path: Path) -> dict[str, Any]:
    """``id,name,r,g,b`` rows → {"name": [...], "color": [(r,g,b), ...]}."""
    rows = load_csv(
        csv_path, columns={"id": int, "name": str, "r": int, "g": int, "b": int}
    )
    ret: dict[str, Any] = {
        "name": [""] * len(rows),
        "color": [tuple() for _ in rows],
    }
    for row in rows:
        ret["name"][row["id"]] = row["name"]
        ret["color"][row["id"]] = (row["r"], row["g"], row["b"])
    return ret
