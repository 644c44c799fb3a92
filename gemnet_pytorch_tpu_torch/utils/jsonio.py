"""JSON file helpers (copy of `gemnet_pytorch_tpu/utils/jsonio.py`;
counterpart of the reference's gemnet/model/utils.py)."""

from __future__ import annotations

import json
import os


def read_json(path: str) -> dict:
    if not path.endswith(".json"):
        raise ValueError(f"{path} is not a json path")
    with open(path) as f:
        return json.load(f)


def write_json(path: str, data: dict) -> None:
    if not path.endswith(".json"):
        raise ValueError(f"{path} is not a json path")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False, indent=4)


def update_json(path: str, data: dict) -> None:
    content = read_json(path) if os.path.exists(path) else {}
    content.update(data)
    write_json(path, content)


def read_value_json(path: str, key: str):
    content = read_json(path)
    return content.get(key)
