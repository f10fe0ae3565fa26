"""Results persistence: pickled dicts and settings snapshots.

Parity with the reference's ``utils/file_utils.py:4-13`` (save_pkl/load_pkl)
and the settings echo it writes to ``experiment_{exp_code}.txt``
(``main_mtl_concat.py:178-180``).
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Any


def save_pkl(filename: str | os.PathLike, obj: Any) -> None:
    Path(filename).parent.mkdir(parents=True, exist_ok=True)
    with open(filename, "wb") as f:
        pickle.dump(obj, f)


def load_pkl(filename: str | os.PathLike) -> Any:
    with open(filename, "rb") as f:
        return pickle.load(f)


def write_settings(path: str | os.PathLike, settings: dict[str, Any]) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        print(settings, file=f)
