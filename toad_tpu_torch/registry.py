"""Task registry: tasks are JSON files, found by name or by path.

Counterpart of :mod:`toad_tpu.registry`. Names resolve against
``$TOAD_TPU_TASK_DIR``, then ``./tasks``, then the tasks shipped with this
package (``toad_tpu_torch/tasks/``, copies of ``toad_tpu/tasks/``).
"""

from __future__ import annotations

import os
from pathlib import Path

from toad_tpu_torch.config import TaskConfig

_BUILTIN_DIR = Path(__file__).parent / "tasks"


def task_search_dirs() -> list[Path]:
    dirs = [Path.cwd() / "tasks", _BUILTIN_DIR]
    extra = os.environ.get("TOAD_TPU_TASK_DIR")
    if extra:
        dirs.insert(0, Path(extra))
    return dirs


def list_tasks() -> list[str]:
    names: list[str] = []
    for d in task_search_dirs():
        if d.is_dir():
            names.extend(p.stem for p in sorted(d.glob("*.json")))
    seen: set[str] = set()
    return [n for n in names if not (n in seen or seen.add(n))]


def load_task(name_or_path: str) -> TaskConfig:
    """Load a task by registry name or by explicit path to a JSON file."""
    p = Path(name_or_path)
    if p.suffix == ".json" and p.exists():
        return TaskConfig.from_json(p.read_text())
    stem = name_or_path.removesuffix(".json")
    for d in task_search_dirs():
        candidate = d / f"{stem}.json"
        if candidate.exists():
            return TaskConfig.from_json(candidate.read_text())
    raise KeyError(
        f"unknown task {name_or_path!r}; available: {list_tasks()} "
        f"(searched {[str(d) for d in task_search_dirs()]})"
    )
