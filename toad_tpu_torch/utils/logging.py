"""Optional TensorBoard scalar logging with the reference's tag schema
(``train/*``, ``val/*``, ``final/*``). A no-op when no TensorBoard writer
imports.
"""

from __future__ import annotations

from typing import Any


class NullWriter:
    def add_scalar(self, *a: Any, **k: Any) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def make_writer(log_dir: str | None, enabled: bool = True):
    if not enabled or log_dir is None:
        return NullWriter()
    try:
        from tensorboardX import SummaryWriter

        return SummaryWriter(log_dir, flush_secs=15)
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter

            return SummaryWriter(log_dir, flush_secs=15)
        except ImportError:
            return NullWriter()
