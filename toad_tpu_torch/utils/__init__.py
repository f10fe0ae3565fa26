"""Small helpers: seeding, results persistence, scalar logging."""

from toad_tpu_torch.utils.io import load_pkl, save_pkl, write_settings
from toad_tpu_torch.utils.rng import seed_everything


def invert_labels(label_dict: dict) -> dict:
    """index -> display name; the first name of an index wins (task label
    dicts list the canonical spelling before its aliases)."""
    inv: dict = {}
    for name, idx in label_dict.items():
        inv.setdefault(idx, name)
    return inv


__all__ = ["save_pkl", "load_pkl", "write_settings", "seed_everything", "invert_labels"]
