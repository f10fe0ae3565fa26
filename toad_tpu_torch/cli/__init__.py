"""Command-line entry points (python -m toad_tpu_torch <command>)."""
