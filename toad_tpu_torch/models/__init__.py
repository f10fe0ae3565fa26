"""The MIL model and weight interop."""
