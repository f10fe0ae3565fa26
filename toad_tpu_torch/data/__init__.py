"""Feature bags and padding."""
