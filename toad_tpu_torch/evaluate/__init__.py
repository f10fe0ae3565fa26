"""Evaluation: metrics, the shared eval pass, calibration."""
