"""Calibration."""
