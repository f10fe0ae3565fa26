"""Prediction records."""
