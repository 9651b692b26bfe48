"""Detector modules (eval)."""
