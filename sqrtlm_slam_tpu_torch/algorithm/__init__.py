"""Robust closed-form estimators (RANSAC banks)."""
