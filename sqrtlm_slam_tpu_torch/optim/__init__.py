"""Robust losses, LM, pose-only optimisation, BA assembly (K2), local BA."""
