"""Compute path: moment system and preprocessing (L1-L3)."""
