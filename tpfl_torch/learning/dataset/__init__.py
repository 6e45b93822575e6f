"""Seeded synthetic datasets (numpy only)."""
