"""Offline dataset preparation (counterparts of ``dataset/`` at the repo
root)."""
