"""Tooling around the core CLI (the reference's trim_all.py batch
script)."""
