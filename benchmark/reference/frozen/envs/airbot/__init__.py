"""Airbot Play manipulation tasks (cube-push in this slice)."""
