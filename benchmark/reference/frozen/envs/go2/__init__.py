"""Unitree Go2 environments (flat-terrain joystick in this slice)."""
