"""The trainer's built-in callbacks (callbacks.py)."""
