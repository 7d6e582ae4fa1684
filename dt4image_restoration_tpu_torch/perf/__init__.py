"""Measurements of the port on the card that ``chip_smoke.py`` also runs."""
