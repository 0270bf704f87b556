"""The `lumina` command line of the port (`entry_point.py`)."""
