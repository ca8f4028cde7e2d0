"""Data augmentation of the port (the data pipeline waits for slice 2b)."""
