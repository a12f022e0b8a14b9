"""Synthetic data of the port (twin of ``repro.data``)."""
