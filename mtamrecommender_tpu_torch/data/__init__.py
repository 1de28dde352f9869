"""Data path of the port: the device-resident dataset and its batch
gather so far; the host pipeline is not ported yet (ROADMAP.md)."""
