"""Data path of the port, pandas-free: ingest (raw logs to an `EventLog`
of numpy columns), prepare and fastprep (examples), pipeline (packed
arrays, batches, prefetch) and the device-resident dataset."""
